"""``paddle.metric``: the port of ``paddle_tpu/metric/__init__.py``
(``Metric``, ``Accuracy`` over the top k, ``Precision``, ``Recall``,
``Auc`` and ``accuracy``).

``Accuracy.compute`` and ``accuracy`` run where the predictions are (on
the card for a model there): the top-k indices against the labels.
``update`` and ``accumulate`` keep their counts on the host, as the
reference's do, so ``update`` reads its argument back once a call.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    return x.numpy() if isinstance(x, Tensor) else np.asarray(x)


def _torch(x):
    return x._data if isinstance(x, Tensor) else torch.as_tensor(x)


def _correct(pred, label, k):
    """[..., k] float32: whether each of the k largest predictions is the
    label."""
    pred, label = _torch(pred), _torch(label)
    if label.dim() > 1 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    top = pred.topk(k, dim=-1).indices
    return (top == label.to(top.device, top.dtype)[..., None]).float()


class Metric:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        return Tensor._wrap(_correct(pred, label, self.maxk))

    def update(self, correct, *args):
        c = _np(correct)
        num = c.shape[0] if c.ndim > 0 else 1
        for i, k in enumerate(self.topk):
            self.total[i] += float(c[..., :k].sum())
            self.count[i] += num
        return self.accumulate()

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(Metric):
    """ROC AUC over ``num_thresholds`` buckets of the positive class's
    probability (the second column of a [N, 2] prediction)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, 1]
        lab = _np(labels).reshape(-1)
        idx = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        n = self.num_thresholds + 1
        self._stat_pos += np.bincount(idx[lab != 0], minlength=n)
        self._stat_neg += np.bincount(idx[lab == 0], minlength=n)

    def accumulate(self):
        tot_pos, tot_neg = self._stat_pos.sum(), self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoids from the highest threshold down
        pos = np.concatenate([[0.0], np.cumsum(self._stat_pos[::-1])])
        neg = np.concatenate([[0.0], np.cumsum(self._stat_neg[::-1])])
        auc = float(np.sum((neg[1:] - neg[:-1]) * (pos[:-1] + pos[1:]) / 2))
        return float(auc / (tot_pos * tot_neg))


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    """The share of rows whose label is among the k largest predictions,
    as a float32 Paddle tensor where ``input`` is."""
    hit = _correct(input, label, k).amax(-1)
    return Tensor._wrap(hit.mean())
