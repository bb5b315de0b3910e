"""Loss functionals: the port of ``paddle_tpu/nn/functional/loss.py``
(``cross_entropy`` with the reference's hard-label semantics)."""
from __future__ import annotations

import torch
from torch.overrides import handle_torch_function, has_torch_function

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy over hard labels along the last axis
    (``nn/functional/loss.py:20-62``): ``-log_softmax(input)[label]``, 0
    where ``label == ignore_index``; ``reduction`` "mean" divides the sum by
    the number of labels that are not ignored (at least 1), "sum" sums and
    "none" keeps one loss a label. The softmax runs in the input's type
    (float32 under AMP, where ``cross_entropy`` is black-listed). It takes
    Paddle tensors through ``Tensor.__torch_function__``. Class weights,
    soft labels, label smoothing, another axis and ``use_softmax=False`` are
    not ported (ROADMAP queue 1 item 5d, part 2)."""
    if has_torch_function((input, label)):
        return handle_torch_function(
            cross_entropy, (input, label), input, label, weight=weight,
            ignore_index=ignore_index, reduction=reduction,
            soft_label=soft_label, axis=axis, use_softmax=use_softmax,
            label_smoothing=label_smoothing)
    if weight is not None or soft_label or label_smoothing or \
            not use_softmax or axis not in (-1, input.dim() - 1):
        raise NotImplementedError(
            "cross_entropy takes hard labels along the last axis only: "
            "weight, soft_label, label_smoothing, use_softmax=False and "
            "other axes wait for ROADMAP queue 1 item 5d, part 2")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    lp = torch.log_softmax(input, dim=-1)
    lab = label.long()
    if lab.dim() == lp.dim():
        lab = lab.squeeze(-1)
    mask = lab != ignore_index
    picked = lp.gather(-1, torch.where(mask, lab, 0).unsqueeze(-1))
    loss = torch.where(mask, -picked.squeeze(-1), 0.0)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / mask.sum().clamp(min=1).to(loss.dtype)
