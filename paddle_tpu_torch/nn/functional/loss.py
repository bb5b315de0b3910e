"""Loss functionals: the port of ``paddle_tpu/nn/functional/loss.py``.

Each computes what the reference's function computes, with its reductions
("mean" over every element unless the function says otherwise, "sum",
"none"), behind :func:`core.dispatch.apply_op` under the reference's op
name, so the port's AMP casts it as the reference's list says
(``cross_entropy`` is black-listed: float32 in and out). ``cross_entropy``
dispatches through ``Tensor.__torch_function__`` (the port's AMP also names
it there).

``ctc_loss`` runs torch's ``F.ctc_loss`` over ``log_softmax`` of its input
(the reference takes logits and normalises them), then the reference's
reduction: "mean" is the mean over the batch of each loss divided by its
label length. ``rnnt_loss`` is the transducer's forward recursion in log
space over the (T, U) lattice, with FastEmit's gradient scale on the emit
branch, as the reference's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF
from torch.overrides import handle_torch_function, has_torch_function

from ...core.dispatch import apply_op

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "mse_loss", "l1_loss", "smooth_l1_loss", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "log_loss",
           "square_error_cost", "sigmoid_focal_loss", "ctc_loss",
           "huber_loss", "soft_margin_loss", "multi_margin_loss",
           "multi_label_soft_margin_loss", "dice_loss", "npair_loss",
           "hsigmoid_loss", "margin_cross_entropy", "rnnt_loss",
           "triplet_margin_with_distance_loss"]

_REDUCTIONS = ("mean", "sum", "none")


def _reduce(val, reduction):
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    return val


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Cross entropy along ``axis`` (``nn/functional/loss.py:20-62``): of
    ``log_softmax(input)``, or of ``log(max(input, 1e-30))`` when
    ``use_softmax=False``. Hard labels pick their class's term (0 where
    ``label == ignore_index``), optionally smoothed to ``(1 - ε) · onehot +
    ε / C``; soft labels (``soft_label``) sum ``-label · log p``. Class
    ``weight`` scales each hard label's loss, and "mean" then divides by
    the sum of the picked weights; without weights "mean" divides by the
    number of labels that are not ignored (at least 1)."""
    args = (input, label) + (() if weight is None else (weight,))
    if has_torch_function(args):
        return handle_torch_function(
            cross_entropy, args, input, label, weight=weight,
            ignore_index=ignore_index, reduction=reduction,
            soft_label=soft_label, axis=axis, use_softmax=use_softmax,
            label_smoothing=label_smoothing)
    if reduction not in _REDUCTIONS:
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    ax = axis % input.dim()
    lp = torch.log_softmax(input, dim=ax) if use_softmax else \
        torch.log(torch.clamp(input, min=1e-30))
    n = input.shape[ax]
    if soft_label:
        soft = label
        if label_smoothing > 0.0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n
        return _reduce(-(soft * lp).sum(ax), reduction)
    lab = label.long()
    if lab.dim() == lp.dim():
        lab = lab.squeeze(ax)
    mask = lab != ignore_index
    safe = torch.where(mask, lab, 0)
    if label_smoothing > 0.0:
        oh = (safe.unsqueeze(ax) == torch.arange(n, device=lp.device).view(
            [n if i == ax else 1 for i in range(lp.dim())])).to(lp.dtype)
        soft = oh * (1 - label_smoothing) + label_smoothing / n
        loss = -(soft * lp).sum(ax)
    else:
        loss = -lp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    loss = torch.where(mask, loss, _zero(loss))
    if weight is not None:
        wt = torch.where(mask, weight[torch.clamp(lab, 0, n - 1)],
                         _zero(weight))
        loss = loss * wt
        if reduction == "mean":
            return loss.sum() / torch.clamp(wt.sum(), min=1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(mask.sum().to(loss.dtype), min=1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """One loss a row, keeping the class axis as a 1-dim (Paddle's
    shape); with ``return_softmax``, also the softmax."""
    from ...tensor.manipulation import unsqueeze
    from .activation import softmax
    loss = unsqueeze(cross_entropy(logits, label, soft_label=soft_label,
                                   ignore_index=ignore_index,
                                   reduction="none", axis=axis), axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    """``-input[label]`` along axis 1 (0 for a 1-D input), 0 where ignored;
    with ``weight``, scaled by the label's weight and "mean" divides by the
    sum of the picked weights; without, "mean" is over every label."""
    def fn(lp, lab, *w):
        lab = lab.long()
        mask = lab != ignore_index
        safe = torch.where(mask, lab, 0)
        idx = safe.unsqueeze(-1) if lp.dim() == lab.dim() + 1 else safe
        loss = -torch.take_along_dim(lp, idx, 1 if lp.dim() > 1 else 0)
        if loss.dim() > lab.dim():
            loss = loss.squeeze(1)
        loss = torch.where(mask, loss, _zero(loss))
        if w:
            wt = torch.where(mask, w[0][torch.clamp(lab, 0, w[0].shape[0] - 1)],
                             _zero(w[0]))
            loss = loss * wt
            if reduction == "mean":
                return loss.sum() / torch.clamp(wt.sum(), min=1e-12)
        return _reduce(loss, reduction)
    args = (input, label) + (() if weight is None else (weight,))
    return apply_op("nll_loss", fn, *args)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean", name=None):
    def fn(p, y, *w):
        p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
        loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
        return _reduce(loss * w[0] if w else loss, reduction)
    args = (input, label) + (() if weight is None else (weight,))
    return apply_op("binary_cross_entropy", fn, *args)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The stable form ``max(z, 0) - z·y + log1p(exp(-|z|))``; with
    ``pos_weight`` the positive term is scaled, as the reference's."""
    def fn(z, y, *extra):
        w = extra[0] if weight is not None else None
        pw = extra[-1] if pos_weight is not None else None
        soft = torch.log1p(torch.exp(-z.abs()))
        if pw is not None:
            log_w = (pw - 1.0) * y + 1.0
            loss = (1 - y) * z + log_w * (soft + torch.clamp(-z, min=0.0))
        else:
            loss = torch.clamp(z, min=0.0) - z * y + soft
        return _reduce(loss * w if w is not None else loss, reduction)
    args = (logit, label) + tuple(t for t in (weight, pos_weight)
                                  if t is not None)
    return apply_op("bce_with_logits", fn, *args)


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return apply_op("mse_loss", lambda a, b: _reduce((a - b) ** 2,
                                                     reduction), input, label)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return apply_op("l1_loss", lambda a, b: _reduce((a - b).abs(), reduction),
                    input, label)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    """``0.5 d² / δ`` where ``|d| < δ``, else ``|d| - 0.5 δ``."""
    def fn(a, b):
        d = a - b
        ad = d.abs()
        return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                                   ad - 0.5 * delta), reduction)
    return apply_op("smooth_l1_loss", fn, input, label)


def kl_div(input, label, reduction="mean", name=None):  # noqa: A002
    """``label · (log label - input)`` (input holds log-probabilities);
    "batchmean" divides the sum by the batch size."""
    def fn(lp, y):
        loss = y * (torch.log(torch.clamp(y, min=1e-12)) - lp)
        if reduction == "batchmean":
            return loss.sum() / lp.shape[0]
        return _reduce(loss, reduction)
    return apply_op("kl_div", fn, input, label)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    return apply_op("margin_ranking_loss", lambda a, b, y: _reduce(
        torch.clamp(-y * (a - b) + margin, min=0.0), reduction),
        input, other, label)


def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean", name=None):
    return apply_op("hinge_embedding_loss", lambda a, y: _reduce(
        torch.where(y == 1, a, torch.clamp(margin - a, min=0.0)),
        reduction), input, label)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    def fn(a, b, y):
        cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                                 * torch.linalg.vector_norm(b, dim=-1)
                                 + 1e-12)
        return _reduce(torch.where(y == 1, 1 - cos,
                                   torch.clamp(cos - margin, min=0.0)),
                       reduction)
    return apply_op("cosine_embedding_loss", fn, input1, input2, label)


def triplet_margin_loss(input, positive, negative, margin=1.0,  # noqa: A002
                        p=2.0, epsilon=1e-06, swap=False, reduction="mean",
                        name=None):
    """``max(d(a, p) - d(a, n) + margin, 0)``, d the p-norm distance with
    ``epsilon`` added to each element's term (the reference's form)."""
    def fn(a, pos, neg):
        def dist(u, v):
            return ((u - v).abs() ** p + epsilon).sum(-1) ** (1.0 / p)
        d_an = dist(a, neg)
        if swap:
            d_an = torch.minimum(d_an, dist(pos, neg))
        return _reduce(torch.clamp(dist(a, pos) - d_an + margin, min=0.0),
                       reduction)
    return apply_op("triplet_margin_loss", fn, input, positive, negative)


def log_loss(input, label, epsilon=0.0001, name=None):  # noqa: A002
    return apply_op("log_loss", lambda p, y: -y * torch.log(p + epsilon)
                    - (1 - y) * torch.log(1 - p + epsilon), input, label)


def square_error_cost(input, label):  # noqa: A002
    return apply_op("square_error_cost", lambda a, b: (a - b) ** 2, input,
                    label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def fn(z, y, *nrm):
        p = torch.sigmoid(z)
        ce = torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-z.abs()))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * ((1 - p_t) ** gamma) * ce
        return _reduce(loss / nrm[0] if nrm else loss, reduction)
    args = (logit, label) + (() if normalizer is None else (normalizer,))
    return apply_op("sigmoid_focal_loss", fn, *args)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over ``log_probs`` ``[T, N, C]`` (logits: normalised here, as the
    reference), ``labels`` ``[N, S]`` padded, and the lengths. Each
    sample's loss is torch's ``F.ctc_loss``; "mean" is the mean of each
    loss over its label length, as the reference's."""
    def fn(lp, lab, in_len, lab_len):
        nll = TF.ctc_loss(torch.log_softmax(lp, -1), lab.long(),
                          in_len.long(), lab_len.long(), blank=blank,
                          reduction="none")
        if reduction == "mean":
            return (nll / lab_len.to(nll.dtype)).mean()
        return _reduce(nll, reduction)
    return apply_op("ctc_loss", fn, log_probs, labels, input_lengths,
                    label_lengths)


def huber_loss(input, label, delta=1.0, reduction="mean",  # noqa: A002
               name=None):
    def fn(a, b):
        ad = (a - b).abs()
        q = torch.clamp(ad, max=delta)
        return _reduce(0.5 * q * q + delta * (ad - q), reduction)
    return apply_op("huber_loss", fn, input, label)


def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return apply_op("soft_margin_loss", lambda x, y: _reduce(
        torch.log1p(torch.exp(-y.to(x.dtype) * x)), reduction), input, label)


def multi_margin_loss(input, label, p=1, margin=1.0,  # noqa: A002
                      weight=None, reduction="mean", name=None):
    """``Σ_{j≠y} max(0, margin - x_y + x_j)^p / C`` a sample."""
    def fn(x, y, *w):
        c = x.shape[-1]
        y = y.long()
        xy = x.gather(-1, y.unsqueeze(-1))
        viol = torch.clamp(margin - xy + x, min=0.0) ** p
        if w:
            viol = viol * w[0][y].unsqueeze(-1)
        viol = viol * (1.0 - TF.one_hot(y, c).to(x.dtype))
        return _reduce(viol.sum(-1) / c, reduction)
    args = (input, label) + (() if weight is None else (weight,))
    return apply_op("multi_margin_loss", fn, *args)


def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean", name=None):
    def fn(x, y, *w):
        y = y.to(x.dtype)
        per = y * TF.logsigmoid(x) + (1 - y) * TF.logsigmoid(-x)
        if w:
            per = per * w[0]
        return _reduce(-per.mean(-1), reduction)
    args = (input, label) + (() if weight is None else (weight,))
    return apply_op("multi_label_soft_margin_loss", fn, *args)


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    """``1 - 2·|x ∩ onehot| / (|x| + |onehot| + ε)`` a sample, averaged;
    ``label`` holds class ids with a trailing 1-dim."""
    def fn(x, y):
        oh = TF.one_hot(y.long().squeeze(-1), x.shape[-1]).to(x.dtype)
        axes = tuple(range(1, x.dim()))
        inse = (x * oh).sum(axes)
        denom = x.sum(axes) + oh.sum(axes)
        return (1.0 - 2.0 * inse / (denom + epsilon)).mean()
    return apply_op("dice_loss", fn, input, label)


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Soft-label cross entropy over the anchor-positive similarities plus
    ``l2_reg · 0.25`` times the embeddings' mean squared norms."""
    def fn(a, pos, lab):
        same = (lab.unsqueeze(1) == lab.unsqueeze(0)).to(a.dtype)
        soft = same / same.sum(1, keepdim=True)
        l2 = ((a * a).sum(1).mean() + (pos * pos).sum(1).mean()) * 0.25 \
            * l2_reg
        ce_rows = -(soft * torch.log_softmax(a @ pos.t(), -1)).sum(-1)
        return (soft * ce_rows.unsqueeze(1)).sum(0).mean() + l2
    return apply_op("npair_loss", fn, anchor, positive, labels)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid: the sigmoid cross entropy of each internal
    node on a label's path, summed (``[N, 1]``). The default path is the
    complete binary tree (heap layout, root first); a custom tree comes as
    ``path_table`` (node ids, negative = padding) and ``path_code`` (0/1).
    ``weight``: ``[num_classes - 1, D]``."""
    if path_table is not None and path_code is None:
        raise ValueError("path_code is required with path_table")

    def fn(x, y, w, *extra):
        b = extra[0] if bias is not None else None
        if path_table is not None:
            nodes = extra[-2].long()
            codes = extra[-1].to(x.dtype)
            valid = nodes >= 0
        else:
            depth = max(1, int(np.ceil(np.log2(max(num_classes, 2)))))
            codes_l, nodes_l = [], []
            node = y.long() + num_classes
            for _ in range(depth):
                parent = node // 2
                codes_l.append((node % 2).to(x.dtype))
                nodes_l.append(parent - 1)
                node = parent
            nodes = torch.stack(nodes_l[::-1], -1)
            codes = torch.stack(codes_l[::-1], -1)
            valid = (nodes >= 0) & (nodes < num_classes - 1)
        nid = torch.clamp(nodes, 0, num_classes - 2)
        logit = torch.einsum("nd,nkd->nk", x, w[nid])
        if b is not None:
            logit = logit + b[nid].reshape(logit.shape)
        per = torch.where(valid, -codes * TF.logsigmoid(logit)
                          - (1 - codes) * TF.logsigmoid(-logit),
                          _zero(logit))
        return per.sum(-1, keepdim=True)
    args = [input, label, weight] + [t for t in (bias, path_table, path_code)
                                     if t is not None]
    return apply_op("hsigmoid_loss", fn, *args)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace's combined margin on one device: the label's logit becomes
    ``cos(m1·θ + m2) - m3`` (θ = arccos of the logit), every logit is
    scaled by ``scale``, then softmax cross entropy."""
    def fn(z, y):
        oh = TF.one_hot(y.long(), z.shape[-1]).to(z.dtype)
        theta = torch.arccos(torch.clamp(z, -1.0 + 1e-7, 1.0 - 1e-7))
        target = torch.cos(margin1 * theta + margin2) - margin3
        logp = torch.log_softmax(torch.where(oh > 0, target, z) * scale, -1)
        return _reduce(-(oh * logp).sum(-1), reduction), torch.exp(logp)
    loss, sm = apply_op("margin_cross_entropy", fn, logits, label)
    return (loss, sm) if return_softmax else loss


def rnnt_loss(input, label, input_lengths, label_lengths,  # noqa: A002
              blank=0, fastemit_lambda=0.001, reduction="mean", name=None):
    """The transducer loss of ``input`` logits ``[B, T, U + 1, V]``: the
    forward variable ``α[t, u] = logaddexp(α[t-1, u] + blank[t-1, u],
    α[t, u-1] + emit[t, u-1])`` in float32, ``-(α[T-1, U] + blank[T-1,
    U])`` a sample at its lengths. FastEmit scales the emit branch's
    gradient by ``1 + λ`` and leaves the value."""
    neg = -1e30

    def fn(logits, labels, in_len, lab_len):
        lp = torch.log_softmax(logits.float(), -1)
        b, t_max, u_max, _ = lp.shape
        blank_lp = lp[..., blank]                           # [B, T, U]
        lab = torch.cat([labels.long(), torch.zeros(
            (b, 1), dtype=torch.long, device=lp.device)], 1)[:, :u_max]
        emit_lp = torch.take_along_dim(
            lp, lab[:, None, :, None].expand(b, t_max, u_max, 1),
            -1)[..., 0]                                     # [B, T, U]
        if fastemit_lambda:
            lam = float(fastemit_lambda)
            emit_lp = emit_lp * (1.0 + lam) - emit_lp.detach() * lam
        full = torch.full((b,), neg, device=lp.device)
        rows = []
        prev = None
        for t in range(t_max):
            cells = []
            for u in range(u_max):
                if t == 0 and u == 0:
                    a = torch.zeros((b,), device=lp.device)
                else:
                    base = full if t == 0 else prev[u] + blank_lp[:, t - 1, u]
                    emit = full if u == 0 else \
                        cells[u - 1] + emit_lp[:, t, u - 1]
                    a = torch.logaddexp(base, emit)
                cells.append(a)
            rows.append(torch.stack(cells, -1))
            prev = cells
        alphas = torch.stack(rows, 1)                       # [B, T, U]
        tl = torch.clamp(in_len.long() - 1, min=0)
        ul = torch.clamp(lab_len.long(), 0, u_max - 1)
        ar = torch.arange(b, device=lp.device)
        return _reduce(-(alphas[ar, tl, ul] + blank_lp[ar, tl, ul]),
                       reduction)
    return apply_op("rnnt_loss", fn, input, label, input_lengths,
                    label_lengths)


def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """``max(d(a, p) - d(a, n) + margin, 0)`` with a distance callable
    (default :func:`pairwise_distance`)."""
    from .common import pairwise_distance
    dist = distance_function or pairwise_distance
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = apply_op("minimum", torch.minimum, d_neg,
                         dist(positive, negative))
    return apply_op("triplet_margin_with_distance_loss",
                    lambda dp, dn: _reduce(torch.clamp(dp - dn + margin,
                                                       min=0.0), reduction),
                    d_pos, d_neg)

