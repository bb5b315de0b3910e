"""Loss functionals: the port of ``paddle_tpu/nn/functional/loss.py``
(``cross_entropy`` with the reference's hard-label semantics)."""
from __future__ import annotations

import torch
from torch.overrides import handle_torch_function, has_torch_function

__all__ = ["cross_entropy"]


def cross_entropy(input, label, ignore_index=-100):  # noqa: A002
    """Softmax cross entropy over hard labels along the last axis, as the
    reference's default ``reduction="mean"`` (``nn/functional/loss.py:20-62``):
    ``-log_softmax(input)[label]``, 0 where ``label == ignore_index``,
    summed and divided by the number of labels that are not ignored (at
    least 1). The softmax runs in the input's type (float32 under AMP,
    where ``cross_entropy`` is black-listed). Other reductions, soft labels,
    class weights and label smoothing are not ported (ROADMAP queue 1 item
    5d: the rest of the surface)."""
    if has_torch_function((input, label)):
        return handle_torch_function(cross_entropy, (input, label), input,
                                     label, ignore_index=ignore_index)
    lp = torch.log_softmax(input, dim=-1)
    lab = label.long()
    mask = lab != ignore_index
    picked = lp.gather(-1, torch.where(mask, lab, 0).unsqueeze(-1))
    loss = torch.where(mask, -picked.squeeze(-1), 0.0)
    return loss.sum() / mask.sum().clamp(min=1).to(loss.dtype)
