"""``jit.save`` / ``jit.load`` of the port (the counterparts of
``paddle_tpu/jit/api.py:315-439``).

``save`` traces a model's forward in eval mode with ``torch.export`` and
writes the port's artifact (``framework/exporting.py``: one ``<prefix>.pt2``);
``load`` rebuilds a servable ``TranslatedLayer`` from it, in this process or
a fresh one, and ``inference.Predictor`` serves the same file. The input
specs follow the reference: ``None`` or -1 marks a dimension of any extent,
which becomes a ``torch.export`` dynamic dimension (``Dim.AUTO``: its range
is what the forward allows, e.g. a sequence no longer than the position
table), so one artifact takes every batch and sequence length. ``to_static``
and dy2static wait for ROADMAP queue 1 item 5d, as does the reference's
``.pdmodel``/``.pdiparams`` pair that its ``save`` writes beside its own
artifact; ``to_static``'s compile-cache site (reference
``jit/api.py:180-200``) comes with it.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..framework.device import resolve_device
from ..framework.exporting import export_artifact, load_artifact
from ..static import InputSpec, to_torch_dtype

__all__ = ["save", "load", "TranslatedLayer"]

# example extents of the dynamic dimensions while tracing: distinct, so
# that torch.export does not take two dynamic dimensions for one
_EXAMPLE_EXTENTS = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29)


def _specs_from_input_spec(input_spec, device):
    """InputSpec / tensor / array list -> (example tensors on ``device``,
    ``dynamic_shapes``, feed names, feed specs)."""
    examples, dynamic, names, feeds = [], [], [], []
    n_dyn = 0
    for i, s in enumerate(input_spec):
        if isinstance(s, (torch.Tensor, np.ndarray)):
            s = InputSpec(tuple(s.shape), str(s.dtype).removeprefix(
                "torch."), getattr(s, "name", None))
        elif not isinstance(s, InputSpec):
            raise TypeError(f"unsupported input_spec entry: {s!r}")
        dtype = to_torch_dtype(s.dtype)
        shape, spec_shape, dims = [], [], {}
        for ax, d in enumerate(s.shape):
            if d is None or int(d) < 0:
                shape.append(_EXAMPLE_EXTENTS[n_dyn % len(_EXAMPLE_EXTENTS)])
                spec_shape.append(None)
                dims[ax] = torch.export.Dim.AUTO
                n_dyn += 1
            else:
                shape.append(int(d))
                spec_shape.append(int(d))
        examples.append(torch.zeros(shape, dtype=dtype, device=device))
        dynamic.append(dims or None)
        names.append(s.name or f"feed_{i}")
        feeds.append({"shape": spec_shape,
                      "dtype": str(dtype).removeprefix("torch.")})
    return examples, dynamic, names, feeds


def save(layer, path, input_spec=None, **configs):
    """``paddle.jit.save``: export ``layer``'s forward, in eval mode and
    without grad, as ``path + ".pt2"``, loadable in a fresh process by
    :func:`load` or ``inference.Predictor``. ``input_spec`` (``InputSpec``,
    tensors or arrays, one per forward argument) is required, as in the
    reference; the examples are built on the device of ``layer``'s
    weights."""
    if not isinstance(layer, nn.Module):
        raise TypeError("jit.save expects a Layer (a torch.nn.Module)")
    if input_spec is None:
        raise ValueError(
            "jit.save requires input_spec=[InputSpec(shape, dtype), ...] "
            "(or example tensors) to trace the forward for export")
    if configs.get("pdmodel_format"):
        raise NotImplementedError(
            "the reference's .pdmodel/.pdiparams format waits for ROADMAP "
            "queue 1 item 5d; the port writes its .pt2 artifact")
    first = next(iter(layer.parameters()), None)
    device = first.device if first is not None else torch.device("cpu")
    examples, dynamic, names, feeds = _specs_from_input_spec(input_spec,
                                                             device)
    training = layer.training
    layer.eval()
    try:
        export_artifact(path, layer, examples, dynamic, names, feeds)
    finally:
        layer.train(training)


class TranslatedLayer(nn.Module):
    """Inference-only layer rebuilt from a saved artifact (the reference's
    ``TranslatedLayer``): ``program`` is the artifact's ``GraphModule``,
    whose parameters are real, so ``state_dict`` works; ``forward`` runs
    the exported program (no autograd through it)."""

    def __init__(self, artifact):
        super().__init__()
        self._artifact = artifact
        self.program = artifact.module

    def forward(self, *args):
        dev = self._artifact.device
        xs = [a.to(dev) if isinstance(a, torch.Tensor)
              else torch.as_tensor(np.asarray(a), device=dev) for a in args]
        outs = self._artifact(*xs)
        return outs[0] if len(outs) == 1 else tuple(outs)


def load(path, device=None, **configs):
    """``paddle.jit.load``: a servable layer from ``path + ".pt2"`` on
    ``device`` (default: the CUDA device; ``device="cpu"`` must be asked
    for)."""
    return TranslatedLayer(load_artifact(path, resolve_device(device)))
