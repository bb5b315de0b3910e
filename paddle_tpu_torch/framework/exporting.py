"""The port's serialized program artifact (the counterpart of
``paddle_tpu/framework/exporting.py``).

The reference serializes the traced program as StableHLO bytes
(``jax.export``), which torch cannot load. The port's artifact is one file,
``<prefix>.pt2``: a ``torch.export`` program (graph and weights, written by
``torch.export.save``) with a JSON record of its own beside the graph
(``extra_files``): the format tag ``FORMAT``, the feed names, the feed specs
(``{"shape": [None | int, ...], "dtype": "int64"}``, ``None`` for a
dimension of any extent) and the number of outputs.

Devices: the reference exports for both CPU and TPU (``platforms=("cpu",
"tpu")``). A torch program records the device of its weights and of any
tensor its graph creates, so the port writes every artifact for the CPU
(``torch.export.passes.move_to_device_pass`` before the save) and moves the
loaded program to the caller's device: an artifact saved from a model on the
card loads on the CPU, and one saved on the CPU loads onto the card.

The hand-written kernels stay in the program as operators of their own
(``ops/flash_attention.py``: ``paddle_tpu_torch::flash_attention_fwd``);
:class:`LoadedArtifact` imports their module before ``torch.export.load``,
so a fresh process resolves them.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["FORMAT", "SUFFIX", "export_artifact", "load_artifact",
           "LoadedArtifact"]

FORMAT = "paddle_tpu_torch.export.v1"
SUFFIX = ".pt2"
_META = "paddle_tpu_torch.json"


def _is_concrete_int(x) -> bool:
    # imported here: symbolic_shapes pulls in sympy (about a second of
    # start-up), which a process that never exports should not pay
    from torch.fx.experimental.symbolic_shapes import is_concrete_int
    return is_concrete_int(x)


def _to_device(program, device: torch.device):
    import torch.export.passes  # noqa: F401 - not imported by torch.export
    return torch.export.passes.move_to_device_pass(program, device)


def export_artifact(path_prefix: str, module: torch.nn.Module,
                    example_inputs: Sequence[torch.Tensor],
                    dynamic_shapes: Sequence[Dict[int, object]],
                    feed_names: List[str], feeds: List[dict]) -> str:
    """Trace ``module(*example_inputs)`` with ``torch.export`` (no grad;
    ``dynamic_shapes`` one ``{axis: Dim}`` per input) and write it under
    ``path_prefix + ".pt2"``. A dimension that ``feeds`` declares of any
    extent (``None``) but that the forward fixes to its example extent
    raises ``ValueError``."""
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_inputs),
                                      dynamic_shapes=tuple(dynamic_shapes))
    nodes = {n.name: n for n in program.graph.nodes if n.op == "placeholder"}
    for name, node, spec in zip(feed_names,
                                (nodes[n] for n in
                                 program.graph_signature.user_inputs),
                                feeds):
        for ax, want in enumerate(spec["shape"]):
            got = node.meta["val"].shape[ax]
            if want is None and _is_concrete_int(got):
                raise ValueError(
                    f"jit.save: feed {name!r} declares axis {ax} of any "
                    f"extent, but the forward fixes it to {got}")
    program = _to_device(program, torch.device("cpu"))
    meta = {"format": FORMAT, "feed_names": list(feed_names),
            "feeds": list(feeds),
            "n_outputs": len(program.graph_signature.user_outputs)}
    torch.export.save(program, path_prefix + SUFFIX,
                      extra_files={_META: json.dumps(meta)})
    return path_prefix


class LoadedArtifact:
    """A loaded ``.pt2`` artifact on ``device``: ``program`` (the
    ``ExportedProgram``), ``module`` (its callable ``GraphModule``), the
    feed names and specs, the output count and the file's ``path``.
    Calling it on device tensors returns the list of outputs."""

    def __init__(self, path_prefix: str, device: torch.device):
        from ..ops import flash_attention  # noqa: F401 - registers the ops
        path = path_prefix + SUFFIX
        if not os.path.exists(path):
            raise FileNotFoundError(f"no {SUFFIX} artifact at {path}")
        extra = {_META: ""}
        program = torch.export.load(path, extra_files=extra)
        try:
            meta = json.loads(extra[_META])
        except ValueError:
            meta = {}
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path} is not a {FORMAT} artifact")
        self.path = path
        self.device = torch.device(device)
        if self.device.type != "cpu":
            program = _to_device(program, self.device)
        self.program = program
        self.module = program.module()
        self.feed_names = meta["feed_names"]
        self.feeds = meta["feeds"]
        self.n_outputs = meta["n_outputs"]

    def __call__(self, *inputs) -> List[torch.Tensor]:
        with torch.no_grad():
            out = self.module(*inputs)
        return list(out) if isinstance(out, (list, tuple)) else [out]


def load_artifact(path_prefix: str,
                  device: Optional[torch.device] = None) -> LoadedArtifact:
    """Load ``path_prefix + ".pt2"`` onto ``device`` (default: the CUDA
    device; without one, the caller must ask for the CPU)."""
    from .device import resolve_device
    return LoadedArtifact(path_prefix, resolve_device(device))
