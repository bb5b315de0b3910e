"""Inference serving benchmark of the port: latency p50/p99 and QPS through
the ``inference.Predictor`` surface, float32 against bf16 (the counterpart of
``tools/bench_inference.py``).

    python -m paddle_tpu_torch.bench_inference [--iters N] [--out FILE]
        [--cpu] [--small]

The models are the reference's: an ERNIE-base classifier (dropout 0) at
b=8 s=128 and ResNet-50 at b=8, 224² (``--small``: ``ernie_tiny`` at b=2
s=16 and resnet18 at b=1, 64²), weights from seed 0. Each is saved with
``jit.save`` in float32 and, after ``amp.decorate`` to bf16, again in bf16
(the reference reaches bf16 through ``Config.set_precision``, which
re-lowers its ``.pdmodel`` program: ROADMAP queue 1 item 5d; the bf16
program casts float feeds to bf16 itself), and served by
a Predictor of each. Per precision it reports ``p50_ms``, ``p99_ms`` and
``qps`` of ``Predictor.run`` on host arrays (copies both ways included);
bf16 adds ``max_rel_err_vs_f32`` (max |bf16 - f32| over max |f32|), and the
record ``speedup_p50`` (f32 p50 / bf16 p50), as the reference's keys. On the
card each precision also reports ``device_ms``, the program's time on
device-resident inputs (the median of CUDA events around ``--iters`` runs,
each queued behind a device-side sleep: the card's time, not the host's
dispatch),
and the record ``speedup_device``; a CPU run (``--cpu``) has no device time
and reports none. Without a CUDA device and without ``--cpu`` it raises.
The JSON (the reference's, plus ``device``, the card's name or "cpu") goes to
stdout and to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

__all__ = ["bench_model", "bench_predictor", "device_ms", "main"]


class _CastInputs(torch.nn.Module):
    """``model`` behind a cast of its (one) floating input to its own
    dtype, so a bf16 model takes the float32 feed of the float32 one (numpy
    has no bfloat16); the cast is part of the saved program."""

    def __init__(self, model, dtype):
        super().__init__()
        self.model = model
        self.dtype = dtype

    def forward(self, x):
        return self.model(x.to(self.dtype) if x.is_floating_point() else x)


def device_ms(program, xs, stream, iters) -> float:
    """Device time of one run of ``program`` on the device tensors ``xs``,
    the median over ``iters`` runs: each run is enqueued on ``stream``
    behind a device-side sleep longer than the host takes to enqueue it,
    so the CUDA events around it see the card's time, not the host's
    dispatch (a model's forward launches a few hundred kernels, more time
    on the host than on the card at small batches; one run a sleep keeps
    them within the launch queue)."""
    times = []
    with torch.cuda.stream(stream):
        program(*xs)
        stream.synchronize()
        t0 = time.perf_counter()
        program(*xs)
        stream.synchronize()
        one_s = time.perf_counter() - t0
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            # cycles of a clock of at most 2 GHz: twice the host's time
            torch.cuda._sleep(int(min(1.0, 2.0 * one_s + 0.002) * 2e9))
            start.record()
            program(*xs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def bench_predictor(pred, feeds, iters) -> dict:
    """``Predictor.run(feeds)``'s p50/p99 ms and QPS over ``iters`` calls
    after 3 warm-up calls, and on the card its program's ``device_ms``."""
    for _ in range(3):                    # warm-up, not timed
        pred.run(feeds)
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        pred.run(feeds)                   # host <-> device copies included
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat) * 1e3
    row = {"p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "qps": float(1e3 / lat.mean())}
    if pred.device.type == "cuda":
        xs = [torch.from_numpy(f).to(pred.device) for f in feeds]
        row["device_ms"] = device_ms(pred._artifact, xs, pred._stream,
                                     iters)
    return row


def bench_model(name, model, feeds, iters, device) -> dict:
    """Save ``model`` in float32 and in bf16 (``amp.decorate``), serve each
    through a Predictor on ``device`` and time ``Predictor.run(feeds)``."""
    from . import amp, inference, jit
    from .static import InputSpec

    specs = [InputSpec(list(f.shape), str(f.dtype)) for f in feeds]
    rows, f32_out = {}, None
    with tempfile.TemporaryDirectory(prefix=f"infer_{name}_") as d:
        for prec in ("float32", "bfloat16"):
            if prec == "bfloat16":
                model = _CastInputs(amp.decorate(model, dtype="bfloat16"),
                                    torch.bfloat16)
            prefix = os.path.join(d, f"{name}_{prec}")
            jit.save(model, prefix, input_spec=specs)
            cfg = inference.Config(prefix)
            if device.type == "cpu":
                cfg.disable_gpu()
            pred = inference.create_predictor(cfg)
            rows[prec] = bench_predictor(pred, feeds, iters)
            out = pred.run(feeds)[0]
            del pred
            if prec == "float32":
                f32_out = out
            else:
                scale = np.abs(f32_out).max() + 1e-9
                rows[prec]["max_rel_err_vs_f32"] = float(
                    np.abs(out - f32_out).max() / scale)
    if "device_ms" in rows["bfloat16"]:
        rows["speedup_device"] = rows["float32"]["device_ms"] / \
            rows["bfloat16"]["device_ms"]
    rows["speedup_p50"] = rows["float32"]["p50_ms"] / \
        rows["bfloat16"]["p50_ms"]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch."
                                 "bench_inference",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (no device times)")
    ap.add_argument("--small", action="store_true",
                    help="tiny configs for a CPU smoke run")
    args = ap.parse_args(argv)

    from .framework.device import resolve_device
    from .models import (ErnieForSequenceClassification, ernie_base,
                         ernie_tiny)
    from .vision.models import resnet18, resnet50

    device = resolve_device("cpu" if args.cpu else None)
    results = {"device": torch.cuda.get_device_name(device)
               if device.type == "cuda" else "cpu"}

    cfg = ernie_tiny() if args.small else ernie_base(
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ernie = ErnieForSequenceClassification(cfg, num_classes=2,
                                           device=device).eval()
    bs, seq = (2, 16) if args.small else (8, 128)
    ids = np.random.RandomState(0).randint(
        1, cfg.vocab_size, (bs, seq)).astype("int64")
    results[f"ernie_{'tiny' if args.small else 'base'}_b{bs}_s{seq}"] = \
        bench_model("ernie", ernie, [ids], args.iters, device)
    del ernie

    rn = (resnet18 if args.small else resnet50)(device=device).eval()
    rbs, rsz = (1, 64) if args.small else (8, 224)
    img = np.random.RandomState(0).randn(rbs, 3, rsz, rsz).astype("float32")
    results[f"resnet{'18' if args.small else '50'}_b{rbs}_{rsz}"] = \
        bench_model("resnet", rn, [img], args.iters, device)

    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
