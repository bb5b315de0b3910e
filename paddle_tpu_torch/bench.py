"""Training throughput of the port on one CUDA GPU: the counterpart of the
repo's ``bench.py`` (``_run`` and ``main``, ``bench.py:131-172, 272-464``).

    python -m paddle_tpu_torch.bench [--smoke]
        [--config small|medium|large|1.3b|bert|resnet50]
        [--batch N] [--seq S] [--moment-dtype float32|bfloat16]
        [--amp O1|O2] [--no-amp] [--recompute full|dots|attn|none]
        [--steps K] [--windows W] [--input-pipeline] [--workers N]
        [--layout nhwc|nchw]

It prints ONE JSON line with ``bench.py``'s keys and metric names
(``gpt3_1p3b_train_tokens_per_sec``, ``bert_base_pretrain_tokens_per_sec``,
``resnet50_train_images_per_sec``, ...) plus ``device``, the card's name.
The configurations are ``bench.py``'s: ``small`` (GPT-2 small, b=8 s=512),
``medium`` (b=16 s=512), ``large`` (stacked, recompute "full", b=8 s=1024,
bf16 moments), ``1.3b`` (stacked, recompute "full", b=2 s=2048, bf16
moments), ``--seq`` rebuilding a GPT config for that context (stacked with
"full" recompute at s >= 4096 and for ``large``/``1.3b``), ``bert``
(BERT-base MLM+NSP pretraining, b=32 s=512, on the bidirectional flash
kernels) and ``resnet50`` (b=128, 224², NHWC, ``Momentum(0.1, 0.9)``).
AMP O2 in bf16 is the default. Each window is ``run_steps(K)`` on one
resident batch (``--input-pipeline``: K steps, each on the next batch of
``io.DataLoader``); the best of ``--windows`` windows is reported, after a
warm-up window.

- The peak is the card's: MFU is taken over 989e12 FLOP/s, the H100's dense
  bf16 rate (NVIDIA's data sheet), and ``vs_baseline`` is MFU / 0.45 as in
  ``bench.py`` (ResNet-50: images/s / 2000, and ``mfu`` from 3 x 4.089
  GFLOP an image, ``bench.py``'s formula).
- The cost check (``bench.py:218-270``): one training step runs under
  ``torch.utils.flop_counter.FlopCounterMode``, plus the flash kernels'
  operations, which the counter cannot see (``ctypes`` calls; their
  wrappers count them, ``ops/cuda_attention*.py``). Per token, that count
  is compared with the hand formula ``6 N + 12 L H S`` and with the
  full-recompute one ``8 N + 2 (12 L H S)``; off both by more than
  ``_COST_AGREE_TOL`` (0.15), the run fails (exit code 1), as
  ``bench.py:453-461``. The counted step is a real step (it trains).
  ResNet-50's record carries its count too, against 3 x 4.089 GFLOP an
  image, without a gate: that figure counts multiply-adds, so the counter
  reads about twice it, and ``mfu`` (``bench.py``'s) is half the counted
  rate's.
- Not ported: the TPU autotune of the flash block sizes
  (``flash_attention.pretune``; ROADMAP queue 2a, the tuning tables), the
  backend probe and its skip record, and ``BENCH_PEAK_FLOPS``. Without a CUDA device the
  bench raises; ``--smoke`` runs ``gpt_tiny`` on the CPU, because the
  caller asked for it, and its numbers are the CPU's (``vs_baseline`` is
  1.0 there, as in ``bench.py``).

``run(args)`` returns the JSON record and the run's details (steps run,
step ms, peak memory, a callable that runs one more step) without
printing; ``chip_smoke.py`` drives the same functions.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

__all__ = ["build_parser", "gpt_setup", "counted_step", "cost_model_check",
           "run", "main", "PEAK_FLOPS", "COST_AGREE_TOL", "RESNET_FWD_FLOPS"]

# H100 SXM, dense bf16 (NVIDIA's data sheet)
PEAK_FLOPS = 989e12
# counted against hand FLOPs: beyond this from both formulas fails the run
COST_AGREE_TOL = 0.15
# ResNet-50's forward at 224², the figure of bench.py's MFU (bench.py:78)
RESNET_FWD_FLOPS = 4.089e9
_CONFIGS = ("small", "medium", "large", "1.3b", "resnet50", "bert")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="gpt_tiny on the CPU (the plain attention)")
    ap.add_argument("--config", default="1.3b", choices=_CONFIGS,
                    help="default: the north star, GPT-3 1.3B b=2 s=2048")
    ap.add_argument("--batch", type=int, default=0,
                    help="override the batch size (0 = the config's)")
    ap.add_argument("--seq", type=int, default=0,
                    help="override the sequence length (GPT configs)")
    ap.add_argument("--moment-dtype", default=None,
                    choices=["float32", "bfloat16"])
    ap.add_argument("--layout", default=None, choices=["nhwc", "nchw"],
                    help="resnet50's activation layout (default nhwc)")
    ap.add_argument("--recompute", default=None,
                    choices=["full", "dots", "attn", "none"],
                    help="stacked-decoder recompute policy (large, 1.3b and "
                         "--seq >= 4096; default full)")
    ap.add_argument("--steps", type=int, default=40,
                    help="steps a window")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--input-pipeline", action="store_true",
                    help="feed every step from io.DataLoader (GPT configs)")
    ap.add_argument("--workers", type=int, default=2,
                    help="DataLoader workers for --input-pipeline")
    ap.add_argument("--amp", default="O2", choices=["O1", "O2"])
    ap.add_argument("--no-amp", action="store_true",
                    help="float32 throughout (TF32 off for matmuls and "
                    "cuDNN's convolutions)")
    return ap


def gpt_setup(args) -> dict:
    """``bench.py``'s GPT config table (``bench.py:290-339``): the config,
    batch, sequence length, metric name and moment dtype of ``args``."""
    from .models import (gpt2_large, gpt2_medium, gpt2_small, gpt3_1p3b,
                         gpt_tiny)
    moments = args.moment_dtype
    if args.smoke:
        cfg, batch, seq = gpt_tiny(), 2, 64
        metric = "gpt_tiny_smoke_tokens_per_sec"
    elif args.config == "small":
        cfg, batch, seq = gpt2_small(max_seq_len=512), 8, 512
        metric = "gpt2s_train_tokens_per_sec"
    elif args.config == "large":
        cfg = gpt2_large(stacked=True, recompute=args.recompute or "full")
        batch, seq = 8, 1024
        metric = "gpt2l_train_tokens_per_sec"
        moments = moments or "bfloat16"
    elif args.config == "1.3b":
        cfg = gpt3_1p3b(stacked=True, recompute=args.recompute or "full")
        batch, seq = 2, 2048
        metric = "gpt3_1p3b_train_tokens_per_sec"
        moments = moments or "bfloat16"
    else:
        cfg, batch, seq = gpt2_medium(max_seq_len=512), 16, 512
        metric = "gpt2m_train_tokens_per_sec"
    if args.batch:
        batch = args.batch
    if args.seq and not args.smoke:
        seq = args.seq
        base = {"small": gpt2_small, "medium": gpt2_medium,
                "large": gpt2_large, "1.3b": gpt3_1p3b}[args.config]
        kw = dict(max_seq_len=seq)
        if seq >= 4096 or args.config in ("large", "1.3b"):
            kw.update(stacked=True, recompute=args.recompute or "full")
            moments = moments or "bfloat16"
        cfg = base(**kw)
        metric = (f"{metric[:metric.index('_train')]}_s{seq}"
                  "_train_tokens_per_sec")
    if args.input_pipeline:
        metric += "_pipelined"
    return {"cfg": cfg, "batch": batch, "seq": seq, "metric": metric,
            "moment_dtype": moments or "float32"}


def _device(args) -> torch.device:
    if args.smoke:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch.bench measures the port on a CUDA GPU and none "
            "is available; --smoke runs gpt_tiny on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _kernel_flops() -> float:
    from .ops import cuda_attention as ca
    from .ops import cuda_attention_bwd as cab
    return ca.flops + sum(cab.flops.values())


def counted_step(step, batch, n_inputs=None) -> tuple:
    """One training step under ``FlopCounterMode``: ``(all operations,
    the flash kernels' share)``."""
    from torch.utils.flop_counter import FlopCounterMode
    before = _kernel_flops()
    counter = FlopCounterMode(display=False)
    with counter:
        loss = step(*batch, n_inputs=n_inputs)
    _sync(loss.device)
    kernels = _kernel_flops() - before
    return counter.get_total_flops() + kernels, kernels


def cost_model_check(step, batch, tokens, n_params, attn_flops,
                     n_inputs=None) -> dict:
    """One counted step (:func:`counted_step`), per token, against the
    hand formulas (module docstring)."""
    counted, kernels = counted_step(step, batch, n_inputs)
    per_token = counted / tokens
    hand = 6 * n_params + attn_flops
    hand_remat = 8 * n_params + 2 * attn_flops
    ratios = {"plain": per_token / hand, "remat": per_token / hand_remat}
    best = min(ratios, key=lambda k: abs(ratios[k] - 1.0))
    return {"available": True, "flops_per_token": per_token,
            "kernel_flops_per_token": kernels / tokens,
            "hand_flops_per_token": float(hand),
            "hand_remat_flops_per_token": float(hand_remat),
            "ratios": ratios, "best": best,
            "agrees": abs(ratios[best] - 1.0) <= COST_AGREE_TOL,
            "step_flops": counted}


def _windows(args, window, per_window: int) -> dict:
    """A warm-up window, then the best rate of ``args.windows`` timed
    windows (each ends in a host read of the loss: the only sync)."""
    final = window()
    best, walls = 0.0, []
    for _ in range(max(args.windows, 1)):
        t0 = time.perf_counter()
        final = window()
        walls.append(time.perf_counter() - t0)
        best = max(best, per_window / walls[-1])
    if not np.isfinite(final):
        raise FloatingPointError(f"the loss diverged: {final}")
    return {"best": best, "final_loss": final, "window_s": walls}


def _peak_gb(dev):
    return (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
            else None)


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


class TokenDataset:
    """``bench.py``'s token dataset (``bench.py:381-390``): sample i is
    ``RandomState(i).randint(0, vocab, (seq,))``."""

    def __init__(self, n, vocab, seq):
        self.n, self.vocab, self.seq = n, vocab, seq

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.random.RandomState(i).randint(
            0, self.vocab, (self.seq,)).astype("int64")


def run_gpt(args, dev) -> dict:
    from .framework import random as random_mod
    from .jit import TrainStep
    from .models import GPTForCausalLM, GPTPretrainingCriterion
    from .optimizer import AdamW
    setup = gpt_setup(args)
    cfg, batch, seq = setup["cfg"], setup["batch"], setup["seq"]
    random_mod.seed(0)
    _reset_peak(dev)
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype=setup["moment_dtype"])
    amp = None if (args.smoke or args.no_amp) else args.amp
    step = TrainStep(model, lambda out, y: crit(out, y), opt,
                     amp_level=amp)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).to(dev)
    n_params = model.num_params()
    attn_flops = 12 * cfg.num_layers * cfg.hidden_size * seq
    cost = cost_model_check(step, (ids, ids), batch * seq, n_params,
                            attn_flops)
    K = max(args.steps, 1)
    if args.input_pipeline:
        from .io import DataLoader
        loader = DataLoader(
            TokenDataset((K * (args.windows + 1) + 2) * batch,
                         cfg.vocab_size, seq),
            batch_size=batch, shuffle=False, num_workers=args.workers,
            drop_last=True)
        it = iter(loader)

        def window():
            loss = None
            for _ in range(K):
                b = next(it)
                if isinstance(b, (list, tuple)):
                    b = b[0]
                loss = step(b, b)
            return float(loss)
    else:
        def window():
            return float(step.run_steps(K, ids, ids))
    res = _windows(args, window, K * batch * seq)
    mfu = res["best"] * (6 * n_params + attn_flops) / PEAK_FLOPS
    record = {"metric": setup["metric"], "skipped": False,
              "value": round(res["best"], 1), "unit": "tokens/s",
              "vs_baseline": 1.0 if args.smoke else round(mfu / 0.45, 4),
              "cost_model": cost, "device": _device_name(dev)}
    return {"record": record, "tokens_per_s": res["best"], "mfu": mfu,
            "steps_run": 1 + K * (max(args.windows, 1) + 1),
            "step_ms": min(res["window_s"]) / K * 1e3,
            "peak_gb": _peak_gb(dev), "final_loss": res["final_loss"],
            "params": n_params, "batch": batch, "seq": seq,
            "config": cfg, "one_step": lambda: step(ids, ids)}


def run_bert(args, dev) -> dict:
    """BASELINE config 3 (``bench.py:86-128``): BERT-base MLM+NSP
    pretraining, dropout off, b=32 s=512, AdamW, O2."""
    from .framework import random as random_mod
    from .jit import TrainStep
    from .models import (BertConfig, BertForPretraining,
                         BertPretrainingCriterion)
    from .optimizer import AdamW
    cfg = BertConfig(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    random_mod.seed(0)
    _reset_peak(dev)
    model = BertForPretraining(cfg, device=dev, dtype=torch.float32, seed=0)
    # bench labels are dense random ids, none ignored
    crit = BertPretrainingCriterion(ignore_index=-1000)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype=args.moment_dtype or "float32")
    amp = None if args.no_amp else args.amp
    step = TrainStep(model, lambda out, labels, nsp: crit(out, labels, nsp),
                     opt, amp_level=amp)
    batch, seq = (args.batch or 32), 512
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (batch, seq))).to(dev)
    nsp = torch.from_numpy(rng.randint(0, 2, (batch,))).to(dev)
    n_params = model.num_params()
    attn_flops = 12 * cfg.num_layers * cfg.hidden_size * seq
    cost = cost_model_check(step, (ids, ids, nsp), batch * seq, n_params,
                            attn_flops, n_inputs=1)
    K = max(args.steps, 1)
    res = _windows(args, lambda: float(step.run_steps(K, ids, ids, nsp,
                                                      n_inputs=1)),
                   K * batch * seq)
    mfu = res["best"] * (6 * n_params + attn_flops) / PEAK_FLOPS
    record = {"metric": "bert_base_pretrain_tokens_per_sec",
              "skipped": False, "value": round(res["best"], 1),
              "unit": "tokens/s", "vs_baseline": round(mfu / 0.45, 4),
              "cost_model": cost, "device": _device_name(dev)}
    return {"record": record, "tokens_per_s": res["best"], "mfu": mfu,
            "steps_run": 1 + K * (max(args.windows, 1) + 1),
            "step_ms": min(res["window_s"]) / K * 1e3,
            "peak_gb": _peak_gb(dev), "final_loss": res["final_loss"],
            "params": n_params, "batch": batch, "seq": seq, "config": cfg,
            "one_step": lambda: step(ids, ids, nsp, n_inputs=1)}


def run_resnet(args, dev) -> dict:
    """BASELINE config 2 (``bench.py:43-84``): ResNet-50 training, NHWC
    (channels-last) by default, ``Momentum(0.1, 0.9)``, O2, b=128."""
    from .framework import random as random_mod
    from .jit import TrainStep
    from .nn.functional import cross_entropy
    from .optimizer import Momentum
    from .vision.models import resnet50
    layout = (args.layout or "nhwc").upper()
    random_mod.seed(0)
    _reset_peak(dev)
    model = resnet50(num_classes=1000, data_format=layout, device=dev,
                     seed=0)
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.named_parameters())
    amp = None if args.no_amp else args.amp
    step = TrainStep(model, lambda o, y: cross_entropy(o, y), opt,
                     amp_level=amp)
    batch = args.batch or 128
    rng = np.random.RandomState(0)
    shape = (batch, 3, 224, 224) if layout == "NCHW" else (batch, 224, 224,
                                                           3)
    x = torch.from_numpy(rng.randn(*shape).astype("float32")).to(dev)
    y = torch.from_numpy(rng.randint(0, 1000, (batch,))).to(dev)
    # reported, not gated: the hand figure counts multiply-adds
    counted, _ = counted_step(step, (x, y))
    cost = {"available": True, "flops_per_image": counted / batch,
            "hand_flops_per_image": 3 * RESNET_FWD_FLOPS,
            "ratio": counted / batch / (3 * RESNET_FWD_FLOPS)}
    K = max(args.steps, 1)
    res = _windows(args, lambda: float(step.run_steps(K, x, y)), K * batch)
    mfu = res["best"] * 3 * RESNET_FWD_FLOPS / PEAK_FLOPS
    record = {"metric": "resnet50_train_images_per_sec", "skipped": False,
              "value": round(res["best"], 1), "unit": "images/s",
              "vs_baseline": round(res["best"] / 2000.0, 4),
              "mfu": round(mfu, 4), "layout": layout, "cost_model": cost,
              "device": _device_name(dev)}
    return {"record": record, "images_per_s": res["best"], "mfu": mfu,
            "steps_run": 1 + K * (max(args.windows, 1) + 1),
            "step_ms": min(res["window_s"]) / K * 1e3,
            "peak_gb": _peak_gb(dev), "final_loss": res["final_loss"],
            "params": model.num_params(), "batch": batch, "model": model,
            "one_step": lambda: step(x, y)}


def run(args) -> dict:
    """Run the configuration ``args`` asks for; returns its record and
    details (nothing printed)."""
    if args.smoke and args.config in ("resnet50", "bert"):
        raise SystemExit(f"--smoke runs the gpt_tiny CPU config only; run "
                         f"--config {args.config} without --smoke (on a GPU)")
    dev = _device(args)
    runner = {"resnet50": run_resnet, "bert": run_bert}.get(args.config,
                                                            run_gpt)
    if not (args.no_amp and dev.type == "cuda"):
        return runner(args, dev)
    # float32 means float32: cuDNN would round convolutions to TF32
    with tf32(False):
        return runner(args, dev)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for CUDA matmuls and cuDNN inside the block; the
    flags are given back as they were."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    kept = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = on
    try:
        yield
    finally:
        for f, v in zip(flags, kept):
            f.allow_tf32 = v


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = run(args)
    record = out["record"]
    print(json.dumps(record), flush=True)
    cost = record.get("cost_model", {})
    if not cost.get("agrees", True):
        print(f"# FAIL: counted FLOPs/token {cost['flops_per_token']:.3e} "
              f"diverge >{int(COST_AGREE_TOL * 100)}% from the hand formula "
              f"({cost['hand_flops_per_token']:.3e} plain / "
              f"{cost['hand_remat_flops_per_token']:.3e} remat)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
