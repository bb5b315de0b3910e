#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases card,build,kernels,model,engine]

Phases, each failing loudly (exit code 1, no result line):

1. card     — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build    — builds the hand-written kernels from ``paddle_tpu_torch/csrc``.
3. kernels  — each kernel against its plain PyTorch version on the card at
              the serving shapes, with its median device time (CUDA events
              around calls queued behind a device-side sleep), its host
              launch overhead, the
              plain version's time, the least time the card could take
              (bytes over 3.35 TB/s or operations over the peak rate of
              their type, whichever is larger) and, where one PyTorch call
              computes the same function, that call's time.
4. model    — GPT-3 1.3B in bf16 from a seeded generator: one cached
              prefill and teacher-forced decode steps, once through the
              kernels and once through their plain versions; the same
              weights in float32 hold the two paths together tightly and
              give the bf16 rounding floor, against which the bf16 kernel
              path is held; a profile of decode steps shows where the
              step's time goes.
5. engine   — GenerationServer over the same model serving 16 requests;
              every kernel's launch count is read around this run.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside this script, it exits non-zero and prints no
result. It imports nothing of JAX and nothing of ``paddle_tpu``.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

ALL_PHASES = ("card", "build", "kernels", "model", "engine")

# bf16 kernels against their plain versions: max |kernel - plain| over a
# row / rms(plain row) (row_err), set from the readings of the sound
# kernels (NVIDIA H100 80GB HBM3, 700 W) with a margin of about 1.5x.
# Rounding the output costs up to 2^-8 of an element, a few times the row's
# rms at its largest elements: the paged kernel read at most 0.0215. The
# flash kernel also rounds its probabilities to bf16 for the second
# product: it read at most 0.0349, and the plain version with its
# probabilities rounded so reads 0.0331 against the plain version itself
# (printed beside each case as row_err_plain_p_bf16).
BF16_ROW_LIMIT = {"flash_fwd": 0.05, "paged_attention": 0.03}

# model logits, max |a - b| / std(b) per step: the float32 model's kernel
# and plain paths; the bf16 kernel path's distance from the float32 model
# against the bf16 plain path's own (its rounding floor)
F32_MODEL_LIMIT = 1e-4
BF16_FLOOR_FACTOR = 1.5


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of one call of ``fn``: the timed calls are all
    enqueued behind a device-side sleep, so the GPU runs them back to back
    and the CUDA events around each one see kernel time, not the host's
    launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    # hold the stream while the host enqueues (sleep counted in cycles of
    # a clock of at most 2 GHz, with a 2x margin over the host's time)
    torch.cuda._sleep(int(min(4.0, 2.0 * one_s * iters + 0.005) * 2e9))
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(fn, iters: int = 50) -> float:
    """Host time of one call of ``fn`` (launch overhead: Python, checks,
    enqueue), averaged over back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item()) \
        if a.numel() else 0.0


def row_err(got, want) -> float:
    """max over rows of max|got - want| / rms(want row), a row being the
    last dimension (one head of one position). Attention outputs shrink
    as the context grows (about sqrt(e / n) for unit-normal inputs), so
    an absolute tolerance says little about long rows; this measure scales
    each row by its own size. Rows that are zero in ``want`` (dead rows)
    must be exactly zero in ``got``."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1).sqrt()
    live = rms > 0
    require(bool((g[~live] == 0).all()), "dead rows are not zero")
    if not bool(live.any()):
        return 0.0
    return float(((g - w).abs().amax(-1)[live] / rms[live]).max())


def check_close(name, got, want, dtype, row_limit) -> tuple:
    """The stated tolerances: atol/rtol 2e-5 in float32, 2e-2 in bf16;
    bf16 also holds each row at ``row_limit`` of its own rms. Returns
    (max abs err, row-scaled err)."""
    import torch
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    err = max_abs_err(got, want)
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    require(bool(torch.isfinite(got.float()).all()),
            f"{name}: non-finite output")
    require(ok, f"{name}: max abs err {err:.3e} beyond atol/rtol {tol}")
    rel = row_err(got, want)
    if dtype == torch.bfloat16:
        require(rel <= row_limit,
                f"{name}: row-scaled err {rel:.4f} beyond {row_limit}")
    return err, rel


# ------------------------------------------------------------- phases
def phase_card(state):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stdout}")
    state["smi"] = smi.stdout.strip().splitlines()[0]
    log(f"card: {state['smi']}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")


def phase_build(state):
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    state["build_s"] = time.perf_counter() - t0
    log(f"build: {state['build_s']:.1f} s (nvcc {_build.build_seconds():.1f}"
        f" s)")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "build_log.txt").write_text(_build.build_log())
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")


def _mha_p_bf16(q, k, v, causal, scale):
    """The plain flash forward with its unnormalised probabilities rounded
    to bf16 before the product with v, as the bf16 kernel rounds them for
    its second tensor-core product: the size of that rounding alone."""
    import torch
    from paddle_tpu_torch.ops.cuda_attention import NEG_INF
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        sq, sk = logits.shape[-2:]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            sk - sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    del logits
    out = torch.matmul(p.to(torch.bfloat16).float(), vf) / p.sum(
        -1, keepdim=True)
    return out.transpose(1, 2).to(q.dtype)


def _flash_case(b, s, h, d, dtype, causal, seed, report=False):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_attention as ca
    g = torch.Generator(device="cuda").manual_seed(seed)
    # q/k/v as strided views of one [B, S, H, 3, D] tensor, as the GPT
    # layer hands them to the prefill
    qkv = torch.randn(b, s, h, 3, d, device="cuda", generator=g).to(dtype)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    scale = 1.0 / math.sqrt(d)
    out, lse = ca.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    ref, ref_lse = ca.mha_fwd_reference(q, k, v, causal=causal, scale=scale)
    name = (f"flash_fwd B={b} S={s} H={h} D={d} {str(dtype)[6:]} "
            f"{'causal' if causal else 'full'}")
    err, rel = check_close(name, out, ref, dtype,
                           BF16_ROW_LIMIT["flash_fwd"])
    lerr = max_abs_err(lse, ref_lse)
    require(lerr <= 1e-3, f"{name}: lse max abs err {lerr:.3e}")
    elt = torch.empty((), dtype=dtype).element_size()
    pairs = s * (s + 1) // 2 if causal else s * s
    nbytes = 4 * b * s * h * d * elt + b * h * s * 4
    flops = 4.0 * d * b * h * pairs
    bms, by = bound_ms(nbytes, flops, dtype)
    row = {"case": name, "max_abs_err": err, "row_err": rel,
           "lse_err": lerr, "bound_ms": bms, "bound_by": by}
    if dtype == torch.bfloat16:
        row["row_err_plain_p_bf16"] = row_err(
            _mha_p_bf16(q, k, v, causal, scale), ref)
    if report:
        def kern():
            ca.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        row["ms"] = device_ms(kern)
        row["host_us"] = host_us(kern)
        row["plain_ms"] = device_ms(lambda: ca.mha_fwd_reference(
            q, k, v, causal=causal, scale=scale), iters=5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        row["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale))
    log("  " + json.dumps(row))
    return row


def _paged_inputs(b, s, h, d, page_size, pages_per_seq, dtype, kind, seed):
    """Pools filled with unit-normal values (the trash page too), a
    shuffled page table with trash-page tails past each row's context,
    ragged contexts and one dead row."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    num_pages = 1 + b * pages_per_seq
    shape = (num_pages, page_size, h, d)
    k_pool = torch.randn(shape, device="cuda", generator=g).to(dtype)
    v_pool = torch.randn(shape, device="cuda", generator=g).to(dtype)
    q = torch.randn(b, s, h, 3, d, device="cuda", generator=g).to(dtype)[
        :, :, :, 0]
    cap = pages_per_seq * page_size
    perm = 1 + torch.randperm(num_pages - 1, device="cuda", generator=g)
    tables = perm.reshape(b, pages_per_seq).to(torch.int32)
    if kind == "decode":
        ctx = torch.linspace(1, cap, b, device="cuda").round().to(
            torch.int32)
        ctx[b // 2] = 0                                  # a dead lane
        valid = (ctx > 0)[:, None].expand(b, s).contiguous()
        positions = (ctx - 1).clamp(min=0)[:, None].expand(b, s).contiguous()
    else:
        start = torch.linspace(3, cap - s, b, device="cuda").round().to(
            torch.int32)
        seg = torch.full((b,), s, dtype=torch.int32, device="cuda")
        seg[1] = max(1, s // 3)
        seg[b // 2] = 0                                  # a dead row
        offs = torch.arange(s, device="cuda", dtype=torch.int32)[None]
        positions = start[:, None] + offs
        valid = offs < seg[:, None]
        ctx = start + seg
    used = (ctx.long() + page_size - 1) // page_size
    cols = torch.arange(pages_per_seq, device="cuda")[None]
    tables = torch.where(cols < used[:, None], tables,
                         torch.zeros_like(tables))       # trash-page tails
    return q, k_pool, v_pool, tables, ctx, valid, positions


def _paged_case(b, s, h, d, page_size, pages_per_seq, dtype, kind, seed,
                report=False):
    import torch
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    q, kp, vp, tables, ctx, valid, positions = _paged_inputs(
        b, s, h, d, page_size, pages_per_seq, dtype, kind, seed)
    scale = 1.0 / math.sqrt(d)
    kw = dict(page_size=page_size, kind=kind, scale=scale)
    out = cpa.paged_attention(q, kp, vp, tables, ctx, valid, positions, **kw)
    torch.cuda.synchronize()
    ref = cpa.paged_attention_reference(q, kp, vp, tables, ctx, valid,
                                        positions, **kw)
    name = (f"paged_attention {kind} B={b} S={s} H={h} D={d} "
            f"page={page_size} {str(dtype)[6:]}")
    err, rel = check_close(name, out, ref, dtype,
                           BF16_ROW_LIMIT["paged_attention"])
    # the live context this call needs: per row of the batch, the longest
    # visible prefix among its window positions
    if kind == "decode":
        n_live = ctx.long()[:, None].expand(b, s)
    else:
        n_live = torch.where(valid, torch.minimum(positions.long() + 1,
                                                  ctx.long()[:, None]),
                             torch.zeros_like(positions, dtype=torch.long))
    n_live = n_live.clamp(min=0)
    elt = torch.empty((), dtype=dtype).element_size()
    kv_tokens = int(n_live.max(dim=1).values.sum())
    nbytes = (2 * b * s * h * d * elt + 2 * kv_tokens * h * d * elt
              + tables.numel() * 4 + ctx.numel() * 4 + 8 * b * s)
    flops = 4.0 * d * h * float(n_live.sum())
    bms, by = bound_ms(nbytes, flops, dtype)
    row = {"case": name, "max_abs_err": err, "row_err": rel,
           "bound_ms": bms, "bound_by": by}
    if report:
        def kern():
            cpa.paged_attention(q, kp, vp, tables, ctx, valid, positions,
                                **kw)
        row["ms"] = device_ms(kern)
        row["host_us"] = host_us(kern)
        row["plain_ms"] = device_ms(lambda: cpa.paged_attention_reference(
            q, kp, vp, tables, ctx, valid, positions, **kw), iters=5)
        row["library_ms"] = None
    log("  " + json.dumps(row))
    return row


def phase_kernels(state):
    import torch
    seed = state["seed"]
    rows = []
    log(f"kernels: flash_fwd vs mha_fwd_reference (atol/rtol 2e-5 f32, "
        f"2e-2 bf16; bf16 row_err <= {BF16_ROW_LIMIT['flash_fwd']})")
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8):
            for s in (1, 17, 128, 1000, 2048):
                rows.append(_flash_case(b, s, 16, 128, dtype, True,
                                        seed + s + b, report=True))
    rows.append(_flash_case(2, 300, 16, 64, torch.float32, False,
                            seed + 1))
    rows.append(_flash_case(2, 77, 8, 64, torch.bfloat16, True,
                            seed + 2))
    state["flash_rows"] = rows
    # the main path's prefill: 8 rows in the 2048 bucket, bf16
    state["flash_main"] = next(
        r for r in rows if r["case"].startswith("flash_fwd B=8 S=2048")
        and "bfloat16" in r["case"])

    log(f"kernels: paged_attention vs paged_attention_reference (same; "
        f"bf16 row_err <= {BF16_ROW_LIMIT['paged_attention']})")
    prow = []
    for dtype in (torch.bfloat16, torch.float32):
        prow.append(_paged_case(8, 1, 16, 128, 16, 128, dtype,
                                "decode", seed + 3, report=True))
        for s in (5, 300):
            prow.append(_paged_case(8, s, 16, 128, 16, 128, dtype,
                                    "chunked", seed + s, report=True))
    prow.append(_paged_case(3, 5, 4, 64, 64, 6, torch.float32,
                            "chunked", seed + 4))
    prow.append(_paged_case(5, 1, 4, 64, 4, 40, torch.bfloat16,
                            "decode", seed + 5))
    state["paged_rows"] = prow
    state["paged_main"] = next(
        r for r in prow if r["case"].startswith("paged_attention decode B=8")
        and "bfloat16" in r["case"])
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "kernels.json").write_text(json.dumps(
        {"card": state.get("smi"), "flash_fwd": rows,
         "paged_attention": prow}, indent=1))


PAGE_SIZE = 16
MAX_BATCH = 8


def _model(state):
    import torch
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    if "model" not in state:
        t0 = time.perf_counter()
        model = GPTForCausalLM(gpt3_1p3b(), device="cuda",
                               dtype=torch.bfloat16, seed=state["seed"])
        model.eval()
        torch.cuda.synchronize()
        state["model"] = model
        log(f"model: gpt3_1p3b bf16, {model.num_params() / 1e9:.3f} B "
            f"params, built in {time.perf_counter() - t0:.1f} s")
    return state["model"]


def phase_model(state):
    """One cached prefill (8 rows, prompts of 64-1536 tokens in the 2048
    window) and 8 teacher-forced decode steps, through the kernels and
    through their plain versions; logits compared."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving.generation import CachedDecoder
    model = _model(state)
    cfg = model.config
    rng = np.random.RandomState(state["seed"])
    b, pps = MAX_BATCH, cfg.max_seq_len // PAGE_SIZE
    lens = rng.permutation(np.linspace(64, 1536, b).astype(np.int32))
    window = 2048
    ids = np.zeros((b, window), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, cfg.vocab_size, n)
    tables = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
    # the same weights in float32, through the plain versions: the
    # reference that measures the bf16 rounding floor itself
    from paddle_tpu_torch.models import GPTForCausalLM
    m32 = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    m32.eval()
    runs = {}
    feed = []
    for label, mdl, use_kernels in (("kernels", model, True),
                                    ("plain", model, False),
                                    ("plain_f32", m32, False),
                                    ("kernels_f32", m32, True)):
        dec = CachedDecoder(mdl, max_batch=b, page_size=PAGE_SIZE,
                            pages_per_seq=pps, use_kernels=use_kernels,
                            device="cuda")
        k, v = mdl.init_kv_pools(1 + b * pps, PAGE_SIZE)
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, k, v = dec.prefill(ids, lens, tables, k, v)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        outs.append(last.float())
        ctx = lens.copy()
        t0 = time.perf_counter()
        for step in range(8):
            if label == "kernels":
                feed.append(outs[-1].argmax(-1).cpu().numpy())
            logits, k, v = dec.decode(feed[step], ctx, np.ones(b, bool),
                                      ctx + 1, tables, k, v)
            outs.append(logits.float())
            ctx = ctx + 1
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / 8
        runs[label] = outs
        log(f"model: {label:9s} prefill {prefill_ms:.1f} ms, decode step "
            f"{decode_ms:.2f} ms")
        del k, v
        torch.cuda.empty_cache()
    del m32
    torch.cuda.empty_cache()
    state["decode_profile"] = _profile_decode(model, ids, lens, tables, feed)
    def dist(a, ref):
        return max_abs_err(a, ref) / float(ref.float().std())

    for label, outs in runs.items():
        for i, a in enumerate(outs):
            require(bool(torch.isfinite(a).all()) and a.shape == (
                b, cfg.vocab_size), f"model: {label} step {i} logits bad")
    ratios = [dist(a, p) for a, p in zip(runs["kernels"], runs["plain"])]
    k_f32 = [dist(a, r) for a, r in zip(runs["kernels"], runs["plain_f32"])]
    floors = [dist(p, r) for p, r in zip(runs["plain"], runs["plain_f32"])]
    f32 = [dist(a, p) for a, p in zip(runs["kernels_f32"], runs["plain_f32"])]
    agree = [float((a.argmax(-1) == p.argmax(-1)).float().mean())
             for a, p in zip(runs["kernels"], runs["plain"])]
    log("model: float32, max |kernel - plain| / std per step "
        + " ".join(f"{x:.2e}" for x in f32) + f" (limit {F32_MODEL_LIMIT})")
    log("model: bf16, max |kernel - plain f32| / std per step "
        + " ".join(f"{x:.4f}" for x in k_f32))
    log("model: bf16 floor, max |plain - plain f32| / std per step "
        + " ".join(f"{x:.4f}" for x in floors)
        + f" (kernel path limit {BF16_FLOOR_FACTOR} x its max)")
    log("model: bf16, max |kernel - plain| / std per step "
        + " ".join(f"{x:.4f}" for x in ratios))
    log(f"model: argmax agreement kernel/plain {np.mean(agree):.4f} "
        f"(min {min(agree):.3f})")
    require(max(f32) <= F32_MODEL_LIMIT,
            f"model: float32 kernel path differs from the plain path by "
            f"{max(f32):.2e} x std")
    bf16_limit = BF16_FLOOR_FACTOR * max(floors)
    require(max(k_f32) <= bf16_limit,
            f"model: bf16 kernel path is {max(k_f32):.4f} x std from float32, "
            f"beyond {BF16_FLOOR_FACTOR} x the plain path's {max(floors):.4f}")
    state["model_check"] = {"f32_max_err_over_std": max(f32),
                            "bf16_kernel_vs_f32_over_std": max(k_f32),
                            "bf16_floor_over_std": max(floors),
                            "bf16_kernel_vs_plain_over_std": max(ratios),
                            "per_step_kernel_vs_plain": ratios,
                            "argmax_agreement": float(np.mean(agree))}


def _profile_decode(model, ids, lens, tables, feed):
    """Device time of one kernel-path decode step by kernel name
    (torch.profiler over 4 steps after a prefill), beside its wall time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving.generation import CachedDecoder
    b = ids.shape[0]
    pps = tables.shape[1]
    dec = CachedDecoder(model, max_batch=b, page_size=PAGE_SIZE,
                        pages_per_seq=pps, device="cuda")
    k, v = model.init_kv_pools(1 + b * pps, PAGE_SIZE)
    _, k, v = dec.prefill(ids, lens, tables, k, v)
    ctx = lens.copy()
    steps = 4
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in range(steps):
            logits, k, v = dec.decode(feed[step], ctx, np.ones(b, bool),
                                      ctx + 1, tables, k, v)
            ctx = ctx + 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    del k, v
    torch.cuda.empty_cache()
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        # device-side events only: an aten op's own entry repeats the
        # device time of the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / steps / 1e3, ev.count // steps))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    out = {"wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy if rows else None,
           "kernels_per_step": sum(r[2] for r in rows),
           "top": [{"name": n[:80], "ms": ms, "calls": c}
                   for n, ms, c in rows[:8]]}
    log("model: decode step profile " + json.dumps(out))
    return out


def phase_engine(state):
    """GenerationServer at full width: 16 requests (prompts of 64-1536
    tokens, 64 new tokens, half greedy, half at temperature 0.8); the
    kernels' launch counts are read around this run."""
    import numpy as np
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    from paddle_tpu_torch.serving.generation import GenerationServer
    model = _model(state)
    rng = np.random.RandomState(state["seed"] + 1)
    n_req, new = 16, 64
    lens = rng.randint(64, 1537, n_req)
    prompts = [rng.randint(0, model.config.vocab_size, n) for n in lens]
    srv = GenerationServer(model, max_batch=MAX_BATCH, page_size=PAGE_SIZE,
                           device="cuda", name="smoke", start=False)
    log(f"engine: {srv.kv.num_pages} pages of {PAGE_SIZE} slots, "
        f"{srv.kv.pool_bytes() / 1e9:.2f} GB of K/V pools")
    for mod in (ca, cpa):
        mod.launches = 0
        mod.plain_calls = 0
    t0 = time.perf_counter()
    with srv:
        srv.start()
        futs = [srv.submit_generate(p, max_new_tokens=new,
                                    temperature=0.0 if i % 2 == 0 else 0.8,
                                    seed=state["seed"] + i)
                for i, p in enumerate(prompts)]
        outs = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    counts = {"flash_fwd": (ca.launches, ca.plain_calls),
              "paged_attention": (cpa.launches, cpa.plain_calls)}
    snap = srv.metrics_snapshot()
    for i, (f, toks) in enumerate(zip(futs, outs)):
        require(f.finish_reason == "length" and len(toks) == new,
                f"engine: request {i} ended {f.finish_reason} after "
                f"{len(toks)} tokens")
        require(all(0 <= t < model.config.vocab_size for t in toks),
                f"engine: request {i} emitted an out-of-vocab token")
    require(snap["kv_leak_check"]["ok"],
            f"engine: leak check {snap['kv_leak_check']}")
    for name, (launched, plain) in counts.items():
        require(launched > 0, f"engine: {name} was never launched")
        require(plain == 0, f"engine: {name}'s plain version ran {plain} "
                            f"times on the main path")
    dec = snap["step_ms"]["decode"]
    decode_tokens = snap["tokens_total"] - n_req   # the rest come from prefill
    eng = {"requests": n_req, "tokens": snap["tokens_total"], "wall_s": wall,
           "decode_tok_s": decode_tokens / (dec["mean"] * dec["count"] / 1e3),
           "tok_s_wall": snap["tokens_total"] / wall,
           "ttft_ms_p50": snap["ttft_ms"]["p50"],
           "decode_step_ms": dec, "prefill_step_ms": snap["step_ms"]["prefill"],
           "occupancy_mean": snap["batch_occupancy"]["mean"],
           "launches": {k: v[0] for k, v in counts.items()},
           "plain_calls": {k: v[1] for k, v in counts.items()}}
    state["engine"] = eng
    log("engine: " + json.dumps(eng))


def kernels_line(state) -> dict:
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_paged_attention as cpa
    out = []
    for name, mod, row in (("flash_fwd", ca, state["flash_main"]),
                           ("paged_attention", cpa, state["paged_main"])):
        out.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                    "replaces": mod.REPLACES,
                    "launches": state["engine"]["launches"][name],
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"],
                    "shape": row["case"]})
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: torch is not importable: {e}",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false; this "
              "script measures the port on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: FAIL: the paddle_tpu_torch package is not next "
              f"to this script: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    state = {"seed": args.seed}
    fns = {"card": phase_card, "build": phase_build,
           "kernels": phase_kernels, "model": phase_model,
           "engine": phase_engine}
    t_start = time.perf_counter()
    for name in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            fns[name](state)
        except Exception as e:  # noqa: BLE001 - report the phase, exit 1
            import traceback
            traceback.print_exc()
            print(f"chip_smoke: FAIL in phase {name}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            return 1
        log(f"== phase {name} done in {time.perf_counter() - t0:.1f} s")
    state["total_s"] = time.perf_counter() - t_start
    log(f"total {state['total_s']:.1f} s")
    summary = {k: state[k] for k in ("smi", "build_s", "model_check",
                                     "decode_profile", "engine", "total_s")
               if k in state}
    if "flash_main" in state and "engine" in state:
        summary.update(kernels_line(state))
        print(json.dumps({"kernels": summary["kernels"]}), flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "smoke_summary.json").write_text(json.dumps(summary, indent=1))
    log(state.get("smi", ""))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
