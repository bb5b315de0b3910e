"""Deterministic training worker for the elastic drill
(``paddle_tpu_torch.tools.faultinject``), the port of the reference's
``tests/elastic_ckpt_worker.py``.

Trains for a fixed number of steps under a ``CheckpointManager``, logging
one bitwise loss record per step. The run is a pure function of the seed
and the step index, so a run SIGKILLed at any instant and relaunched must
replay the same per-step losses after ``restore_latest()`` (optimizer
accumulators, the LR schedule, numpy's RNG and the port's generator are
all checkpointed state). Two models:

- ``--model mlp``: the reference worker's MLP (8 -> 16 -> 8, Tanh) under
  Adam with a StepDecay schedule, through the Paddle API; inputs from a
  per-step ``np.random.RandomState``, targets from numpy's global RNG and
  input noise from the port's generator. The CPU test's model.
- ``--model gpt --layers N``: ``gpt3_1p3b`` width (hidden 2048, 16 heads,
  vocabulary 50304) at N layers, stacked with recompute "full", float32
  master weights, AdamW with float32 moments under a LinearWarmup
  schedule, bf16 O2 under ``jit.TrainStep`` at b=2, s=2048; token batches
  drawn from the port's generator on the device. The card's model.

The worker runs on the GPU unless passed ``--cpu``; without a GPU and
without ``--cpu`` it exits non-zero with the device error. It runs under
``torch.use_deterministic_algorithms(True)`` (with
``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts), so an op without a
deterministic implementation raises instead of drifting between runs.

Protocol (stdout, one line each, read unbuffered by the parent)::

  FRESH | RESUMED step=<s> restore_ms=<ms> steps_lost=<n>
  STEP <k>                  after step k completes (k = completed steps)
  MIDSTEP <k>               step k's update is dispatched and the worker
                            pauses (ELASTIC_WORKER_MIDSTEP_SLEEP only)
  SAVED <k>                 the checkpoint of step k committed
  CKPT_WRITE/CKPT_COMMIT    printed by the checkpoint layer when
                            PADDLE_CKPT_TEST_SLEEP_S is set (kill windows)
  PREEMPTED step=<s> boundary_wait_s=<s> final_save_s=<s> committed=<0|1>
                            a SIGTERM's final save of step s ended, run at
                            the boundary after the step the signal landed
                            in (then the process dies of the signal)
  DONE digest=<sha256> steps=<n> launches=<fwd>,<dq>,<dkv>
       plain=<fwd>,<dq>,<dkv>
                            the run completed; ``steps`` is the steps this
                            process ran, the counts its flash kernels'
                            launches and plain-version calls

Loss log (``<ckpt_dir>/loss_log.txt``): one ``<step> <float32-hex>`` line
per executed step, appended across attempts and fsync'd.

Environment knobs (set by the parent), as the reference's:
  ELASTIC_WORKER_BLOCK=1       synchronous saves (strict steps-lost bound)
  ELASTIC_WORKER_MIDSTEP_SLEEP seconds to sleep in the middle of each
                               step, after its batch is drawn and its update
                               dispatched, before the schedule steps (a
                               SIGTERM then lands mid-step)
  ELASTIC_WORKER_SIGTERM_EXIT  install preemption handlers (default 1)

Usage::

  python -m paddle_tpu_torch.tools.elastic_ckpt_worker DIR STEPS INTERVAL \\
      [--cpu] [--model mlp|gpt] [--layers N] [--keep K]
"""
from __future__ import annotations

import argparse
import hashlib
import os
import signal
import sys
import time
from functools import partial

SEED = 71
GPT_BATCH, GPT_SEQ = 2, 2048
GPT_LR, GPT_WARMUP = 1e-4, 4


def build_mlp(device):
    """The reference worker's model, optimizer and schedule."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    paddle.set_device("cpu" if device.type == "cpu" else "gpu")
    paddle.seed(SEED)
    np.random.seed(SEED)
    model = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 8))
    sched = paddle.optimizer.lr.StepDecay(learning_rate=0.05, step_size=5,
                                          gamma=0.7)
    opt = paddle.optimizer.Adam(learning_rate=sched,
                                parameters=model.parameters())
    return model, opt, sched


def _midstep_pause(step, seconds):
    """The drill's window for a signal inside step ``step`` (counted from
    1), announced by a MIDSTEP line; inert at 0 seconds."""
    if seconds:
        sys.stdout.write(f"MIDSTEP {step}\n")
        sys.stdout.flush()
        time.sleep(seconds)


def mlp_step(model, opt, sched, step, device, pause=0.0):
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import random as pt_random
    rs = np.random.RandomState(1000 + step)
    x = rs.randn(4, 8).astype(np.float32)
    target = np.random.randn(4, 8).astype(np.float32)    # numpy's RNG
    noise = torch.randn((4, 8), generator=pt_random.default_generator()
                        .for_device(device), device=device)  # the port's
    xt = paddle.to_tensor(x + 0.01 * noise.cpu().numpy())
    out = model(xt)
    loss = ((out - paddle.to_tensor(target)) ** 2).mean()
    loss.backward()
    opt.step()
    _midstep_pause(step + 1, pause)
    opt.clear_grad()
    sched.step()
    return np.float32(float(loss))


def build_gpt(layers, device, seed=SEED):
    """``gpt3_1p3b`` width at ``layers`` layers: model, AdamW (float32
    moments) under a LinearWarmup schedule, and an O2 bf16 TrainStep."""
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_1p3b)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import LinearWarmup
    cfg = gpt3_1p3b(stacked=True, recompute="full", num_layers=layers)
    model = GPTForCausalLM(cfg, device=device, dtype=torch.float32,
                           seed=seed)
    crit = GPTPretrainingCriterion()
    sched = LinearWarmup(learning_rate=GPT_LR, warmup_steps=GPT_WARMUP,
                         start_lr=GPT_LR / 10, end_lr=GPT_LR)
    opt = AdamW(learning_rate=sched, parameters=model.named_parameters())
    step = TrainStep(model, lambda out, y: crit(out, y), opt,
                     amp_level="O2")
    return model, opt, sched, step


def gpt_batch(model, device, batch=GPT_BATCH, seq=GPT_SEQ):
    """One batch of token ids from the port's generator on ``device`` (at
    most the model's context long)."""
    import torch
    from paddle_tpu_torch.framework import random as pt_random
    seq = min(seq, model.config.max_seq_len)
    return torch.randint(0, model.config.vocab_size, (batch, seq),
                         generator=pt_random.default_generator()
                         .for_device(device), device=device)


def gpt_step(model, opt, sched, train_step, device, step, pause=0.0):
    import numpy as np
    ids = gpt_batch(model, device)
    loss = train_step(ids, ids)
    _midstep_pause(step + 1, pause)
    sched.step()
    return np.float32(float(loss))


def _tensor_bytes(v) -> bytes:
    import torch
    t = getattr(v, "_data", v)
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()
    return repr(v).encode()


def state_digest(model, opt) -> str:
    h = hashlib.sha256()
    for name, p in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(_tensor_bytes(p))
    for name, v in sorted(opt.state_dict().items()):
        h.update(name.encode())
        h.update(_tensor_bytes(v))
    return h.hexdigest()


def kernel_counts() -> tuple:
    """(launches, plain calls) of the flash forward, dq and dk/dv."""
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_attention_bwd as cab
    return ((ca.launches, *(cab.launches[k] for k in cab.KERNELS)),
            (ca.plain_calls, *(cab.plain_calls[k] for k in cab.KERNELS)))


def _install_preempt_report(handlers, mgr):
    """A SIGTERM handler for the manager's to chain to: report the final
    save of ``handlers[0]`` (the PreemptionHandler, once installed), then
    die of the signal (the conventional exit status)."""
    def report(signum, frame):
        h = handlers[0] if handlers else None
        if h is not None and h.final_save_s is not None:
            sys.stdout.write(
                f"PREEMPTED step={mgr.last_success_step} "
                f"boundary_wait_s={h.boundary_wait_s:.3f} "
                f"final_save_s={h.final_save_s:.3f} "
                f"committed={int(bool(h.final_save_ok))}\n")
            sys.stdout.flush()
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)
    signal.signal(signal.SIGTERM, report)


def _report_saved(step, handle=None):
    """The checkpoint of ``step`` committed (on the writer thread for an
    async save)."""
    if handle is None or handle.exception is None:
        sys.stdout.write(f"SAVED {step}\n")
        sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt_dir")
    ap.add_argument("steps", type=int)
    ap.add_argument("interval", type=int, nargs="?", default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the GPU)")
    ap.add_argument("--model", choices=("mlp", "gpt"), default="mlp")
    ap.add_argument("--layers", type=int, default=4,
                    help="decoder layers of --model gpt")
    ap.add_argument("--keep", type=int, default=3)
    args = ap.parse_args(argv)
    # before CUDA starts: cuBLAS then keeps its results run to run
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    from paddle_tpu_torch.elastic import CheckpointManager
    from paddle_tpu_torch.framework.device import default_device
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cpu") if args.cpu else default_device()
    block = os.environ.get("ELASTIC_WORKER_BLOCK", "0") == "1"
    pause = float(os.environ.get("ELASTIC_WORKER_MIDSTEP_SLEEP", "0"))

    if args.model == "mlp":
        model, opt, sched = build_mlp(device)
        train_step = None
    else:
        import numpy as np
        from paddle_tpu_torch.framework import random as pt_random
        pt_random.seed(SEED)     # the batches' stream; numpy's first, as
        np.random.seed(SEED)     # making the generator draws from it
        model, opt, sched, train_step = build_gpt(args.layers, device)
    mgr = CheckpointManager(args.ckpt_dir, model=model, optimizer=opt,
                            save_interval_steps=args.interval,
                            keep=args.keep, async_save=not block,
                            health_check=False)
    res = mgr.restore_latest()
    if res is None:
        start = 0
        print("FRESH", flush=True)
    else:
        start = res.step
        print(f"RESUMED step={res.step} restore_ms={res.restore_ms:.1f} "
              f"steps_lost={res.steps_lost}", flush=True)
    if os.environ.get("ELASTIC_WORKER_SIGTERM_EXIT", "1") == "1":
        handlers = []
        _install_preempt_report(handlers, mgr)
        handlers.append(mgr.install_preemption_handlers())

    log = open(os.path.join(args.ckpt_dir, "loss_log.txt"), "a")
    for step in range(start, args.steps):
        if train_step is None:
            loss32 = mlp_step(model, opt, sched, step, device, pause)
        else:
            loss32 = gpt_step(model, opt, sched, train_step, device, step,
                              pause)
        log.write(f"{step} {loss32.tobytes().hex()}\n")
        log.flush()
        os.fsync(log.fileno())
        handle = mgr.step(step + 1)
        if handle is not None:
            handle.add_done_callback(partial(_report_saved, step + 1))
        elif mgr.last_success_step == step + 1:     # a synchronous save
            _report_saved(step + 1)
        # one write: the async writer thread also prints markers
        sys.stdout.write(f"STEP {step + 1}\n")
        sys.stdout.flush()
    mgr.save(args.steps, block=True, reason="final")
    mgr.close()
    launches, plain = kernel_counts()
    print(f"DONE digest={state_digest(model, opt)} "
          f"steps={args.steps - start} "
          f"launches={','.join(map(str, launches))} "
          f"plain={','.join(map(str, plain))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
