"""One rank of a data-parallel job started by the port's launcher::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        paddle_tpu_torch/tools/dp_worker.py --out DIR [--cpu] ...

Each rank initializes the process group (``init_parallel_env``; the
backend rule picks NCCL, or gloo when ranks share a card), then:

- ``--collectives``: runs every eager collective once on tensors on its
  device (``run_collectives``) and checks each against numpy
  (``expected_collectives``: every rank's inputs are a function of its
  rank); the results go to ``DIR/collectives.<rank>.npz``;
- trains GPT (``--model tiny`` or ``1p3b``, the latter at ``gpt3_1p3b``'s
  width with ``--layers`` layers) wrapped in ``DataParallel``, under O2
  (``--amp O2``, bf16) or in float32, with AdamW, for ``--steps`` steps on
  its rows of one seeded ``--batch`` x ``--seq`` batch: first one
  forward and backward alone at the initial weights, whose averaged
  gradient rank 0 saves (``DIR/grad0.pt``, float32), then the steps, each
  followed by an ``all_gather`` of a sha256 of every parameter's bytes;
  rank 0 saves the final parameters (``DIR/params.pt``);
- writes ``DIR/rank<rank>.json``: the backend, its device, the checksums
  and whether the ranks agreed after each step, the losses, the step
  times, the collectives' verdicts, and the flash kernels' launches and
  plain calls over the steps.

The parent compares ``grad0.pt`` and ``params.pt`` with the same steps
taken in one process on the whole batch (``single_process``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

SEED = 7
LR = 1e-4


def collective_inputs(rank: int, n: int, shape=(4, 6)) -> np.ndarray:
    """Rank ``rank``'s float32 input: distinct per rank, exact in float32
    sums and products."""
    base = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    return (base % 7 + rank + 1).astype(np.float32)


def _np_reduce(stacked, op):
    from ..distributed.communication.collective import _np_reduce as red
    return red(stacked, op)


def expected_collectives(n: int, rank: int, reduce_fn=None) -> dict:
    """What ``run_collectives`` must give rank ``rank`` of ``n``, from numpy
    (``reduce_fn(stacked, op)``, default: the port's copy of the
    reference's ``_np_reduce``)."""
    reduce_fn = reduce_fn or _np_reduce
    xs = np.stack([collective_inputs(r, n) for r in range(n)])
    out = {}
    for op in ("sum", "max", "min", "prod", "avg"):
        out[f"all_reduce_{op}"] = reduce_fn(xs, op).astype(np.float32)
    out["reduce"] = reduce_fn(xs, "sum").astype(np.float32)
    out["all_gather"] = xs
    out["broadcast"] = xs[n - 1]
    total = reduce_fn(np.stack([np.concatenate([x] * n) for x in xs]),
                      "sum")
    rows = total.shape[0] // n
    out["reduce_scatter"] = total[rank * rows:(rank + 1) * rows]
    # all_to_all: member j sends its block i to member i
    out["all_to_all"] = np.stack([xs[j] * (rank + 1) for j in range(n)])
    out["all_to_all_single"] = np.concatenate(
        [np.full((2, 3), 10 * j + rank, np.float32) for j in range(n)])
    out["scatter"] = np.full((2, 3), 100 + rank, np.float32)
    out["gather"] = xs if rank == 0 else np.zeros((0,), np.float32)
    out["send_recv"] = xs[(rank - 1) % n]
    out["batch_isend_irecv"] = xs[(rank - 1) % n] * 2
    out["all_gather_object"] = np.arange(n, dtype=np.float32)
    out["broadcast_object_list"] = np.array([float(n - 1)], np.float32)
    out["scatter_object_list"] = np.array([float(rank * 3)], np.float32)
    return out


def run_collectives(device) -> dict:
    """Every eager collective once, on tensors on ``device``; returns
    ``{name: numpy result}`` in the keys of ``expected_collectives``."""
    import torch

    import paddle_tpu_torch.distributed as dist
    rank, n = dist.get_rank(), dist.get_world_size()

    def mine():
        return torch.from_numpy(collective_inputs(rank, n)).to(device)

    out = {}
    for op in ("sum", "max", "min", "prod", "avg"):
        t = mine()
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()))
        out[f"all_reduce_{op}"] = t.cpu().numpy()
    t = mine()
    dist.reduce(t, dst=0)
    out["reduce"] = t.cpu().numpy()
    lst = []
    dist.all_gather(lst, mine())
    out["all_gather"] = torch.stack(lst).cpu().numpy()
    t = mine()
    dist.broadcast(t, src=n - 1)
    out["broadcast"] = t.cpu().numpy()
    t = torch.empty_like(mine())
    dist.reduce_scatter(t, [mine() for _ in range(n)])
    out["reduce_scatter"] = t.cpu().numpy()
    lst = []
    dist.all_to_all(lst, [mine() * (j + 1) for j in range(n)])
    out["all_to_all"] = torch.stack(lst).cpu().numpy()
    src = torch.cat([torch.full((2, 3), 10 * rank + j, dtype=torch.float32,
                                device=device) for j in range(n)])
    dst = torch.empty_like(src)
    dist.all_to_all_single(dst, src)
    out["all_to_all_single"] = dst.cpu().numpy()
    t = torch.empty(2, 3, device=device)
    parts = [torch.full((2, 3), 100.0 + j, device=device) for j in range(n)]
    dist.scatter(t, parts if rank == 0 else None, src=0)
    out["scatter"] = t.cpu().numpy()
    lst = []
    dist.gather(mine(), lst if rank == 0 else None, dst=0)
    out["gather"] = torch.stack(lst).cpu().numpy() if lst else \
        np.zeros((0,), np.float32)
    t = torch.empty_like(mine())
    if rank % 2 == 0:
        dist.send(mine(), dst=(rank + 1) % n)
        dist.recv(t, src=(rank - 1) % n)
    else:
        dist.recv(t, src=(rank - 1) % n)
        dist.send(mine(), dst=(rank + 1) % n)
    out["send_recv"] = t.cpu().numpy()
    t = torch.empty_like(mine())
    tasks = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, mine() * 2, (rank + 1) % n),
        dist.P2POp(dist.irecv, t, (rank - 1) % n)])
    for task in tasks:
        task.wait()
    out["batch_isend_irecv"] = t.cpu().numpy()
    objs = []
    dist.all_gather_object(objs, {"rank": rank})
    out["all_gather_object"] = np.array([o["rank"] for o in objs],
                                        np.float32)
    box = [rank]
    dist.broadcast_object_list(box, src=n - 1)
    out["broadcast_object_list"] = np.array([float(box[0])], np.float32)
    got = []
    dist.scatter_object_list(got, [j * 3 for j in range(n)]
                             if rank == 0 else None, src=0)
    out["scatter_object_list"] = np.array([float(got[0])], np.float32)
    dist.barrier()
    return out


def check_collectives(got: dict, want: dict) -> dict:
    """``{name: True/False}``: exact agreement (the inputs are integers in
    float32)."""
    return {k: bool(got[k].shape == want[k].shape and
                    np.array_equal(got[k], want[k])) for k in want}


def _checksum(model) -> str:
    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def build(args, device, use_kernels=True):
    """Model, criterion and config for this job (``use_kernels=False``:
    attention through the kernels' plain versions)."""
    import torch

    from ..models import (GPTForCausalLM, GPTPretrainingCriterion,
                          gpt3_1p3b, gpt_tiny)
    if args.model == "1p3b":
        cfg = gpt3_1p3b(num_layers=args.layers, max_seq_len=args.seq)
    else:
        cfg = gpt_tiny(num_layers=args.layers, max_seq_len=args.seq)
    model = GPTForCausalLM(cfg, device=device, dtype=torch.float32,
                           seed=SEED)
    for m in model.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = use_kernels
    crit = GPTPretrainingCriterion()
    return model, crit, cfg


def batch(cfg, args, device):
    """The whole seeded batch ``[batch, seq]`` of token ids."""
    import torch
    rng = np.random.RandomState(SEED)
    ids = rng.randint(0, cfg.vocab_size, (args.batch, args.seq))
    return torch.from_numpy(ids).to(device)


def train(model, crit, ids, args, on_step=None):
    """The gradient at the initial weights (float32, flat by name), then
    ``args.steps`` AdamW steps; returns (grad0, losses, step seconds)."""
    import torch

    from ..jit import TrainStep
    from ..optimizer import AdamW
    amp = "O2" if args.amp == "O2" else None
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters())
    step = TrainStep(model, lambda out, y: crit(out, y), opt,
                     amp_level=amp)
    # the gradient at the initial weights, alone
    from ..amp import auto_cast
    with auto_cast(enable=amp is not None, level=amp or "O1"):
        loss = crit(model(ids), ids)
    loss.backward()
    # by the wrapped model's names (a DataParallel's are under _layers.)
    grad0 = {n.removeprefix("_layers."): p.grad.detach().float().cpu()
             .clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    losses, secs = [], []
    for i in range(args.steps):
        if ids.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, ids)
        losses.append(float(loss))
        if ids.is_cuda:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if on_step is not None:
            on_step(i)
    return grad0, losses, secs


def single_process(args, device, use_kernels=True):
    """The same job in one process on the whole batch: (model, grad0,
    losses)."""
    model, crit, cfg = build(args, device, use_kernels)
    grad0, losses, _ = train(model, crit, batch(cfg, args, device), args)
    return model, grad0, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--model", default="tiny", choices=("tiny", "1p3b"))
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--amp", default="none", choices=("none", "O2"))
    ap.add_argument("--collectives", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import paddle_tpu_torch.distributed as dist
    from ..ops import cuda_attention as ca
    from ..ops import cuda_attention_bwd as cab
    if args.cpu:
        torch.set_num_threads(2)
    penv = dist.init_parallel_env()
    rank, n = dist.get_rank(), dist.get_world_size()
    device = torch.device("cpu") if args.cpu else penv.device
    os.makedirs(args.out, exist_ok=True)
    res = {"rank": rank, "world": n, "backend": penv.backend,
           "device": str(device)}
    if args.collectives:
        got = run_collectives(device)
        res["collectives"] = check_collectives(
            got, expected_collectives(n, rank))
        np.savez(os.path.join(args.out, f"collectives.{rank}.npz"), **got)

    model, crit, cfg = build(args, device)
    model = dist.DataParallel(model)
    ids = batch(cfg, args, device)
    rows = args.batch // n
    mine = ids[rank * rows:(rank + 1) * rows]
    sums = []

    def agree(i):
        objs = []
        dist.all_gather_object(objs, _checksum(model._layers))
        sums.append(objs)

    ca.launches = ca.plain_calls = 0
    for k in cab.KERNELS:
        cab.launches[k] = cab.plain_calls[k] = 0
    grad0, losses, secs = train(model, crit, mine, args, on_step=agree)
    res.update(
        checksums=sums, equal_after_each_step=[len(set(s)) == 1
                                               for s in sums],
        losses=losses, step_s=secs, reductions=model.reductions,
        launches={"flash_fwd": ca.launches, **dict(cab.launches)},
        plain_calls={"flash_fwd": ca.plain_calls, **dict(cab.plain_calls)})
    if rank == 0:
        torch.save(grad0, os.path.join(args.out, "grad0.pt"))
        torch.save({k: v.detach().float().cpu() for k, v in
                    model._layers.state_dict().items()},
                   os.path.join(args.out, "params.pt"))
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    if __package__ in (None, ""):
        # run as a script by the launcher: import as the package's module
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
        from paddle_tpu_torch.tools.dp_worker import main as _main
        sys.exit(_main())
    sys.exit(main())
