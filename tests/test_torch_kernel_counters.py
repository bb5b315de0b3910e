"""The kernel wrappers' counters are exact under threads.

Replicas served from threads of one process (``ThreadReplicaFactory``, the
fleet's single-process mode) call the kernel wrappers at once; each module
(``ops/cuda_attention.py``, ``cuda_paged_attention.py``,
``cuda_attention_bwd.py``) updates its ``launches``, ``plain_calls`` and
``flops`` under one lock of its own (``COUNT_LOCK``). Here 8 threads call
each wrapper on CPU tensors (the plain route) and the plain-call count must
come out exact; the counters are restored after.
"""
import threading

import pytest
import torch

from paddle_tpu_torch.ops import cuda_attention as ca
from paddle_tpu_torch.ops import cuda_attention_bwd as cab
from paddle_tpu_torch.ops import cuda_paged_attention as cpa

THREADS, CALLS = 8, 40


def _flash_fwd():
    q = torch.randn(1, 4, 2, 8)
    return lambda: ca.flash_attention_fwd(q, q, q, causal=True)


def _flash_bwd():
    q = torch.randn(1, 4, 2, 8)
    out, lse = ca.mha_fwd_reference(q, q, q, causal=True)
    return lambda: cab.flash_attention_bwd(q, q, q, out, lse, q, causal=True)


def _paged():
    q = torch.randn(1, 1, 2, 8)
    pool = torch.randn(3, 4, 2, 8)
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    ctx = torch.tensor([6], dtype=torch.int32)
    valid = torch.ones(1, 1, dtype=torch.bool)
    pos = torch.tensor([[5]], dtype=torch.int32)
    return lambda: cpa.paged_attention(q, pool, pool, tables, ctx, valid,
                                       pos, page_size=4, kind="decode",
                                       scale=0.35)


CASES = {"flash_fwd": (ca, _flash_fwd), "flash_bwd": (cab, _flash_bwd),
         "paged_attention": (cpa, _paged)}


def _plain(mod):
    return dict(mod.plain_calls) if isinstance(mod.plain_calls, dict) \
        else mod.plain_calls


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_calls_count_exactly_from_eight_threads(name):
    mod, make = CASES[name]
    assert isinstance(mod.COUNT_LOCK, type(threading.Lock()))
    call = make()
    before = _plain(mod)
    start = threading.Barrier(THREADS)

    def worker():
        start.wait()
        for _ in range(CALLS):
            call()

    threads = [threading.Thread(target=worker) for _ in range(THREADS)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        after = _plain(mod)
        n = THREADS * CALLS
        if isinstance(before, dict):
            assert after == {k: v + n for k, v in before.items()}
        else:
            assert after == before + n
    finally:
        if isinstance(before, dict):
            mod.plain_calls.update(before)
        else:
            mod.plain_calls = before
