"""Port parity: the continuous-batching GenerationServer
(paddle_tpu_torch/serving/generation/engine.py) against the JAX package's
GenerationServer(prefix_cache=False) at ``gpt_tiny`` in float32 on the CPU,
with the same weights (load_jax_state): greedy and seeded-temperature
streams must be token-for-token identical. Then the engine's own contract:
eos, cancel, backpressure, deadlines, shutdown, the fault barrier, page
accounting, and the device rule.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import gpt_tiny as j_gpt_tiny
from paddle_tpu.serving.generation import GenerationServer as JServer
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.serving import (DeadlineExceededError, QueueFullError,
                                      ServerClosedError)
from paddle_tpu_torch.serving.generation import (CachedDecoder,
                                                 GenerationServer)

PROMPT_LENS = [3, 7, 12, 5, 20, 9]
MAX_NEW = [6, 10, 4, 8, 5, 7]
TEMPS = [0.0, 0.8, 0.0, 1.0, 0.0, 0.7]


def make_pair(seed=0):
    paddle.seed(seed)
    jm = JGPT(j_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    load_jax_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(1, 256, n).tolist() for n in PROMPT_LENS]


def _serve(srv, prompts, **kw):
    """Submit every request before the worker starts, so the first
    max_batch are admitted together and the rest join mid-flight."""
    with srv:
        futs = [srv.submit_generate(p, max_new_tokens=n, temperature=t,
                                    seed=100 + i, **kw)
                for i, (p, n, t) in enumerate(zip(prompts, MAX_NEW, TEMPS))]
        srv.start()
        out = [f.result(timeout=120) for f in futs]
        reasons = [f.finish_reason for f in futs]
    return out, reasons


def test_streams_match_reference_engine():
    jm, tm = make_pair()
    prompts = _prompts()
    want, want_r = _serve(JServer(jm, max_batch=4, page_size=8,
                                  prefix_cache=False, name="jref",
                                  start=False), prompts)
    srv = GenerationServer(tm, max_batch=4, page_size=8, device="cpu",
                           name="port", start=False)
    got, got_r = _serve(srv, prompts)
    assert got == want
    assert got_r == want_r == ["length"] * len(prompts)
    assert [len(t) for t in got] == MAX_NEW
    assert srv.leak_check()["ok"]
    snap = srv.metrics_snapshot()
    assert snap["tokens_total"] == sum(MAX_NEW)
    assert snap["counters"]["completed"] == len(prompts)
    assert snap["kv_pages"]["used"] == 0 and snap["kv_leak_check"]["ok"]
    assert snap["step_ms"]["decode"]["count"] == snap["decode_steps"] > 0
    assert snap["ttft_ms"]["count"] == len(prompts)
    assert 1.0 <= snap["batch_occupancy"]["mean"] <= 4.0


def test_eos_matches_reference_engine():
    jm, tm = make_pair()
    prompts = _prompts()
    greedy, _ = _serve(GenerationServer(tm, max_batch=4, page_size=8,
                                        device="cpu", start=False), prompts)
    eos = greedy[0][2]          # a token request 0 emits at step 3
    want, want_r = _serve(JServer(jm, max_batch=4, page_size=8,
                                  prefix_cache=False, eos_token_id=eos,
                                  name="jeos", start=False), prompts)
    srv = GenerationServer(tm, max_batch=4, page_size=8, eos_token_id=eos,
                           device="cpu", start=False)
    got, got_r = _serve(srv, prompts)
    assert got == want and got_r == want_r
    assert got_r[0] == "eos" and got[0][-1] == eos and len(got[0]) <= 3
    assert srv.leak_check()["ok"]


def test_streaming_iteration_matches_result():
    _, tm = make_pair()
    with GenerationServer(tm, max_batch=2, page_size=8,
                          device="cpu") as srv:
        fut = srv.submit_generate([9, 8, 7], max_new_tokens=7)
        streamed = list(fut)
        assert streamed == fut.result(timeout=60) and len(streamed) == 7
        assert fut.done() and fut.exception() is None


def test_cancel_mid_stream_frees_pages():
    _, tm = make_pair()
    with GenerationServer(tm, max_batch=2, page_size=8,
                          device="cpu") as srv:
        fut = srv.submit_generate([5, 6, 7], max_new_tokens=100)
        deadline = time.monotonic() + 60
        while len(fut.tokens()) < 2 and time.monotonic() < deadline:
            time.sleep(0.002)
        assert fut.cancel()
        toks = fut.result(timeout=60)
        assert fut.finish_reason == "cancelled" and fut.cancelled()
        assert 2 <= len(toks) < 100
        assert not fut.cancel()                 # already finished
        # the engine keeps serving after the eviction
        assert len(srv.generate([1, 2], max_new_tokens=3)) == 3
        assert srv.leak_check()["ok"]
        assert srv.metrics_snapshot()["counters"]["cancelled"] == 1


def test_queue_full_then_shutdown_without_drain():
    _, tm = make_pair()
    set_flags({"FLAGS_decode_queue_capacity": 2})
    try:
        srv = GenerationServer(tm, max_batch=2, page_size=8, device="cpu",
                               start=False)
    finally:
        set_flags({"FLAGS_decode_queue_capacity": 64})
    assert srv.queue_capacity == 2
    futs = [srv.submit_generate([1, 2, 3], max_new_tokens=4)
            for _ in range(2)]
    with pytest.raises(QueueFullError):
        srv.submit_generate([1, 2, 3], max_new_tokens=4)
    srv.shutdown(drain=False)
    for f in futs:
        with pytest.raises(ServerClosedError):
            f.result(timeout=10)
        assert f.finish_reason == "shutdown"
    with pytest.raises(ServerClosedError):
        srv.submit_generate([1], max_new_tokens=1)
    snap = srv.metrics_snapshot()
    assert snap["counters"]["rejected"] == 1
    assert snap["counters"]["failed"] == 2 and srv.leak_check()["ok"]


def test_deadlines_and_validation():
    _, tm = make_pair()
    srv = GenerationServer(tm, max_batch=2, page_size=8, device="cpu",
                           start=False)
    late = srv.submit_generate([1, 2], max_new_tokens=3, timeout_ms=1)
    time.sleep(0.02)
    real = srv.decoder.decode

    def slow(*a, **kw):         # >= 10 ms a step: 100 steps outlast 200 ms
        time.sleep(0.01)
        return real(*a, **kw)

    srv.decoder.decode = slow
    with srv:
        srv.start()
        with pytest.raises(DeadlineExceededError):
            late.result(timeout=30)
        assert late.finish_reason == "timed_out"
        hard = srv.submit_generate([3, 4], max_new_tokens=100,
                                   deadline_ms=200)
        with pytest.raises(DeadlineExceededError):
            hard.result(timeout=60)
        assert hard.finish_reason == "deadline"
        assert 0 < len(hard.tokens()) < 100
        with pytest.raises(ValueError):
            srv.submit_generate([], max_new_tokens=1)
        with pytest.raises(ValueError):
            srv.submit_generate(list(range(128)), max_new_tokens=1)
        with pytest.raises(ValueError):
            srv.submit_generate([1], max_new_tokens=0)
    assert srv.leak_check()["ok"]


def test_fault_barrier_fails_batch_not_engine():
    _, tm = make_pair()
    with GenerationServer(tm, max_batch=2, page_size=8,
                          device="cpu") as srv:
        real = srv.decoder.decode
        calls = {"n": 0}

        def flaky(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected decode fault")
            return real(*a, **kw)

        srv.decoder.decode = flaky
        bad = srv.submit_generate([1, 2, 3], max_new_tokens=5)
        with pytest.raises(RuntimeError, match="injected"):
            bad.result(timeout=60)
        assert bad.finish_reason == "error"
        assert len(srv.generate([4, 5], max_new_tokens=4)) == 4
        assert srv.leak_check()["ok"]


def test_unported_features_raise():
    _, tm = make_pair()
    with pytest.raises(NotImplementedError, match="prefix"):
        GenerationServer(tm, device="cpu", prefix_cache=True, start=False)
    with pytest.raises(NotImplementedError, match="speculative"):
        GenerationServer(tm, device="cpu", draft_model=tm, start=False)


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    _, tm = make_pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(gpt_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CachedDecoder(tm, max_batch=1, page_size=8, pages_per_seq=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationServer(tm, start=False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        GenerationServer(tm, device="cuda", start=False)
