"""Port parity: the shared-prefix radix index and speculative decoding's
accept/resample (paddle_tpu_torch/serving/generation/{prefix_cache,
spec_decode}.py) against the JAX package's, and the engine's page
lifecycle with the prefix cache on (refcounts, sharing, eviction under pool
pressure, invalidation) on ``gpt_tiny`` in float32 on the CPU.

The index tests drive both packages' ``PrefixCache`` over their own
``PagedKVCache`` through one sequence of match/publish/evict/clear calls
and require equal results, stats and page accounting at every step (the
sequence mirrors ``tests/test_prefix_spec.py``). ``accept_tokens`` gets the
same logits and a RandomState of the same seed in both packages and must
emit the same tokens and leave the RNG in the same state.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import gpt_tiny as j_gpt_tiny
from paddle_tpu.serving.generation import GenerationServer as JServer
from paddle_tpu.serving.generation import PagedKVCache as JKV
from paddle_tpu.serving.generation import PrefixCache as JPrefix
from paddle_tpu.serving.generation import accept_tokens as j_accept
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.serving.generation import (GenerationServer,
                                                 PagedKVCache, PrefixCache,
                                                 accept_tokens)
from test_torch_flags import pin_kv_dtype  # noqa: F401


def make_pair(seed=0):
    paddle.seed(seed)
    jm = JGPT(j_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    load_jax_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


# ------------------------------------------------------------ radix index
class _Both:
    """One index per package over its own allocator; every call goes to
    both and must agree, results, stats and accounting alike."""

    def __init__(self, num_pages=10, page_size=4):
        jm, tm = make_pair()
        self.jkv = JKV(jm, num_pages=num_pages, page_size=page_size)
        self.tkv = PagedKVCache(tm, num_pages=num_pages, page_size=page_size)
        self.j = JPrefix(self.jkv)
        self.t = PrefixCache(self.tkv)

    def __call__(self, method, *args, **kw):
        want = getattr(self.j, method)(*args, **kw)
        got = getattr(self.t, method)(*args, **kw)
        assert got == want, (method, args, got, want)
        self.check()
        return got

    def kv(self, method, *args):
        want = getattr(self.jkv, method)(*args)
        got = getattr(self.tkv, method)(*args)
        assert got == want, (method, args, got, want)
        self.check()
        return got

    def check(self):
        assert self.t.stats() == self.j.stats()
        assert len(self.t) == len(self.j)
        assert self.tkv.free_pages == self.jkv.free_pages
        assert self.tkv._ref == self.jkv._ref
        assert self.tkv.leak_check() == self.jkv.leak_check()


def test_match_is_page_aligned_and_strict():
    b = _Both()
    pages = b.kv("alloc", 3)
    toks = list(range(12))
    assert b("publish", toks, pages, n_tokens=12) == 3
    assert b("match", toks) == (8, pages[:2])          # strict: < len
    assert b("match", toks + [99]) == (12, pages[:3])
    toks2 = toks[:4] + [77] + toks[5:]
    assert b("match", toks2 + [99]) == (4, pages[:1])
    assert b("match", toks[:3]) == (0, [])             # sub-page prompt
    b("note_admission", 8)
    b("note_admission", 0)


def test_first_writer_wins_on_duplicate_content():
    b = _Both()
    a = b.kv("alloc", 1)
    c = b.kv("alloc", 1)
    assert b("publish", [1, 2, 3, 4], a, n_tokens=4) == 1
    assert b("publish", [1, 2, 3, 4], c, n_tokens=4) == 0
    assert b.tkv.refcount(a[0]) == 2 and b.tkv.refcount(c[0]) == 1
    assert b("match", [1, 2, 3, 4, 9]) == (4, a)


def test_lru_leaf_first_eviction_pinning_and_clear():
    b = _Both()
    pages = b.kv("alloc", 3)
    toks = list(range(12))
    b("publish", toks, pages, n_tokens=12)
    b.kv("release", pages)                # the sequence is done
    pages2 = b.kv("alloc", 1)
    b("publish", [50, 51, 52, 53], pages2, n_tokens=4)
    b.kv("release", pages2)
    assert b("evict", 1) == 1             # the first chain's leaf
    assert b("match", toks + [99]) == (8, pages[:2])
    assert b("match", [50, 51, 52, 53, 9])[0] == 4
    b.kv("retain", pages[:2])             # pinned by a live sequence
    assert b("evict", 10) == 1            # only the unpinned chain
    b.kv("release", pages[:2])
    assert b("evict", 10) == 2
    assert b.tkv.free_pages == b.tkv.capacity
    more = b.kv("alloc", 2)
    b("publish", list(range(8)), more, n_tokens=8)
    assert b("clear") == 0                # still held by their owner
    b.kv("release", more)
    b.tkv.assert_no_leaks()


# --------------------------------------------------------- accept/resample
def _logits(seed, k, v=12, peaked=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(k + 1, v)
    if peaked:
        x *= 4.0
    return x


def _both_accept(logits, draft, probs, temp, seed, **kw):
    rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
    want = j_accept(logits, draft, probs, temp, rj, **kw)
    got = accept_tokens(logits, draft, probs, temp, rt, **kw)
    assert got == want
    assert rt.random_sample() == rj.random_sample()     # same draws made
    return got


@pytest.mark.parametrize("seed", range(4))
def test_accept_tokens_greedy_walk_eos_and_cap(seed):
    logits = _logits(seed, 4)
    arg = logits.argmax(-1)
    # every proposal accepted: k plus the bonus token
    toks, acc = _both_accept(logits, arg[:4].copy(), None, 0.0, seed,
                             max_emit=10)
    assert toks == list(arg) and acc == 4
    # a mismatch at proposal 2 emits the target's argmax and stops
    bad = arg[:4].copy()
    bad[1] = (bad[1] + 1) % 12
    toks, acc = _both_accept(logits, bad, None, 0.0, seed, max_emit=10)
    assert toks == list(arg[:2]) and acc == 1
    _both_accept(logits, arg[:4].copy(), None, 0.0, seed, max_emit=2)
    _both_accept(logits, arg[:4].copy(), None, 0.0, seed, max_emit=10,
                 eos_token_id=int(arg[1]))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("temp", [0.7, 1.3])
def test_accept_tokens_sampled_step_matches_reference(seed, temp):
    """Sampled accept-and-resample: the same RNG draws in the same order,
    so the same tokens, for a draft that agrees, one that does not, and a
    cap and an eos inside the walk."""
    k, v = 3, 12
    logits = _logits(seed, k, v, peaked=False)
    rng = np.random.RandomState(100 + seed)
    dl = rng.randn(k, v)
    probs = np.exp(dl / temp)
    probs /= probs.sum(-1, keepdims=True)
    draft = np.array([rng.choice(v, p=p) for p in probs])
    _both_accept(logits, draft, probs, temp, seed, max_emit=10)
    _both_accept(logits, draft, probs, temp, seed, max_emit=1)
    _both_accept(logits, draft, probs, temp, seed, max_emit=10,
                 eos_token_id=int(draft[0]))
    # a draft identical to the target accepts with probability 1
    tp = np.exp(logits[:k] / temp - (logits[:k] / temp).max(-1,
                                                             keepdims=True))
    tp /= tp.sum(-1, keepdims=True)
    toks, acc = _both_accept(logits, draft, tp, temp, seed, max_emit=10)
    assert acc == k and len(toks) == k + 1


def test_accept_single_step_distribution_is_the_targets():
    """The Leviathan identity: accept-or-resample over a draft distribution
    gives the TARGET distribution, draw for draw as the reference."""
    rng_t, rng_j = np.random.RandomState(0), np.random.RandomState(0)
    p_target = np.array([0.6, 0.3, 0.1])
    p_draft = np.array([0.2, 0.5, 0.3])
    t_logits = np.log(p_target)[None, :].repeat(2, 0)
    counts = np.zeros(3)
    n = 3000
    for _ in range(n):
        d = int(rng_t.choice(3, p=p_draft))
        assert d == int(rng_j.choice(3, p=p_draft))
        got, _ = accept_tokens(t_logits, np.array([d]), p_draft[None, :],
                               1.0, rng_t, max_emit=1)
        want, _ = j_accept(t_logits, np.array([d]), p_draft[None, :], 1.0,
                           rng_j, max_emit=1)
        assert got == want
        counts[got[0]] += 1
    np.testing.assert_allclose(counts / n, p_target, atol=0.03)


# ------------------------------------------------ engine page lifecycle
def test_admit_share_finish_evict_leaves_zero_leaks():
    _, tm = make_pair()
    rng = np.random.RandomState(2)
    pre = list(rng.randint(0, 256, 24))
    with GenerationServer(tm, max_batch=4, page_size=8, device="cpu",
                          name="leak") as srv:
        futs = [srv.submit_generate(pre + [i], max_new_tokens=6)
                for i in range(6)]
        for f in futs:
            f.result(timeout=120)
        snap = srv.metrics_snapshot()
        # the first admission round prefills cold (pages publish after the
        # write), so the late joiners share, with sequences in flight
        assert snap["prefix"]["hits"] >= 2
        assert snap["prefix"]["tokens_reused"] == \
            24 * snap["prefix"]["hits"]
        assert snap["kv_leak_check"]["ok"] and srv.active_sequences == 0
        srv.kv.assert_no_leaks()
        cached = srv.prefix.cached_pages
        assert cached > 0
        assert srv.kv.free_pages == srv.kv.capacity - cached
        assert srv.clear_prefix_cache() == cached
        assert srv.kv.free_pages == srv.kv.capacity


def test_cache_eviction_under_pool_pressure_matches_reference():
    """A pool for ONE sequence: completed pages stay cached until the next
    admission reclaims them, LRU; the streams equal the reference engine's
    under the same pressure."""
    jm, tm = make_pair()
    p1, p2 = [5, 7, 9, 2, 8], [8, 6, 4, 1, 3]
    outs = []
    for srv in (JServer(jm, max_batch=2, page_size=4, num_pages=4,
                        max_seq_len=12, name="jpressure"),
                GenerationServer(tm, max_batch=2, page_size=4, num_pages=4,
                                 max_seq_len=12, device="cpu",
                                 name="pressure")):
        with srv:
            a = srv.generate(p1, max_new_tokens=6)
            cached = srv.prefix.cached_pages
            b = srv.generate(p2, max_new_tokens=6)
            outs.append((a, b, cached, srv.prefix.stats()))
            assert srv.metrics_snapshot()["kv_leak_check"]["ok"]
    assert outs[1] == outs[0]
    assert outs[1][2] > 0 and outs[1][3]["pages_evicted"] >= 1


def test_refresh_params_invalidates_prefix_cache():
    _, tm = make_pair()
    pre = list(np.random.RandomState(8).randint(0, 256, 16))
    with GenerationServer(tm, max_batch=2, page_size=8, device="cpu",
                          name="swap") as srv:
        srv.generate(pre + [1], max_new_tokens=4)
        assert srv.prefix.cached_pages > 0
        with torch.no_grad():
            tm.gpt.embeddings.word_embeddings.weight.mul_(0.7)
        srv.refresh_params()
        assert srv.prefix.cached_pages == 0
        got = srv.generate(pre + [1], max_new_tokens=4)
        assert srv.metrics_snapshot()["prefix"]["hits"] == 0
    with GenerationServer(tm, max_batch=2, page_size=8, device="cpu",
                          prefix_cache=False, name="fresh") as ref:
        assert got == ref.generate(pre + [1], max_new_tokens=4)


def test_prefix_cache_off_keeps_legacy_accounting():
    _, tm = make_pair()
    with GenerationServer(tm, max_batch=2, page_size=4, device="cpu",
                          prefix_cache=False, name="off") as srv:
        srv.generate([5, 7, 9, 1, 2, 6], max_new_tokens=6)
        assert srv.prefix is None
        assert srv.kv.free_pages == srv.kv.capacity
        snap = srv.metrics_snapshot()
        assert snap["prefix"]["hits"] == 0 and snap["kv_leak_check"]["ok"]


def test_spec_engine_validation():
    _, tm = make_pair()
    short = GPTForCausalLM(gpt_tiny(max_seq_len=32), device="cpu", seed=9)
    with pytest.raises(ValueError, match="max_seq_len"):
        GenerationServer(tm, max_batch=2, page_size=8, draft_model=short,
                         spec_k=2, device="cpu", start=False)
    with pytest.raises(TypeError, match="draft_model"):
        GenerationServer(tm, max_batch=2, page_size=8,
                         draft_model=torch.nn.Linear(2, 2), spec_k=2,
                         device="cpu", start=False)
    # a draft without spec_k (flag default 0) leaves speculation off
    srv = GenerationServer(tm, max_batch=2, page_size=8, draft_model=tm,
                           device="cpu", start=False)
    assert srv.spec_k == 0 and srv.draft is None
