"""Shadow checks of the paged kernels against their plain versions
(``CachedDecoder._shadow``, ``observability/numerics.py``), on the CPU.

- the shadow check on the ``CachedDecoder``'s decode, chunked and verify
  calls, over float and int8 pools, leaves outputs, pools and block tables
  bit for bit as without it, runs one plain call a layer and publishes a
  divergence of 0 (on the CPU both routes are the plain versions);
- the engine (prefix cache, self-speculation) with the plane on (every
  call shadowed and tripwired) gives streams, pools, prefix cache and
  generator bit for bit as with it off, over float and int8 pools, and
  streams token for token the reference engine's with its plane on.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.observability import numerics as jnum
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.observability import numerics as pnum
from paddle_tpu_torch.ops import cuda_paged_attention as cpa
from test_torch_engine_parity import _prompts, _serve, make_pair
from test_torch_flags import kv_dtype_flag, pin_kv_dtype  # noqa: F401
from test_torch_obs_numerics import _set_both, fresh_numerics  # noqa: F401


def _decoder_state(kv_dtype):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.serving.generation.model_fns import CachedDecoder
    prandom.seed(0)
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    m.eval()
    b, ps, pps = 3, 4, 6
    dec = CachedDecoder(m, max_batch=b, page_size=ps, pages_per_seq=pps,
                        kv_dtype=kv_dtype, device="cpu")
    k, v = m.init_kv_pools(1 + 2 * b * pps, ps,
                           dtype="int8" if kv_dtype == "int8" else None)
    # rows use scattered pages, and leave pages between them unused
    tables = (1 + 2 * np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
    ids = np.random.RandomState(0).randint(1, 256, (b, 7))
    dec.prefill(ids, np.array([7, 5, 6], np.int32), tables, k, v)
    return dec, tables, k, v


def _pool_bytes(pools):
    from torch.utils._pytree import tree_leaves
    return [t.clone() for t in tree_leaves(pools)]


def _calls(dec, tables, k, v):
    b = tables.shape[0]
    ctx = np.array([7, 5, 6], np.int32)
    outs = [dec.decode(np.array([3, 4, 5]), ctx, np.array([1, 1, 0], bool),
                       ctx + 1, tables, k, v)[0]]
    start = ctx + 1
    outs.append(dec.prefill_chunked(
        np.tile(np.arange(1, 6), (b, 1)), start,
        np.array([5, 3, 0], np.int32), tables, k, v)[0])
    outs.append(dec.verify(
        np.tile(np.arange(7, 11), (b, 1)), start + 5,
        np.array([4, 4, 2], np.int32), tables, k, v)[0])
    return outs


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_shadow_leaves_outputs_and_pools_bit_for_bit(kv_dtype):
    runs = []
    for rate in (0.0, 1.0):
        pnum.reset_for_tests()
        tflags.set_flags({"FLAGS_numerics_shadow_rate": rate})
        dec, tables, k, v = _decoder_state(kv_dtype)
        t0 = tables.copy()
        plain0 = cpa.plain_calls
        outs = _calls(dec, tables, k, v)
        plain = cpa.plain_calls - plain0
        assert np.array_equal(tables, t0)
        runs.append((outs, _pool_bytes((k, v)), plain,
                     pnum.numericsz_payload()))
    (o0, p0, n0, d0), (o1, p1, n1, d1) = runs
    assert all(torch.equal(a, b) for a, b in zip(o0, o1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    layers = 2      # gpt_tiny
    assert n1 - n0 == 3 * layers      # one plain call a layer a shadow
    assert d0["shadow"] == {}
    label = kv_dtype or "f32"
    for kind in ("decode", "chunked", "verify"):
        sh = d1["shadow"][f"{kind}/{label}"]
        assert sh["count"] == 1 and sh["max"] == sh["last"] == 0.0


def _prefix_nodes(cache):
    out, stack = [], [(cache._root, ())]
    while stack:
        node, path = stack.pop()
        for key, child in sorted(node.children.items()):
            out.append((path + key, child.page))
            stack.append((child, path + key))
    return sorted(out)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_engine_with_the_plane_on_is_bit_for_bit_and_the_references(
        kv_dtype):
    from paddle_tpu.serving.generation import GenerationServer as JServer
    from paddle_tpu_torch.serving.generation import GenerationServer
    prompts = _prompts()
    jm, tm = make_pair()
    runs = []
    with kv_dtype_flag(kv_dtype):
        for on in (False, True):
            rate = 1.0 if on else 0.0
            tflags.set_flags({"FLAGS_numerics_shadow_rate": rate,
                              "FLAGS_numerics_sample_rate": rate})
            prandom.seed(5)
            srv = GenerationServer(tm, max_batch=4, page_size=8,
                                   prefix_cache=True, draft_model=tm,
                                   spec_k=3, device="cpu",
                                   name=f"plane{int(on)}", start=False)
            got, _, snap = _serve(srv, prompts)
            runs.append((got, _pool_bytes((srv.kv.k, srv.kv.v)),
                         _prefix_nodes(srv.prefix),
                         prandom.get_rng_state(), snap))
        if not kv_dtype:
            # the reference engine with its plane on (once: its jit
            # compiles dominate the file's time)
            _set_both({"FLAGS_numerics_shadow_rate": 1.0,
                       "FLAGS_numerics_sample_rate": 1.0})
            want, _, _ = _serve(JServer(jm, max_batch=4, page_size=8,
                                        prefix_cache=True, draft_model=jm,
                                        spec_k=3, name="jplane",
                                        start=False), prompts)
            assert runs[1][0] == want
            assert jnum.numericsz_payload()["anomalies"]["total"] == 0
    (g0, p0, n0, r0, s0), (g1, p1, n1, r1, s1) = runs
    assert g1 == g0
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert n1 == n0 and len(n1) > 0
    assert r0[0]["seed"] == r1[0]["seed"] and \
        r0[0]["states"].keys() == r1[0]["states"].keys()
    assert all(torch.equal(r0[0]["states"][d], r1[0]["states"][d])
               for d in r0[0]["states"])
    assert s1["kv_leak_check"]["ok"] and s0["kv_leak_check"]["ok"]
    doc = pnum.numericsz_payload()
    label = kv_dtype or "f32"
    assert doc["shadow"][f"verify/{label}"]["max"] == 0.0
    assert doc["serving"]["verify"]["finite_fraction"] == 1.0
    assert doc["anomalies"]["total"] == 0
    if kv_dtype == "int8":
        assert doc["int8"]["verify"]["notes"] > 0
