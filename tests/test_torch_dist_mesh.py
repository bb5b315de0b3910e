"""Port parity: tensor-parallel serving over a one-process mesh
(``paddle_tpu_torch/serving/mesh.py``, ``models/gpt.py::mesh_forward``,
``CachedDecoder(mesh=)``, ``GenerationServer(mesh=)``) against the JAX
package's mesh path, on the CPU.

The reference runs its mesh over the eight virtual CPU devices that
``tests/conftest.py`` forces; the port's mesh is eight ``cpu`` slots.
``gpt_tiny(num_heads=8)`` at mp 2, 4 and 8: the four entry points' logits
(the reference's ``tests/test_serving_tp.py::run_entry_points`` through its
pure-JAX path, ``use_pallas=False``) within 1e-4 x std, float32, greedy
tokens equal. Then the pools' layout, the guards, the fingerprint and
cache-key contract, the engine under a mesh and the flag.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.mesh_utils import build_mesh as j_build_mesh
from paddle_tpu.serving.mesh import ServingMesh as JServingMesh
from paddle_tpu_torch.compile_cache import cache_key, mesh_fingerprint
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.distributed.mesh_utils import MeshTensor, build_mesh
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.serving import ServingMesh, serving_mesh_from_flags
from paddle_tpu_torch.serving.generation import GenerationServer
from paddle_tpu_torch.serving.generation.model_fns import CachedDecoder
from test_serving_tp import make_model, run_entry_points
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

STD_LIMIT = 1e-4
SITES = ("prefill", "decode", "chunked", "verify")


def cpu_mesh(mp):
    return build_mesh({"mp": mp}, devices=["cpu"] * mp)


def make_pair(num_heads=8, stacked=False):
    """The reference's test model and the port's with its weights."""
    jm, _ = make_model(num_heads=num_heads, stacked=stacked)
    tm = GPTForCausalLM(gpt_tiny(num_heads=num_heads, vocab_size=128,
                                 max_seq_len=64, stacked=stacked),
                        device="cpu")
    load_jax_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm.eval()


def port_entry_points(model, mesh, kv_dtype=""):
    """The port's counterpart of ``run_entry_points``: prefill, decode,
    chunked prefill and verify through one decoder, same inputs."""
    dec = CachedDecoder(model, max_batch=2, page_size=8, pages_per_seq=4,
                        max_positions=64, kv_dtype=kv_dtype, device="cpu",
                        mesh=mesh)
    k, v = ServingMesh(mesh).place_pools(
        *model.init_kv_pools(9, 8, kv_dtype or None))
    ids = np.array([[5, 6, 7, 8, 0, 0, 0, 0],
                    [9, 10, 11, 12, 13, 14, 0, 0]], np.int64)
    plens = np.array([4, 6], np.int32)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    last, k, v = dec.prefill(ids, plens, tables, k, v)
    ctx = plens + 1
    dc, k, v = dec.decode(np.array([3, 4], np.int64), plens.copy(),
                          np.array([True, True]), ctx, tables, k, v)
    suffix = np.array([[20, 21, 0, 0], [22, 23, 24, 0]], np.int64)
    start = ctx.astype(np.int32)
    slens = np.array([2, 3], np.int32)
    ck, k, v = dec.prefill_chunked(suffix, start, slens, tables, k, v)
    vf, k, v = dec.verify(np.array([[30, 31], [32, 33]], np.int64),
                          (start + slens).astype(np.int32),
                          np.array([2, 2], np.int32), tables, k, v)
    return [x.numpy() for x in (last, dc, ck, vf)], (k, v)


def _std_err(a, ref):
    return float(np.abs(a - ref).max() / ref.std())


@pytest.mark.parametrize("mp,stacked", [(2, False), (4, False), (8, False),
                                        (8, True)])
def test_mesh_entry_points_match_the_reference_mesh(mp, stacked):
    jm, tm = make_pair(stacked=stacked)
    want = run_entry_points(jm, j_build_mesh({"mp": mp}, jax.devices()[:mp]),
                            use_pallas=False)
    got, _ = port_entry_points(tm, cpu_mesh(mp))
    for site, a, b in zip(SITES, got, want):
        assert _std_err(a, b) <= STD_LIMIT, site
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


def test_int8_pools_shard_their_scales_with_their_values():
    _, tm = make_pair()
    base, _ = port_entry_points(tm, None, "int8")
    got, (k, v) = port_entry_points(tm, cpu_mesh(4), "int8")
    for site, a, b in zip(SITES, got, base):
        assert _std_err(a, b) <= STD_LIMIT, site
    for vals, scales in k + v:
        assert vals.dtype == torch.int8 and scales.dtype == torch.float32
        for t in vals.shards:
            assert tuple(t.shape) == (9, 8, 2, 8) and t.is_contiguous()
        for t in scales.shards:
            assert tuple(t.shape) == (9, 8, 2) and t.is_contiguous()
    # the reference's placement agrees shard for shard
    jm, _ = make_model()
    jk, _ = JServingMesh(j_build_mesh({"mp": 4}, jax.devices()[:4])) \
        .place_pools(*jm.init_kv_pools(9, 8, "int8"))
    assert jk[0][0].addressable_shards[0].data.shape == (9, 8, 2, 8)
    assert jk[0][1].addressable_shards[0].data.shape == (9, 8, 2)


@pytest.mark.parametrize("stacked", [False, True])
def test_pool_shards_are_contiguous_heads_blocks(stacked):
    _, tm = make_pair(stacked=stacked)
    k, v = tm.init_kv_pools(9, 8)
    full = k if stacked else k[0]
    pk, pv = ServingMesh(cpu_mesh(8)).place_pools(k, v)
    leaf = pk if stacked else pk[0]
    assert isinstance(leaf, MeshTensor)
    for s, t in enumerate(leaf.shards):
        assert t.is_contiguous() and t.shape[-2] == 1
        torch.testing.assert_close(t, full[..., s:s + 1, :], rtol=0, atol=0)
    torch.testing.assert_close(leaf.full(), full, rtol=0, atol=0)


def test_heads_must_divide_mp_as_in_the_reference():
    jm, tm = make_pair(num_heads=4)
    for dec, mesh in ((CachedDecoder, cpu_mesh(8)),):
        with pytest.raises(ValueError, match="head"):
            dec(tm, max_batch=2, page_size=8, pages_per_seq=4, device="cpu",
                mesh=mesh)
    from paddle_tpu.serving.generation.model_fns import \
        CachedDecoder as JDecoder
    with pytest.raises(ValueError, match="head"):
        JDecoder(jm, max_batch=2, page_size=8, pages_per_seq=4, donate=False,
                 mesh=j_build_mesh({"mp": 8}))


def _decoder(m, mesh):
    return CachedDecoder(m, max_batch=2, page_size=8, pages_per_seq=4,
                         device="cpu", mesh=mesh)


def test_one_slot_mesh_is_byte_identical():
    _, tm = make_pair()
    meshless = _decoder(tm, None)
    one = _decoder(tm, build_mesh({"mp": 1}, devices=["cpu"]))
    assert not one.serving_mesh.live
    assert meshless.fingerprint() == one.fingerprint()
    args = (np.zeros((2, 8), np.int64),)
    keys = [cache_key(d.fingerprint(), args,
                      mesh=d.serving_mesh.mesh_for_cache_key())[0]
            for d in (meshless, one)]
    assert keys[0] == keys[1]
    assert mesh_fingerprint(None) == "none"


def test_live_mesh_misses_every_key():
    _, tm = make_pair()
    decs = [_decoder(tm, None), _decoder(tm, cpu_mesh(4)),
            _decoder(tm, cpu_mesh(8))]
    assert len({d.fingerprint() for d in decs}) == 3
    args = (np.zeros((2, 8), np.int64),)
    keys = [cache_key(d.fingerprint(), args,
                      mesh=d.serving_mesh.mesh_for_cache_key())[0]
            for d in decs]
    assert len(set(keys)) == 3
    # slots on other devices are another mesh
    other = build_mesh({"mp": 2}, devices=["cpu", "meta"])
    assert mesh_fingerprint(other) != mesh_fingerprint(cpu_mesh(2))


def test_spec_tree_joins_the_live_fingerprint_with_the_reference_hash():
    jm, tm = make_pair()
    assert ServingMesh(None).fingerprint_parts(tm) is None
    parts = ServingMesh(cpu_mesh(8)).fingerprint_parts(tm)
    want = JServingMesh(j_build_mesh({"mp": 8})).fingerprint_parts(jm)
    assert parts["axes"] == want["axes"] == {"mp": 8}
    assert parts["spec_hash"] == want["spec_hash"]


def test_engine_prefix_hit_and_leak_check_under_a_mesh():
    _, tm = make_pair()
    rng = np.random.RandomState(1)
    shared = list(rng.randint(0, 128, 16))
    pa, pb = shared + [3, 1], shared + [9, 9, 4]
    with GenerationServer(tm, max_batch=2, page_size=8, device="cpu",
                          name="tp-ref") as ref:
        ra = ref.generate(pa, max_new_tokens=6)
        rb = ref.generate(pb, max_new_tokens=6)
    with GenerationServer(tm, max_batch=2, page_size=8, device="cpu",
                          mesh=cpu_mesh(8), name="tp-cow") as srv:
        assert srv.generate(pa, max_new_tokens=6) == ra
        assert srv.generate(pb, max_new_tokens=6) == rb
        snap = srv.metrics_snapshot()
        assert snap["prefix"]["hits"] == 1
        assert snap["prefix"]["tokens_reused"] == 16
        assert snap["kv_leak_check"]["ok"]
        srv.kv.assert_no_leaks()
        ms = srv.statusz()["serving_mesh"]
        assert ms["live"] and ms["axes"] == {"mp": 8} and ms["devices"] == 8
        assert ms["per_chip_kv_pool_bytes"] * 8 == srv.kv.pool_bytes()
        assert ms["per_slot_kv_pool_bytes"] == [ms["per_chip_kv_pool_bytes"]]\
            * 8
    with GenerationServer(tm, max_batch=2, page_size=8, device="cpu",
                          name="tp-nomesh") as srv:
        assert "serving_mesh" not in srv.statusz()


def test_self_speculation_under_a_mesh_matches_the_meshless_engine():
    _, tm = make_pair()
    prompt = list(np.random.RandomState(2).randint(0, 128, 12))
    outs = []
    for mesh in (None, cpu_mesh(2)):
        with GenerationServer(tm, max_batch=2, page_size=8, device="cpu",
                              draft_model=tm, spec_k=3, mesh=mesh,
                              name=f"tp-spec-{mesh is None}") as srv:
            outs.append(srv.generate(prompt, max_new_tokens=8))
    assert outs[0] == outs[1]


def test_flag_builds_the_mesh_and_keeps_the_device_contract():
    assert not serving_mesh_from_flags().live
    set_flags({"FLAGS_serving_mesh_mp": 8})
    try:
        sm = serving_mesh_from_flags(devices=["cpu"] * 8)
        assert sm.live and sm.mp == 8
        if not torch.cuda.is_available():
            # the visible devices are the CPU alone: too few for 8 slots
            with pytest.raises(ValueError, match="needs 8 devices"):
                serving_mesh_from_flags()
    finally:
        set_flags({"FLAGS_serving_mesh_mp": 1})
    paddle.set_flags({"FLAGS_serving_mesh_mp": 1})
