"""Port parity: the sharding rules (``paddle_tpu_torch/distributed/shard.py``),
the one-process mesh (``mesh_utils.py``), the tensor-parallel layers
(``fleet/meta_parallel``) and the hybrid topology's rank math
(``fleet/topology.py``) against the JAX package, on the CPU.

Spec trees are in Paddle's layout under the reference's parameter paths, so
``spec_tree``, ``spec_tree_hash`` and ``projected_bytes_per_chip`` must be
the reference's own answers for GPT (both decoders), BERT and ERNIE at small
widths, on meshes with and without ZeRO.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import shard as jshard
from paddle_tpu.distributed.fleet.topology import \
    CommunicateTopology as JTopo
from paddle_tpu.distributed.fleet.topology import \
    HybridCommunicateGroup as JHCG
from paddle_tpu.distributed.mesh_utils import build_mesh as j_build_mesh
from paddle_tpu.distributed.mesh_utils import set_global_mesh as j_set_mesh
from paddle_tpu_torch.distributed import shard
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from paddle_tpu_torch.distributed.fleet.topology import (
    CommunicateTopology, HybridCommunicateGroup)
from paddle_tpu_torch.distributed.mesh_utils import (
    MeshTensor, build_mesh, get_global_mesh, manual_shard_map,
    set_global_mesh, with_constraint)


def _models(name):
    """(reference model, port model) of ``name``, small widths."""
    import paddle_tpu.models as J
    import paddle_tpu_torch.models as T
    paddle.seed(0)
    if name.startswith("gpt"):
        stacked = name == "gpt_stacked"
        return (J.GPTForCausalLM(J.gpt_tiny(stacked=stacked)),
                T.GPTForCausalLM(T.gpt_tiny(stacked=stacked), device="cpu"))
    if name == "bert":
        return (J.BertForPretraining(J.bert_tiny()),
                T.BertForPretraining(T.bert_tiny(), device="cpu"))
    from paddle_tpu.models.ernie import ErnieModel as JErnie
    from paddle_tpu.models.ernie import ernie_tiny as j_ernie_tiny
    return (JErnie(j_ernie_tiny()),
            T.ErnieModel(T.ernie_tiny(), device="cpu"))


MESHES = [({"mp": 2}, None), ({"dp": 2, "mp": 4}, None),
          ({"sharding": 2, "mp": 2}, "p_g_os"), ({"sharding": 4}, "os")]


@pytest.mark.parametrize("name", ["gpt", "gpt_stacked", "bert", "ernie"])
def test_spec_trees_hashes_and_bytes_equal_the_reference(name):
    jm, tm = _models(name)
    for axes, zero in MESHES:
        n = int(np.prod(list(axes.values())))
        jmesh = j_build_mesh(axes, jax.devices()[:n])
        tmesh = build_mesh(axes, devices=["cpu"] * n)
        want = jshard.spec_tree(jm, mesh=jmesh, zero=zero)
        got = shard.spec_tree(tm, mesh=tmesh, zero=zero)
        assert got == want, (name, axes, zero)
        assert shard.spec_tree_hash(got) == jshard.spec_tree_hash(want)
        for opt_bytes in (0, 8):
            assert shard.projected_bytes_per_chip(
                dict(tm.named_parameters()), got, axes, opt_bytes) == \
                jshard.projected_bytes_per_chip(
                    dict(jm.named_parameters()), want, axes, opt_bytes)
    # meshless: every spec replicated, as the reference's
    assert shard.spec_tree(tm, mesh=None) == jshard.spec_tree(jm, mesh=None)
    assert shard.model_spec_tree(tm) == jshard.model_spec_tree(jm)


def test_annotations_and_apply_sharding_follow_the_reference():
    jm, tm = _models("gpt")
    axes = {"sharding": 2, "mp": 2}
    jmesh = j_build_mesh(axes, jax.devices()[:4])
    tmesh = build_mesh(axes, devices=["cpu"] * 4)
    ov = {"*fc_in.weight": (None, None)}
    g0 = shard.specs_generation()
    shard.annotate(tm.gpt.layers[0].attn.out_proj, weight=(None, "mp"))
    jshard.annotate(jm.gpt.layers[0].attn.out_proj, weight=(None, "mp"))
    assert shard.specs_generation() > g0
    got = shard.apply_sharding(tm, mesh=tmesh, overrides=ov, zero="os")
    want = jshard.apply_sharding(jm, mesh=jmesh, overrides=ov, zero="os")
    assert got == want
    assert shard.model_spec_tree(tm) == jshard.model_spec_tree(jm)
    with pytest.raises(KeyError):
        shard.annotate(tm, {"*nothing*": ("mp",)})
    with pytest.raises(ValueError):
        shard.spec_tree(tm, mesh=tmesh, zero="everything")


def test_placement_is_in_the_torch_layout():
    _, tm = _models("gpt")
    mesh = build_mesh({"mp": 4}, devices=["cpu"] * 4)
    placed = shard.shard_params(tm, mesh=mesh, specs=shard.spec_tree(
        tm, mesh=mesh))
    w = placed["gpt.layers.0.attn.qkv_proj.weight"]    # torch [3H, H]
    assert w.spec == ("mp", None) and w.shards[0].shape == (48, 64)
    o = placed["gpt.layers.0.attn.out_proj.weight"]    # torch [H, H]
    assert o.spec == (None, "mp") and o.shards[0].shape == (64, 16)
    for path, p in tm.named_parameters():
        torch.testing.assert_close(placed[path].full(), p.detach(), rtol=0,
                                   atol=0)
    assert shard.shard_params(tm, mesh=None) == {}


def test_mesh_tensor_blocks_on_a_two_axis_mesh():
    mesh = build_mesh({"dp": 2, "mp": 4}, devices=["cpu"] * 8)
    x = torch.arange(8 * 12, dtype=torch.float32).view(8, 12)
    for spec in ((None, "mp"), ("dp", "mp"), (("dp", "mp"), None), ()):
        mt = MeshTensor.place(x, mesh, spec)
        assert len(mt.shards) == 8
        assert all(t.is_contiguous() for t in mt.shards)
        torch.testing.assert_close(mt.full(), x, rtol=0, atol=0)
    mt = MeshTensor.place(x, mesh, (("dp", "mp"), None))
    # dim 0 over both axes, row-major: slot (dp=1, mp=2) holds block 6
    torch.testing.assert_close(mt.shard(6), x[6:7])
    # a dim the axes do not divide degrades to replication
    assert MeshTensor.place(torch.zeros(3, 12), mesh, ("mp", None)).spec \
        == (None, None)


def test_manual_shard_map_and_constraints():
    mesh = build_mesh({"mp": 4}, devices=["cpu"] * 4)
    x = torch.randn(4, 8)
    w = torch.randn(8, 6)

    def body(xs, ws):               # row-parallel partial products
        return xs @ ws

    parts = manual_shard_map(body, mesh, ((None, "mp"), ("mp", None)),
                             ())(x, w)
    total = sum(parts.shards)
    torch.testing.assert_close(total, x @ w, rtol=1e-5, atol=1e-5)
    assert get_global_mesh() is None
    assert with_constraint(x, "mp") is x          # no live global mesh
    set_global_mesh(mesh)
    try:
        assert isinstance(with_constraint(x, "mp", None), MeshTensor)
        assert isinstance(shard.constrain(x, "mp", None), MeshTensor)
        assert shard.constrain_batch(x) is x      # no dp/sharding axis
    finally:
        set_global_mesh(None)


@pytest.mark.parametrize("mp", [1, 4])
def test_tp_layers_compute_the_plain_layers_and_carry_the_reference_marks(
        mp):
    from paddle_tpu.distributed.fleet.meta_parallel import \
        ColumnParallelLinear as JCol
    from paddle_tpu.distributed.fleet.meta_parallel import \
        RowParallelLinear as JRow
    from paddle_tpu.distributed.fleet.meta_parallel import \
        VocabParallelEmbedding as JVocab
    torch.manual_seed(0)
    col, row = ColumnParallelLinear(8, 12), RowParallelLinear(12, 8)
    emb = VocabParallelEmbedding(64, 8)
    assert col.weight.dist_spec == JCol(8, 12).weight.dist_spec
    assert col.bias.dist_spec == JCol(8, 12).bias.dist_spec
    assert row.weight.dist_spec == JRow(12, 8).weight.dist_spec
    assert row.bias.dist_spec == JRow(12, 8).bias.dist_spec
    assert emb.weight.dist_spec == JVocab(64, 8).weight.dist_spec
    x = torch.randn(3, 8)
    ids = torch.randint(0, 64, (3, 5))
    plain = (torch.nn.functional.linear(x, col.weight, col.bias),
             torch.nn.functional.embedding(ids, emb.weight))
    plain_row = torch.nn.functional.linear(plain[0], row.weight, row.bias)
    set_global_mesh(build_mesh({"mp": mp}, devices=["cpu"] * mp)
                    if mp > 1 else None)
    try:
        with torch.no_grad():
            h = col(x)
            torch.testing.assert_close(h, plain[0], rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(row(h), plain_row, rtol=1e-6,
                                       atol=1e-6)
            torch.testing.assert_close(emb(ids), plain[1], rtol=0, atol=0)
            from paddle_tpu_torch import distributed as dist
            out = dist.split(x, (8, 12), "linear", axis=1)
            assert out.shape == (3, 12)
    finally:
        set_global_mesh(None)


LAYOUTS = [(("data", "pipe", "sharding", "model"), (2, 1, 2, 2)),
           (("data", "pipe", "sharding", "sep", "model"), (1, 2, 1, 2, 2)),
           (("data", "pipe", "sharding", "model"), (4, 2, 1, 1))]


@pytest.mark.parametrize("names,dims", LAYOUTS)
def test_topology_rank_math_equals_the_reference(names, dims, monkeypatch):
    jt, tt = JTopo(names, dims), CommunicateTopology(names, dims)
    assert tt.world_size() == jt.world_size()
    for n in names:
        assert tt.get_comm_list(n) == jt.get_comm_list(n)
        for i in range(tt.get_dim(n)):
            assert tt.get_axis_list(n, i) == jt.get_axis_list(n, i)
    for r in range(tt.world_size()):
        assert tt.get_coord(r) == jt.get_coord(r)
        assert tt.get_rank_from_stage(r, pipe=0) == \
            jt.get_rank_from_stage(r, pipe=0)
    getters = ("get_data_parallel_rank", "get_data_parallel_world_size",
               "get_model_parallel_rank", "get_model_parallel_world_size",
               "get_stage_id", "get_pipe_parallel_world_size",
               "get_sharding_parallel_rank",
               "get_sharding_parallel_world_size", "get_parallel_mode",
               "get_data_parallel_group_src_rank",
               "get_model_parallel_group_src_rank",
               "get_sep_parallel_world_size", "is_first_stage",
               "is_last_stage")
    for r in range(tt.world_size()):
        monkeypatch.setenv("PADDLE_TRAINER_ID", str(r))
        try:
            jh, th = JHCG(jt), HybridCommunicateGroup(tt)
        finally:
            j_set_mesh(None)
            set_global_mesh(None)
        for g in getters:
            assert getattr(th, g)() == getattr(jh, g)(), (r, g)
        for grp in ("get_data_parallel_group", "get_model_parallel_group",
                    "get_pipe_parallel_group",
                    "get_sharding_parallel_group"):
            assert getattr(th, grp)().ranks == getattr(jh, grp)().ranks
