"""Port parity: checkpoints saved on a mesh (``framework/checkpoint.py``'s
``spec``, ``load_sharded(mesh=)``, ``CheckpointManager.restore_latest(
mesh=)``), each package reading the other's, on the CPU.

A mesh-placed tensor (``MeshTensor``) is saved as one full array with its
spec in the manifest; the reference places it by that spec on its mesh of
virtual CPU devices, and the port places the reference's spec-annotated
arrays on its mesh of ``cpu`` slots.
"""
import jax
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.mesh_utils import build_mesh as j_build_mesh
from paddle_tpu.framework import checkpoint as jck
from paddle_tpu_torch.distributed.mesh_utils import MeshTensor, build_mesh
from paddle_tpu_torch.elastic import CheckpointManager
from paddle_tpu_torch.framework import checkpoint as pck


def _mesh():
    return build_mesh({"mp": 2}, devices=["cpu"] * 2)


def test_a_mesh_saved_checkpoint_reads_in_the_reference(tmp_path):
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(4, 6).astype(np.float32))
    b = torch.from_numpy(rng.randn(6).astype(np.float32))
    state = {"w": MeshTensor.place(w, _mesh(), ("mp", None)),
             "b_col": MeshTensor.place(b, _mesh(), ("mp",)), "step": b}
    path = str(tmp_path / "ck")
    pck.save_sharded(state, path)
    ents = pck._read_meta(path)
    assert ents["w"]["spec"] == ["mp", None]
    assert ents["b_col"]["spec"] == ["mp"] and ents["step"]["spec"] is None
    got = jck.load_sharded(path, mesh=j_build_mesh({"mp": 2},
                                                   jax.devices()[:2]))
    np.testing.assert_array_equal(got["w"].numpy(), w.numpy())
    assert got["w"].dist_spec == ("mp", None)
    shards = got["w"]._data.addressable_shards
    assert len(shards) == 2 and shards[0].data.shape == (2, 6)
    np.testing.assert_array_equal(got["b_col"].numpy(), b.numpy())


def test_the_reference_mesh_checkpoint_places_on_the_ports_mesh(tmp_path):
    rng = np.random.RandomState(1)
    w = rng.randn(6, 4).astype(np.float32)
    tw = paddle.to_tensor(w)
    tw.dist_spec = (None, "mp")
    path = str(tmp_path / "ck")
    jck.save_sharded({"w": tw, "plain": paddle.to_tensor(w[0])}, path)
    got = pck.load_sharded(path, mesh=_mesh())
    assert isinstance(got["w"], MeshTensor) and got["w"].spec == (None, "mp")
    assert [tuple(t.shape) for t in got["w"].shards] == [(6, 2), (6, 2)]
    np.testing.assert_array_equal(got["w"].full("cpu").numpy(), w)
    assert isinstance(got["plain"], torch.Tensor)
    # without a mesh: CPU tensors carrying the recorded spec
    flat = pck.load_sharded(path)
    assert flat["w"].dist_spec == (None, "mp")
    np.testing.assert_array_equal(flat["w"].numpy(), w)


def test_restore_latest_on_a_mesh_gathers_into_the_model(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 6)
    mgr = CheckpointManager(str(tmp_path), model=model, health_check=False)
    mgr.save(1)
    mgr.wait()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    fresh = torch.nn.Linear(4, 6)
    res = CheckpointManager(str(tmp_path), model=fresh, health_check=False) \
        .restore_latest(mesh=_mesh())
    assert res is not None and res.step == 1
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k])
