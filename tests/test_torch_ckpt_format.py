"""The port's checkpoint directories (``paddle_tpu_torch.framework.
checkpoint``) against ``paddle_tpu``'s: the same numpy arrays saved by both
packages give equal ``meta.json`` entries and byte-identical ``.npy`` files;
each package's ``load_sharded`` reads the other's directory; corruption
raises ``CheckpointCorruptError`` in both alike; staging directories are
invisible and swept; listing and pruning agree; an async save is a
snapshot; a bfloat16 torch tensor round-trips bit for bit without
``ml_dtypes``.
"""
import json
import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.framework import checkpoint as jck
from paddle_tpu_torch.framework import checkpoint as pck

PKGS = {"port": pck, "ref": jck}
HOSTILE = ("../escape", "a/b/c", "model/layer.0.weight", "sp ace%20",
           "ünï", ".hidden", "rng/torch/cuda:0")


def _arrays():
    rs = np.random.RandomState(3)
    out = {
        "f32": rs.randn(3, 5).astype(np.float32),
        "f16": rs.randn(7).astype(np.float16),
        "i8": rs.randint(-128, 127, (4, 4)).astype(np.int8),
        "i32": rs.randint(-2 ** 31, 2 ** 31 - 1, (6,)).astype(np.int32),
        "i64": rs.randint(-2 ** 62, 2 ** 62, (2, 3)).astype(np.int64),
        "bool": rs.rand(9) > 0.5,
        "bf16": rs.randn(4, 3).astype(ml_dtypes.bfloat16),
        "scalar": np.asarray(np.float32(2.5)),
        "empty": np.zeros((0, 4), np.float32),
    }
    for i, name in enumerate(HOSTILE):
        out[name] = rs.randn(2, i + 1).astype(np.float32)
    return out


def _as_numpy(v):
    """A loaded entry (a torch tensor from the port, a Paddle tensor from
    the reference) as numpy, bfloat16 as ml_dtypes'."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return v.numpy()
    return np.asarray(v.numpy())


def _meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("ck")
    arrays = _arrays()
    paths = {}
    for tag, mod in PKGS.items():
        paths[tag] = str(root / tag)
        mod.save_sharded(arrays, paths[tag], extra={"train": {"step": 3}})
    return arrays, paths


def test_manifests_and_files_are_identical(saved):
    arrays, paths = saved
    mp, mj = _meta(paths["port"]), _meta(paths["ref"])
    assert mp == mj and mp["format"] == 2
    assert set(mp["entries"]) == set(arrays)
    assert mp["entries"]["bf16"]["dtype"] == "bfloat16"
    assert mp["entries"]["bf16"]["stored_as"] == "uint16"
    assert all(e["spec"] is None for e in mp["entries"].values())
    for ent in mp["entries"].values():
        with open(os.path.join(paths["port"], ent["file"]), "rb") as a, \
                open(os.path.join(paths["ref"], ent["file"]), "rb") as b:
            assert a.read() == b.read(), ent["file"]
    # every file stays inside its directory
    assert sorted(os.listdir(paths["port"])) == \
        sorted(os.listdir(paths["ref"]))
    for name, ent in mp["entries"].items():
        assert pck.decode_entry_name(ent["file"]) == name
        assert "/" not in ent["file"]


@pytest.mark.parametrize("reader", sorted(PKGS))
@pytest.mark.parametrize("writer", sorted(PKGS))
def test_each_package_reads_the_other(saved, reader, writer):
    arrays, paths = saved
    loaded = PKGS[reader].load_sharded(paths[writer])
    assert set(loaded) == set(arrays)
    for name, want in arrays.items():
        got = _as_numpy(loaded[name])
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name
    assert PKGS[reader].load_checkpoint_extra(paths[writer]) == \
        {"train": {"step": 3}}


def _corrupt(path, how):
    meta = _meta(path)
    fname = os.path.join(path, meta["entries"]["f32"]["file"])
    if how == "truncated":
        with open(fname, "r+b") as f:
            f.truncate(os.path.getsize(fname) - 7)
    elif how == "bitflip":
        with open(fname, "r+b") as f:
            f.seek(-3, os.SEEK_END)
            b = f.read(1)
            f.seek(-3, os.SEEK_END)
            f.write(bytes([b[0] ^ 0x10]))
    else:
        os.unlink(os.path.join(path, "meta.json"))


@pytest.mark.parametrize("how", ["truncated", "bitflip", "no_manifest"])
def test_corruption_raises_alike(tmp_path, how):
    arrays = _arrays()
    for tag, mod in PKGS.items():
        path = str(tmp_path / tag)
        mod.save_sharded(arrays, path)
        _corrupt(path, how)
        for reader in PKGS.values():
            with pytest.raises(reader.CheckpointCorruptError):
                reader.load_sharded(path)
        assert mod.is_checkpoint_dir(path) == (how != "no_manifest")


def test_staging_is_invisible_and_swept(tmp_path):
    root = str(tmp_path)
    for step in (1, 2):
        pck.save_sharded({"w": np.ones(3, np.float32)},
                         os.path.join(root, f"step_{step:08d}"))
    os.makedirs(os.path.join(root, "step_00000003.tmp-deadbeef"))
    os.makedirs(os.path.join(root, "step_00000000.corrupt-0bad0bad"))
    with open(os.path.join(root, "step_00000003.tmp-deadbeef", "x.npy"),
              "wb") as f:
        f.write(b"torn")
    for mod in PKGS.values():
        assert [os.path.basename(p) for p in mod.list_checkpoints(root)] \
            == ["step_00000001", "step_00000002"]
    assert pck.sweep_stale_staging(root, min_age_s=3600) == []
    swept = pck.sweep_stale_staging(root)
    assert [os.path.basename(p) for p in swept] == \
        ["step_00000003.tmp-deadbeef"]
    assert sorted(os.listdir(root)) == [
        "step_00000000.corrupt-0bad0bad", "step_00000001", "step_00000002"]


def test_prune_and_list_agree(tmp_path):
    roots = {tag: str(tmp_path / tag) for tag in PKGS}
    for tag, mod in PKGS.items():
        for step in range(5):
            path = os.path.join(roots[tag], f"step_{step:08d}")
            mod.save_sharded({"w": np.full(2, step, np.float32)}, path)
            os.utime(path, (1000 + step, 1000 + step))
    names = {tag: [os.path.basename(p) for p in
                   PKGS[tag].list_checkpoints(roots[tag])] for tag in PKGS}
    assert names["port"] == names["ref"] == \
        [f"step_{s:08d}" for s in range(5)]
    removed = {tag: [os.path.basename(p) for p in
                     PKGS[tag].prune_checkpoints(roots[tag], 2)]
               for tag in PKGS}
    assert removed["port"] == removed["ref"] == \
        [f"step_{s:08d}" for s in range(3)]
    assert pck.prune_checkpoints(roots["port"], 0) == []
    assert [os.path.basename(p) for p in pck.list_checkpoints(
        roots["port"])] == ["step_00000003", "step_00000004"]
    assert pck.checkpoint_nbytes(os.path.join(roots["port"],
                                              "step_00000004")) == \
        jck.checkpoint_nbytes(os.path.join(roots["ref"], "step_00000004"))


def test_async_save_is_a_snapshot(tmp_path):
    """Updating the sources in place after save_sharded returns never
    reaches the checkpoint: numpy arrays, torch tensors and Paddle
    tensors are copied before the call returns."""
    import paddle_tpu_torch as paddle
    paddle.set_device("cpu")
    src = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = torch.arange(6, dtype=torch.float32)
    p = paddle.to_tensor(np.ones(5, np.float32))
    os.environ["PADDLE_CKPT_TEST_SLEEP_S"] = "0.05"   # a write window
    try:
        h = pck.save_sharded({"np": src, "t": t, "p": p},
                             str(tmp_path / "ck"), async_save=True)
        src[:] = -777.0
        t.fill_(-777.0)
        p._data.fill_(-777.0)
        assert h.wait(timeout=30)
    finally:
        del os.environ["PADDLE_CKPT_TEST_SLEEP_S"]
    got = pck.load_sharded(str(tmp_path / "ck"))
    assert torch.equal(got["np"], torch.arange(12.).reshape(3, 4))
    assert torch.equal(got["t"], torch.arange(6.))
    assert torch.equal(got["p"], torch.ones(5))
    assert h.done() and h.exception is None and h.result > 0


def test_bfloat16_tensor_round_trips_without_ml_dtypes(tmp_path,
                                                       monkeypatch):
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes as _  # noqa: F401
    t = torch.randn(5, 7, generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16)
    t[0, 0] = float("nan")
    t[0, 1] = float("-inf")
    pck.save_sharded({"w": t, "w_t": t.t()}, str(tmp_path / "ck"))
    got = pck.load_sharded(str(tmp_path / "ck"))
    for name, want in (("w", t), ("w_t", t.t())):
        assert got[name].dtype == torch.bfloat16
        assert torch.equal(got[name].view(torch.int16),
                           want.contiguous().view(torch.int16))
    ent = _meta(str(tmp_path / "ck"))["entries"]["w"]
    assert (ent["dtype"], ent["stored_as"]) == ("bfloat16", "uint16")


def test_mesh_placement_waits_for_item_5c(saved):
    """Item 5c, part 1 ported mesh placement: ``load_sharded(mesh=)``
    places an entry with a recorded spec on the mesh (a MeshTensor) and
    loads the rest as they are; without a spec nothing is split."""
    from paddle_tpu_torch.distributed.mesh_utils import MeshTensor, build_mesh
    _, paths = saved
    mesh = build_mesh({"mp": 2}, devices=["cpu"] * 2)
    plain = pck.load_sharded(paths["port"])
    placed = pck.load_sharded(paths["port"], mesh=mesh)
    assert set(placed) == set(plain)
    for name, t in placed.items():
        if isinstance(t, MeshTensor):
            assert torch.equal(t.full("cpu"), plain[name])
        else:
            assert torch.equal(t, plain[name])
