"""The port's remaining top-level names against the JAX package's:
``finfo``/``iinfo`` fields, the ``batch`` reader decorator,
``check_shape``, ``flops``, ``flags_snapshot``'s entries and the
rng-state round trip of ``get_cuda_rng_state``/``set_cuda_rng_state``;
``DataParallel`` giving the wrapped model's outputs and state;
``ernie_3_0_10b`` built under ``LazyGuard`` (9,897,529,344 parameters,
none allocated); ``paddle.linalg`` and ``amp.amp_guard``; and the
``device`` module's names."""
import numpy as np
import pytest

from torch_nn_parity import both, carry_state, rand

FIELDS = ("min", "max", "bits", "eps", "tiny", "smallest_normal",
          "resolution")


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16",
                                   "bfloat16"])
def test_finfo_matches_jax(dtype):
    jp, tp = both()
    got, want = tp.finfo(getattr(tp, dtype)), jp.finfo(getattr(jp, dtype))
    for f in FIELDS:
        assert float(getattr(got, f)) == float(getattr(want, f)), f
    assert got.dtype == str(want.dtype) == dtype


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64",
                                   "uint8"])
def test_iinfo_matches_jax(dtype):
    jp, tp = both()
    got, want = tp.iinfo(dtype), jp.iinfo(dtype)
    assert (got.min, got.max, got.bits) == (want.min, want.max, want.bits)
    assert got.dtype == str(want.dtype) == dtype


def test_batch_and_check_shape_match_jax():
    jp, tp = both()

    def reader():
        yield from range(7)
    for drop in (False, True):
        assert list(tp.batch(reader, 3, drop)()) == \
            list(jp.batch(reader, 3, drop)())
    for P in (jp, tp):
        with pytest.raises(ValueError):
            P.batch(reader, 0)
        assert P.check_shape([2, -1, None]) == [2, -1, None]
        with pytest.raises(TypeError):
            P.check_shape([2, "a"])


def test_flops_matches_jax():
    """Conv2D and Linear counted by forward post-hooks: 2 a multiply-add."""
    counts = []
    for P in both():
        nn = P.nn
        net = nn.Sequential(nn.Conv2D(3, 4, 3), nn.ReLU(), nn.Flatten(),
                            nn.Linear(4 * 6 * 6, 5))
        counts.append(P.flops(net, [2, 3, 8, 8]))
        assert net.training
    assert counts[0] == counts[1] == 2 * 4 * 36 * 3 * 9 * 2 + 2 * 2 * 144 * 5


def test_flags_snapshot_matches_jax():
    jp, tp = both()
    got, want = tp.flags_snapshot(), jp.flags_snapshot()
    assert got and list(got) == sorted(got)
    for name, entry in got.items():
        assert set(entry) == {"value", "default", "type", "help"}, name
        if name in want:
            assert entry["default"] == want[name]["default"], name
            assert entry["type"] == want[name]["type"], name


def test_cuda_rng_state_round_trip():
    """The reference's shape (a one-element list around the rng state) and
    its contract: the draws after a restore repeat."""
    for P in both():
        P.seed(5)
        state = P.get_cuda_rng_state()
        assert isinstance(state, list) and len(state) == 1
        a = P.randn([4]).numpy()
        P.set_cuda_rng_state(state)
        np.testing.assert_array_equal(P.randn([4]).numpy(), a)


def test_data_parallel_is_the_model():
    jp, tp = both()
    nets = {P: P.nn.Sequential(P.nn.Linear(6, 4), P.nn.Tanh())
            for P in (jp, tp)}
    carry_state(nets[jp], nets[tp])
    x = rand(3, 6, seed=4)
    for P, net in nets.items():
        dp = P.DataParallel(net)
        y = dp(P.to_tensor(x))
        np.testing.assert_array_equal(y.numpy(), net(P.to_tensor(x)).numpy())
        assert dp.scale_loss(y) is y
        dp.apply_collective_grads()
        assert list(dp.state_dict()) == list(net.state_dict())
    np.testing.assert_allclose(
        tp.DataParallel(nets[tp])(tp.to_tensor(x)).numpy(),
        jp.DataParallel(nets[jp])(jp.to_tensor(x)).numpy(), rtol=1e-5,
        atol=1e-6)


def test_ernie_10b_under_lazy_guard_allocates_nothing():
    from paddle_tpu_torch.models.ernie import ErnieModel, ernie_3_0_10b
    _, tp = both()
    with tp.LazyGuard():
        model = ErnieModel(ernie_3_0_10b())
        layer = tp.nn.Linear(4096, 4096)
    params = list(model.parameters())
    assert sum(p.numel() for p in params) == 9_897_529_344
    assert all(p.is_meta for p in params)
    assert layer.weight._data.is_meta
    assert not tp.nn.Linear(2, 2).weight._data.is_meta


def test_linalg_module_and_amp_guard():
    jp, tp = both()
    a = rand(4, 4, seed=6) + 4 * np.eye(4, dtype=np.float32)
    for name in ("inv", "det", "norm"):
        np.testing.assert_allclose(
            getattr(tp.linalg, name)(tp.to_tensor(a)).numpy(),
            getattr(jp.linalg, name)(jp.to_tensor(a)).numpy(), rtol=1e-5,
            atol=1e-6)
    assert tp.amp.amp_guard is tp.amp.auto_cast


def test_device_names():
    _, tp = both()
    d = tp.device
    assert d.get_all_device_type() == ["cpu", "gpu"]
    assert d.get_available_device()[0] == "cpu"
    for name in ("ipu", "npu", "mlu", "cinn"):
        assert getattr(d, f"is_compiled_with_{name}")() is False
    assert d.is_compiled_with_custom_device("x") is False
    assert d.get_all_custom_device_type() == []
    assert d.get_available_custom_device() == []
    assert d.is_cuda_graph_supported() is False
    f = d.wrap_cuda_graph(len)
    assert f is len
    g = d.graphs.CUDAGraph()
    with pytest.raises(RuntimeError):
        g.replay()
    g.capture_begin()
    g.capture_end()
    g.replay()
    for fn in (d.memory_allocated, d.max_memory_allocated,
               d.memory_reserved, d.max_memory_reserved):
        assert fn() >= 0
    for name in ("Stream", "Event", "current_stream", "set_stream",
                 "stream_guard", "get_cudnn_version", "empty_cache",
                 "reset_peak_memory_stats", "cuda"):
        assert hasattr(d, name), name
