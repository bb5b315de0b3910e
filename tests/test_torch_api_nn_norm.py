"""The norms of the port (``batch_norm`` in every layout, ``instance_norm``,
``group_norm``, ``normalize``, ``local_response_norm``, ``spectral_norm``;
the batch, group, instance, local-response and spectral norm layers,
``SyncBatchNorm``) against the JAX package's, on the same numpy inputs:
forward and the gradients of the input and the parameters, float32 within
1e-5 relative and 1e-6 absolute (``torch_nn_parity``; 1e-5 absolute where
a statistic's sum runs in another order), and the running statistics
after training forwards. ``BatchNorm2D`` takes ``weight_attr``/``bias_attr``
now (it refused them before)."""
import numpy as np
import pytest

from torch_nn_parity import (assert_fn_parity, assert_layer_parity, both,
                             carry_state, rand)
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

X2 = rand(8, 4, seed=1)
X3 = rand(4, 3, 7, seed=2)
X4 = rand(2, 4, 5, 6, seed=3)
X4_NHWC = rand(2, 5, 6, 4, seed=4)
X5 = rand(2, 3, 3, 4, 2, seed=5)
ATOL = 1e-5


def F(P):
    return P.nn.functional


def _bn(P, x, rm, rv, w, b, **kw):
    return F(P).batch_norm(x, rm, rv, w, b, **kw)


C4 = [rand(4, seed=6, lo=-0.2, hi=0.2), rand(4, seed=7, lo=0.5, hi=1.5),
      rand(4, seed=8, lo=0.5, hi=1.5), rand(4, seed=9)]
FNS = [
    ("bn_train", lambda P, x, rm, rv, w, b: _bn(P, x, rm, rv, w, b,
                                                training=True), [X4] + C4),
    ("bn_eval", lambda P, x, rm, rv, w, b: _bn(P, x, rm, rv, w, b), [X4] + C4),
    ("bn_train_nhwc", lambda P, x, rm, rv, w, b: _bn(
        P, x, rm, rv, w, b, training=True, data_format="NHWC"),
     [X4_NHWC] + C4),
    ("bn_train_2d_input", lambda P, x, rm, rv, w, b: _bn(
        P, x, rm, rv, w, b, training=True), [X2] + C4),
    ("instance_norm", lambda P, x, w, b: F(P).instance_norm(
        x, weight=w, bias=b), [X4, C4[2], C4[3]]),
    ("instance_norm_plain_nhwc", lambda P, x: F(P).instance_norm(
        x, data_format="NHWC"), [X4_NHWC]),
    ("instance_norm_1d", lambda P, x: F(P).instance_norm(
        x, data_format="NCL"), [X3]),
    ("group_norm", lambda P, x, w, b: F(P).group_norm(x, 2, 1e-5, w, b),
     [X4, C4[2], C4[3]]),
    ("group_norm_nhwc", lambda P, x: F(P).group_norm(
        x, 4, data_format="NHWC"), [X4_NHWC]),
    ("normalize", lambda P, x: F(P).normalize(x), [X4]),
    ("normalize_p1_last", lambda P, x: F(P).normalize(x, p=1, axis=-1),
     [X4]),
    ("lrn", lambda P, x: F(P).local_response_norm(x, 3), [X4]),
    ("lrn_even_nhwc", lambda P, x: F(P).local_response_norm(
        x, 4, alpha=0.1, beta=0.5, k=2.0, data_format="NHWC"), [X4_NHWC]),
    ("spectral_norm", lambda P, w: F(P).spectral_norm(w), [X4]),
    ("spectral_norm_dim1_iters2", lambda P, w: F(P).spectral_norm(
        w, dim=1, power_iters=2), [X4]),
    ("spectral_norm_iters0", lambda P, w: F(P).spectral_norm(
        w, power_iters=0), [rand(3, 5, seed=10)]),
]


@pytest.mark.parametrize("fn,arrays", [c[1:] for c in FNS],
                         ids=[c[0] for c in FNS])
def test_norm_functional(fn, arrays):
    grad = (0,) + tuple(i for i in (3, 4) if i < len(arrays)) \
        if len(arrays) == 5 else tuple(range(len(arrays)))
    assert_fn_parity(fn, arrays, grad=grad, atol=ATOL)


@pytest.mark.parametrize("x,fmt", [(X4, "NCHW"), (X4_NHWC, "NHWC"),
                                   (X3, "NCL")], ids=["nchw", "nhwc", "ncl"])
def test_batch_norm_running_statistics(x, fmt):
    """Two training forwards move the running statistics as the
    reference's (Paddle's momentum, the biased variance)."""
    jp, tp = both()
    c = x.shape[1] if fmt.startswith("NC") else x.shape[-1]
    stats = {}
    for P in (tp, jp):
        rm = P.to_tensor(np.zeros(c, np.float32))
        rv = P.to_tensor(np.ones(c, np.float32))
        for i in range(2):
            P.nn.functional.batch_norm(P.to_tensor(x * (i + 1)), rm, rv,
                                       training=True, momentum=0.8,
                                       data_format=fmt)
        stats[P] = (rm.numpy(), rv.numpy())
    for a, b in zip(stats[tp], stats[jp]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _attr(P, value):
    return P.ParamAttr(initializer=P.nn.initializer.Constant(value))


LAYERS = [
    ("BatchNorm", lambda P: P.nn.BatchNorm(4), [X4]),
    ("BatchNorm1D", lambda P: P.nn.BatchNorm1D(4, momentum=0.5), [X2]),
    ("BatchNorm1D_ncl", lambda P: P.nn.BatchNorm1D(3), [X3]),
    ("BatchNorm2D_attrs", lambda P: P.nn.BatchNorm2D(
        4, weight_attr=_attr(P, 0.5), bias_attr=_attr(P, 0.1)), [X4]),
    ("BatchNorm2D_nhwc", lambda P: P.nn.BatchNorm2D(
        4, data_format="NHWC"), [X4_NHWC]),
    ("BatchNorm3D", lambda P: P.nn.BatchNorm3D(3), [X5]),
    ("SyncBatchNorm", lambda P: P.nn.SyncBatchNorm(4), [X4]),
    ("GroupNorm", lambda P: P.nn.GroupNorm(2, 4), [X4]),
    ("InstanceNorm1D", lambda P: P.nn.InstanceNorm1D(3), [X3]),
    ("InstanceNorm2D", lambda P: P.nn.InstanceNorm2D(4), [X4]),
    ("InstanceNorm3D_no_affine", lambda P: P.nn.InstanceNorm3D(
        3, weight_attr=False), [X5]),
    ("LocalResponseNorm", lambda P: P.nn.LocalResponseNorm(3), [X4]),
    ("SpectralNorm", lambda P: P.nn.SpectralNorm([4, 4], dim=1,
                                                 power_iters=2),
     [rand(4, 4, 3, seed=11)]),
]


@pytest.mark.parametrize("make,arrays", [c[1:] for c in LAYERS],
                         ids=[c[0] for c in LAYERS])
def test_norm_layer(make, arrays):
    jl, tl = assert_layer_parity(make, arrays, atol=ATOL)
    for (n, p), (_, q) in zip(tl.state_dict().items(),
                              jl.state_dict().items()):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    if hasattr(tl, "_mean"):
        tl.eval()
        jl.eval()
        got = tl(tp_tensor(arrays[0])).numpy()
        np.testing.assert_allclose(got, jl(jp_tensor(arrays[0])).numpy(),
                                   rtol=1e-5, atol=ATOL)


def tp_tensor(x):
    import paddle_tpu_torch
    return paddle_tpu_torch.to_tensor(x)


def jp_tensor(x):
    import paddle_tpu
    return paddle_tpu.to_tensor(x)


def test_norm_state_names_and_convert_sync_batchnorm():
    """The buffers keep the reference's names (``_mean``, ``_variance``);
    ``convert_sync_batchnorm`` swaps
    every batch norm of a network for a ``SyncBatchNorm`` with its values;
    ``SpectralNorm`` holds no state, as the reference's."""
    jp, tp = both()
    for P in (tp, jp):
        net = P.nn.Sequential(P.nn.Conv2D(3, 4, 3), P.nn.BatchNorm2D(4))
        assert list(net.state_dict()) == ["0.weight", "0.bias", "1.weight",
                                          "1.bias", "1._mean",
                                          "1._variance"]
        assert not P.nn.SpectralNorm([3, 3]).state_dict()
    net = tp.nn.Sequential(tp.nn.Conv2D(3, 4, 3), tp.nn.BatchNorm2D(4))
    net[1]._mean.set_value(np.arange(4, dtype=np.float32))
    conv = tp.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(conv[1], tp.nn.SyncBatchNorm)
    np.testing.assert_array_equal(conv[1]._mean.numpy(), np.arange(4))
    bn = tp.nn.BatchNorm2D(4).astype("bfloat16")
    assert str(bn.weight.dtype) == "bfloat16"
    jbn = jp.nn.BatchNorm2D(4)
    carry_state(jbn, tp.nn.BatchNorm2D(4))
