"""The pool layers of the port, ``return_mask`` and the unpools against
the JAX package's, on the same numpy inputs (``test_torch_api_nn_pool.py``'s):
forward and the gradient of the input, float32 within 1e-5 relative and
1e-6 absolute; the masks' indices exactly. The port honours ``ceil_mode``
(the reference ignores it): held to the reference's pool over the input
padded by the extra end. ``adaptive_max_pool*d``'s mask is the argmax (the
reference's is right only when the input is the square of the output): held
to the reference where it is right and to the values it picks elsewhere."""
import numpy as np
import pytest

from test_torch_api_nn_pool import F, X3, X4, X4_NHWC, X5
from torch_nn_parity import (assert_fn_parity, assert_layer_parity, both,
                             rand)
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("n,x,kw", [
    (1, X3, {"kernel_size": 3, "stride": 2, "padding": 1}),
    (1, X3, {"kernel_size": 2}),
    (2, X4, {"kernel_size": 2}),
    (2, X4, {"kernel_size": 3, "stride": 2, "padding": [[1, 1], [0, 2]]}),
    (3, X5, {"kernel_size": 2, "stride": 1, "padding": 1}),
    (3, X5, {"kernel_size": [2, 3, 2], "padding": [1, 0, 0]})],
    ids=["1d_overlap", "1d", "2d", "2d_pairs", "3d_overlap", "3d"])
def test_max_pool_mask_and_unpool(n, x, kw):
    """``return_mask`` indices equal the reference's, and ``max_unpool``
    puts each maximum back where it came from (windows that do not overlap:
    where they do, one maximum can be reported twice, and the two packages
    give the gradient of a twice-written element to different writes)."""
    def fn(P, x):
        out, mask = getattr(F(P), f"max_pool{n}d")(x, return_mask=True, **kw)
        k, s = kw["kernel_size"], kw.get("stride")
        pad = kw.get("padding", 0)
        up = None
        if s is None and not isinstance(pad, list) or \
                isinstance(pad, list) and not isinstance(pad[0], list) and \
                s is None:
            up = getattr(F(P), f"max_unpool{n}d")(
                out, mask, k, s, pad, output_size=list(x.shape))
        return [out, mask] + ([] if up is None else [up])
    outs = assert_fn_parity(fn, [x], grad=(0,))
    if len(outs) == 3:
        flat = outs[2].reshape(outs[2].shape[:2] + (-1,))
        idx = outs[1].reshape(outs[1].shape[:2] + (-1,))
        picked = np.take_along_axis(flat, idx, -1)
        np.testing.assert_array_equal(picked, outs[0].reshape(picked.shape))


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_ceil_mode(kind):
    """``ceil_mode=True`` keeps the last partial window: the reference's
    pool over the input with that window's missing end padded (-inf for
    max; excluded from the average)."""
    jp, tp = both()
    x = rand(2, 3, 7, 9, seed=5)
    got = getattr(tp.nn.functional, f"{kind}_pool2d")(
        tp.to_tensor(x), 2, 2, ceil_mode=True).numpy()
    want = getattr(jp.nn.functional, f"{kind}_pool2d")(
        jp.to_tensor(x), 2, 2, [[0, 1], [0, 1]]).numpy()
    assert got.shape == (2, 3, 4, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_adaptive_max_pool_mask():
    jp, tp = both()
    x = rand(2, 3, 4, 4, seed=6)        # 4 = 2²: the reference's mask holds
    outs = assert_fn_parity(lambda P, x: F(P).adaptive_max_pool2d(
        x, 2, return_mask=True), [x], grad=(0,))
    x = rand(2, 3, 7, 9, seed=7)
    out, mask = tp.nn.functional.adaptive_max_pool2d(tp.to_tensor(x), [3, 4],
                                                     return_mask=True)
    picked = np.take_along_axis(x.reshape(2, 3, -1),
                                mask.numpy().reshape(2, 3, -1), -1)
    np.testing.assert_array_equal(picked, out.numpy().reshape(2, 3, -1))
    assert outs[1].dtype == np.int64 and str(mask.dtype) == "int64"


def test_return_mask_needs_channels_first():
    _, tp = both()
    with pytest.raises(NotImplementedError, match="NC"):
        tp.nn.functional.max_pool2d(tp.to_tensor(X4_NHWC), 2,
                                    return_mask=True, data_format="NHWC")


LAYERS = [
    ("MaxPool1D", lambda P: P.nn.MaxPool1D(3, 2, 1), X3),
    ("MaxPool2D", lambda P: P.nn.MaxPool2D(2, padding="SAME"), X4),
    ("MaxPool3D", lambda P: P.nn.MaxPool3D(2), X5),
    ("AvgPool1D", lambda P: P.nn.AvgPool1D(2, exclusive=False), X3),
    ("AvgPool2D", lambda P: P.nn.AvgPool2D(3, 2, 1), X4),
    ("AvgPool3D", lambda P: P.nn.AvgPool3D(2, 1), X5),
    ("AdaptiveAvgPool1D", lambda P: P.nn.AdaptiveAvgPool1D(3), X3),
    ("AdaptiveAvgPool2D", lambda P: P.nn.AdaptiveAvgPool2D([2, 3]), X4),
    ("AdaptiveAvgPool3D", lambda P: P.nn.AdaptiveAvgPool3D(2), X5),
    ("AdaptiveMaxPool1D", lambda P: P.nn.AdaptiveMaxPool1D(5), X3),
    ("AdaptiveMaxPool2D", lambda P: P.nn.AdaptiveMaxPool2D(3), X4),
    ("AdaptiveMaxPool3D", lambda P: P.nn.AdaptiveMaxPool3D([1, 2, 2]), X5),
]


@pytest.mark.parametrize("make,x", [c[1:] for c in LAYERS],
                         ids=[c[0] for c in LAYERS])
def test_pool_layer(make, x):
    assert_layer_parity(make, [x])


@pytest.mark.parametrize("n,x", [(1, X3), (2, X4), (3, X5)],
                         ids=["1d", "2d", "3d"])
def test_unpool_layer(n, x):
    def call(layer, x):
        pool = getattr(type(layer).__module__ and
                       __import__(type(layer).__module__.split(".")[0]).nn,
                       f"MaxPool{n}D")(2, return_mask=True)
        out, mask = pool(x)
        return layer(out, mask)
    assert_layer_parity(lambda P: getattr(P.nn, f"MaxUnPool{n}D")(2),
                        [x], call=call)
