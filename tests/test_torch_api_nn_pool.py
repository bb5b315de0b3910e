"""The pool functionals of the port (max and average in 1-D, 2-D and 3-D,
adaptive) against the JAX package's, on the same numpy inputs: forward and
the gradient of the input, float32 within 1e-5 relative and 1e-6 absolute
(``torch_nn_parity``). ``test_torch_api_nn_pool_layers.py`` holds the
masks, the unpools, ``ceil_mode`` and the layers."""
import pytest

from torch_nn_parity import assert_fn_parity, rand

X3 = rand(2, 3, 11, seed=1)
X4 = rand(2, 3, 7, 8, seed=2)
X5 = rand(1, 2, 5, 6, 4, seed=3)
X4_NHWC = rand(2, 7, 8, 3, seed=4)


def F(P):
    return P.nn.functional


POOLS = [
    ("max1d", lambda P, x: F(P).max_pool1d(x, 3, 2, 1), X3),
    ("max1d_same", lambda P, x: F(P).max_pool1d(x, 4, 3, "SAME"), X3),
    ("max2d", lambda P, x: F(P).max_pool2d(x, 3, 2, 1), X4),
    ("max2d_pairs", lambda P, x: F(P).max_pool2d(x, [2, 3], 1,
                                                 [[0, 1], [2, 0]]), X4),
    ("max2d_nhwc", lambda P, x: F(P).max_pool2d(
        x, 2, padding="SAME", data_format="NHWC"), X4_NHWC),
    ("max3d", lambda P, x: F(P).max_pool3d(x, 2, 2, [1, 0, 1]), X5),
    ("avg1d", lambda P, x: F(P).avg_pool1d(x, 3, 2, 1), X3),
    ("avg1d_inclusive", lambda P, x: F(P).avg_pool1d(x, 3, 2, 1,
                                                     exclusive=False), X3),
    ("avg2d", lambda P, x: F(P).avg_pool2d(x, 3, 2, 1), X4),
    ("avg2d_same_inclusive", lambda P, x: F(P).avg_pool2d(
        x, [3, 2], 2, "SAME", exclusive=False), X4),
    ("avg2d_nhwc", lambda P, x: F(P).avg_pool2d(
        x, 3, 1, 1, data_format="NHWC"), X4_NHWC),
    ("avg3d", lambda P, x: F(P).avg_pool3d(x, [2, 3, 2], 1, 1), X5),
    ("adaptive_avg1d", lambda P, x: F(P).adaptive_avg_pool1d(x, 4), X3),
    ("adaptive_avg2d", lambda P, x: F(P).adaptive_avg_pool2d(x, [3, 5]),
     X4),
    ("adaptive_avg2d_nhwc", lambda P, x: F(P).adaptive_avg_pool2d(
        x, [3, 4], "NHWC"), X4_NHWC),
    ("adaptive_avg3d", lambda P, x: F(P).adaptive_avg_pool3d(x, [2, 3, 3]),
     X5),
    ("adaptive_max1d", lambda P, x: F(P).adaptive_max_pool1d(x, 4), X3),
    ("adaptive_max2d", lambda P, x: F(P).adaptive_max_pool2d(x, [3, 5]),
     X4),
    ("adaptive_max3d", lambda P, x: F(P).adaptive_max_pool3d(x, 2), X5),
]


@pytest.mark.parametrize("fn,x", [c[1:] for c in POOLS],
                         ids=[c[0] for c in POOLS])
def test_pool_functional(fn, x):
    assert_fn_parity(fn, [x], grad=(0,))
