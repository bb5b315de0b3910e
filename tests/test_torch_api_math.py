"""The Paddle API's math and statistics ops (``paddle.tensor.math``,
``paddle.tensor.stat``) against the JAX package's, one case per op
(``test_torch_api_util.check``: forward, gradient, method, in-place)."""
import numpy as np

from test_torch_api_util import Case, check, f32, i64, parametrize

X = f32(3, 4)
Y = f32(3, 4, seed=1)
POS = f32(3, 4, seed=2, lo=0.5, hi=2.0)
UNIT = f32(3, 4, seed=3, lo=-0.9, hi=0.9)
BIG = f32(3, 4, seed=4, lo=1.1, hi=3.0)
INTS = i64(3, 4, lo=1, hi=9)
INTS2 = i64(3, 4, seed=1, lo=1, hi=9)

UNARY = [
    ("abs", X), ("neg", X), ("exp", X), ("expm1", X), ("log", POS),
    ("log2", POS), ("log10", POS), ("log1p", POS), ("sqrt", POS),
    ("rsqrt", POS), ("square", X), ("sin", X), ("cos", X), ("tan", X),
    ("asin", UNIT), ("acos", UNIT), ("atan", X), ("sinh", X), ("cosh", X),
    ("tanh", X), ("asinh", X), ("acosh", BIG), ("atanh", UNIT),
    ("reciprocal", POS), ("erf", X), ("erfinv", UNIT), ("digamma", POS),
    ("lgamma", POS), ("frac", X * 3), ("deg2rad", X), ("rad2deg", X),
    ("i0", X), ("i1", X), ("sgn", X), ("stanh", X),
]
UNARY_NOGRAD = [
    ("floor", X * 3), ("ceil", X * 3), ("round", X * 3), ("trunc", X * 3),
    ("sign", X), ("isfinite", X), ("isnan", X), ("isinf", X),
    ("real", X), ("imag", X), ("angle", X), ("conj", X),
]
BINARY = [
    ("add", X, Y), ("subtract", X, Y), ("multiply", X, Y),
    ("divide", X, POS), ("maximum", X, Y), ("minimum", X, Y),
    ("fmax", X, Y), ("fmin", X, Y), ("atan2", X, Y), ("pow", POS, Y),
    ("logaddexp", X, Y), ("hypot", X, Y), ("copysign", X, Y),
    ("remainder", X * 3, POS), ("mod", X * 3, POS), ("floor_mod", X * 3, POS),
    ("divide_no_nan", X, np.where(Y > 0.5, 0, Y).astype(np.float32)),
]
BINARY_NOGRAD = [
    ("floor_divide", X * 3, POS), ("heaviside", X, Y), ("nextafter", X, Y),
    ("gcd", INTS, INTS2), ("lcm", INTS, INTS2),
]

CASES = [Case(n, a) for n, a in UNARY]
CASES += [Case(n, a, grad=False) for n, a in UNARY_NOGRAD]
CASES += [Case(n, a, b) for n, a, b in BINARY]
CASES += [Case(n, a, b, grad=False) for n, a, b in BINARY_NOGRAD]
CASES += [
    Case("add", X, 2.5, cid="add_scalar"),
    Case("add", INTS, INTS2, grad=False, cid="add_int"),
    Case("scale", X, scale=2.0, bias=0.5),
    Case("scale", X, scale=2.0, bias=0.5, bias_after_scale=False,
         cid="scale_before"),
    Case("clip", X, min=-0.3, max=0.4),
    Case("lerp", X, Y, 0.3),
    Case("increment", X, value=2.0, grad=False, method=False),
    Case("multiplex", call=lambda P, a, b, i: P.multiplex([a, b], i),
         *[X, Y, np.array([[0], [1], [0]], np.int32)]),
    Case("logit", POS / 3, eps=1e-3),
    Case("renorm", X, p=2.0, axis=0, max_norm=0.5),
    Case("add_n", call=lambda P, a, b: P.add_n([a, b]), *[X, Y]),
    Case("nan_to_num", np.array([1.0, np.nan, np.inf, -np.inf], np.float32),
         posinf=9.0, neginf=-9.0),
    Case("take", X, np.array([0, 5, -1], np.int64), grad=True),
    Case("frexp", X * 10, grad=False),
    Case("polar", POS, X, grad=False),
    Case("broadcast_shape", call=lambda P: P.broadcast_shape([3, 1], [1, 4]),
         grad=False),
    # reductions
    Case("sum", X), Case("sum", X, axis=1, cid="sum_axis"),
    Case("sum", X, axis=[0, 1], keepdim=True, cid="sum_keepdim"),
    Case("sum", INTS, axis=0, grad=False, cid="sum_int"),
    Case("mean", X, axis=-1), Case("mean", X, cid="mean_all"),
    Case("prod", POS, axis=1), Case("max", X, axis=0), Case("min", X),
    Case("amax", X, axis=1, keepdim=True), Case("amin", X, axis=0),
    Case("nansum", np.where(X > 0.5, np.nan, X).astype(np.float32), axis=1),
    Case("nanmean", np.where(X > 0.5, np.nan, X).astype(np.float32),
         axis=0),
    Case("logsumexp", X, axis=1),
    Case("cumsum", X, axis=1), Case("cumsum", X, cid="cumsum_flat"),
    Case("cumprod", POS, dim=0),
    Case("cummax", X, axis=1), Case("cummin", X, axis=0),
    Case("logcumsumexp", X, axis=1),
    Case("count_nonzero", np.where(X > 0, X, 0).astype(np.float32), axis=1,
         grad=False),
    Case("diff", X, axis=1),
    Case("trapezoid", X, dx=0.5), Case("cumulative_trapezoid", X, dx=0.5),
    Case("addmm", f32(3, 3), X, f32(4, 3, seed=5), beta=0.5, alpha=2.0),
    Case("inner", X, Y), Case("outer", X[0], Y[0]), Case("kron", X[:2],
                                                        Y[:2, :2]),
    Case("inverse", f32(3, 3) + 3 * np.eye(3, dtype=np.float32)),
    Case("trace", f32(4, 4)), Case("diagonal", f32(4, 4), offset=1),
    # statistics
    Case("var", X, axis=1), Case("std", X, unbiased=False),
    Case("median", X, axis=1), Case("median", f32(3, 5), mode="min",
                                    axis=1, grad=False, cid="median_min"),
    Case("nanmedian", np.where(X > 0.5, np.nan, X).astype(np.float32),
         axis=1, grad=False),
    Case("quantile", X, 0.3, axis=1), Case("nanquantile", X, 0.7, axis=0,
                                           grad=False),
]


@parametrize(CASES)
def test_math_op_matches_jax(case):
    check(case)
