"""The Paddle API's comparison, logical and linear-algebra ops
(``paddle.tensor.logic``, ``linalg``, ``einsum``) against the JAX package's,
one case per op (``test_torch_api_util.check``: forward, gradient, method,
in-place). Decompositions whose factors are not unique (signs of QR's and
SVD's columns, the order and phase of eigenvectors) are held on invariants:
the reconstruction and the sorted eigen- or singular values."""
import numpy as np

from test_torch_api_util import Case, check, f32, i64, parametrize

X = f32(3, 4)
Y = f32(3, 4, seed=1)
I = i64(3, 4, hi=16)
J = i64(3, 4, seed=1, hi=16)
B = X > 0
C = Y > 0
A = f32(4, 4, seed=2) + 4 * np.eye(4, dtype=np.float32)
SPD = (A @ A.T / 4).astype(np.float32)
V3 = f32(2, 3, seed=3)
W3 = f32(2, 3, seed=4)


def _svd_inv(P, a):
    u, s, vh = P.svd(a)
    return P.matmul(u * s.unsqueeze(0), vh), s


def _qr_inv(P, a):
    q, r = P.qr(a)
    return P.matmul(q, r), P.abs(P.diagonal(r))


def _eig_inv(P, a):
    w, v = P.eig(a)
    return P.sort(P.real(w)), P.sort(P.imag(w))


def _eigh_inv(P, a):
    w, v = P.eigh(a)
    return w, P.matmul(v * w.unsqueeze(0), v.T)


def _lu_inv(P, a):
    lu, piv = P.lu(a)
    p, lo, up = P.lu_unpack(lu, piv)
    return P.matmul(p, P.matmul(lo, up)), piv


CASES = [
    # comparison and logic
    Case("equal", X, Y, grad=False), Case("not_equal", I, J, grad=False),
    Case("greater_than", X, Y, grad=False),
    Case("greater_equal", I, J, grad=False),
    Case("less_than", X, 0.2, grad=False),
    Case("less_equal", I, J, grad=False),
    Case("logical_and", B, C, grad=False), Case("logical_or", B, C,
                                                grad=False),
    Case("logical_xor", B, C, grad=False), Case("logical_not", B,
                                                grad=False),
    Case("bitwise_and", I, J, grad=False), Case("bitwise_or", I, J,
                                                grad=False),
    Case("bitwise_xor", I, J, grad=False), Case("bitwise_not", I,
                                                grad=False),
    Case("bitwise_left_shift", I, i64(3, 4, hi=3), grad=False),
    Case("bitwise_right_shift", I, i64(3, 4, hi=3), grad=False),
    Case("equal_all", X, X.copy(), grad=False),
    Case("allclose", X, X + 1e-7, grad=False),
    Case("isclose", X, Y, atol=0.5, grad=False),
    Case("all", B, axis=1, grad=False), Case("any", B, grad=False),
    Case("is_empty", X, grad=False), Case("is_tensor", X, grad=False),
    Case("is_complex", X, grad=False), Case("is_integer", I, grad=False),
    Case("is_floating_point", X, grad=False),
    # products
    Case("matmul", X, f32(4, 5, seed=5)),
    Case("matmul", X, Y, transpose_y=True, cid="matmul_transpose_y"),
    Case("matmul", f32(2, 3, 4), f32(2, 4, 2, seed=6), cid="matmul_batched"),
    Case("mm", X, f32(4, 2, seed=7)), Case("bmm", f32(2, 3, 4),
                                           f32(2, 4, 2, seed=8)),
    Case("dot", X, Y), Case("mv", X, f32(4, seed=9)),
    Case("t", X), Case("transpose_last2", f32(2, 3, 4), method=False),
    Case("multi_dot", call=lambda P, a, b, c: P.multi_dot([a, b, c]),
         *[X, f32(4, 2), f32(2, 3)]),
    Case("multi_dot", call=lambda P, a, b: P.multi_dot([a, b]),
         *[X, f32(4, 2)], cid="multi_dot_two"),
    Case("einsum", call=lambda P, a, b: P.einsum("ij,kj->ik", a, b),
         *[X, Y]),
    Case("cross", V3, W3), Case("kron", X[:2, :2], Y[:2, :3],
                                cid="kron_linalg"),
    # norms
    Case("norm", X), Case("norm", X, p=1, axis=1, cid="norm_p1"),
    Case("norm", X, p=2, axis=0, keepdim=True, cid="norm_axis"),
    Case("norm", X, p=float("inf"), axis=1, cid="norm_inf"),
    Case("vector_norm", X, p=3.0, axis=1),
    Case("matrix_norm", X), Case("dist", X, Y, p=2),
    Case("cond", A, grad=False),
    # solves and inverses
    Case("inv", A), Case("det", A), Case("slogdet", A),
    Case("solve", A, f32(4, 2, seed=10)),
    Case("triangular_solve", np.triu(A), f32(4, 2, seed=11), upper=True),
    Case("cholesky", SPD), Case("cholesky_solve", f32(4, 2, seed=12),
                                np.linalg.cholesky(SPD).astype(np.float32)),
    Case("lstsq", call=lambda P, a, b: P.lstsq(a, b)[0],
         *[f32(5, 3, seed=13), f32(5, 2, seed=14)], grad=False),
    Case("pinv", f32(4, 3, seed=15), grad=False),
    Case("matrix_power", A, 3), Case("matrix_exp", A / 4, grad=False),
    Case("matrix_rank", A, grad=False),
    # decompositions, by their invariants
    Case("svd", call=_svd_inv, *[f32(4, 3, seed=16)], grad=False),
    Case("qr", call=_qr_inv, *[f32(4, 3, seed=17)], grad=False),
    Case("eig", call=_eig_inv, *[A], grad=False),
    Case("eigvals", call=lambda P, a: P.sort(P.real(P.eigvals(a))), *[A],
         grad=False),
    Case("eigh", call=_eigh_inv, *[SPD], grad=False),
    Case("eigvalsh", SPD, grad=False),
    Case("lu", call=_lu_inv, *[A], grad=False),
    Case("lu_unpack", call=lambda P, a: P.lu_unpack(*P.lu(a))[1], *[A],
         grad=False),
    Case("householder_product", f32(4, 3, seed=18),
         np.array([1.2, 0.5, 0.0], np.float32), grad=False),
    Case("ormqr", f32(4, 3, seed=19), np.array([1.1, 0.7, 0.0], np.float32),
         f32(4, 2, seed=20), grad=False),
    Case("pca_lowrank", call=lambda P, a: P.pca_lowrank(a, q=2)[1],
         *[f32(6, 4, seed=21)], grad=False),
    Case("svd_lowrank", call=lambda P, a: P.svd_lowrank(a, q=2)[1],
         *[f32(6, 4, seed=22)], grad=False),
    # statistics of linalg
    Case("corrcoef", X, grad=False), Case("cov", X),
    Case("histogram", X, bins=4, min=-1, max=1, grad=False),
    Case("bincount", i64(8, hi=5), grad=False),
]


@parametrize(CASES)
def test_logic_linalg_op_matches_jax(case):
    check(case)
