"""Linear algebra: the port of ``paddle_tpu/tensor/linalg.py``. The
products are torch's matmul (cuBLAS on the card); the decompositions map
onto ``torch.linalg``. The reference computes ``eig``, ``eigvals``,
``histogram`` and ``bincount`` on the host with numpy; here ``eig`` and
``eigvals`` run in ``torch.linalg`` on the tensor's device and the two
counts stay on the host, as there."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def fn(a, b):
        if transpose_x and a.dim() >= 2:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() >= 2:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply_op("matmul", fn, x, y)


def mm(input, mat2, name=None):  # noqa: A002
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def dot(x, y, name=None):
    return apply_op("dot", lambda a, b: torch.sum(a * b, -1), x, y)


def mv(x, vec, name=None):
    return apply_op("mv", torch.matmul, x, vec)


def t(input, name=None):  # noqa: A002
    return apply_op("t", lambda a: a.t() if a.dim() == 2 else a, input)


def transpose_last2(x):
    return apply_op("T", lambda a: a.transpose(-1, -2), x)


def _ax(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    def fn(a):
        ax = _ax(axis)
        if p == "fro" or (p == 2 and axis is None):
            if ax is None:
                return torch.sqrt(torch.sum(torch.square(a)))
            if isinstance(ax, tuple):
                return torch.linalg.matrix_norm(a, "fro", ax, keepdim)
            return torch.linalg.vector_norm(a, 2, ax, keepdim)
        dims = ax if ax is not None else tuple(range(a.dim()))
        if p in (np.inf, float("inf")):
            return torch.amax(torch.abs(a), dim=dims, keepdim=keepdim)
        if p in (-np.inf, float("-inf")):
            return torch.amin(torch.abs(a), dim=dims, keepdim=keepdim)
        if p == 0:
            return torch.sum((a != 0).to(a.dtype), dim=dims, keepdim=keepdim)
        return torch.sum(torch.abs(a) ** p, dim=dims,
                         keepdim=keepdim) ** (1.0 / p)
    return apply_op("norm", fn, x)


def dist(x, y, p=2, name=None):
    def fn(a, b):
        d = a - b
        if p == 0:
            return torch.sum((d != 0).to(d.dtype))
        if p == float("inf"):
            return torch.amax(torch.abs(d))
        if p == float("-inf"):
            return torch.amin(torch.abs(d))
        return torch.sum(torch.abs(d) ** p) ** (1.0 / p)
    return apply_op("dist", fn, x, y)


def cond(x, p=None, name=None):
    return apply_op("cond", lambda a: torch.linalg.cond(a, p), x)


def cholesky(x, upper=False, name=None):
    return apply_op("cholesky", lambda a: torch.linalg.cholesky(
        a, upper=upper), x)


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A out = x`` from ``A``'s Cholesky factor ``y``: two
    triangular solves, which read only the factor's triangle (so its other
    triangle gets no gradient, as in the reference)."""
    def fn(b, L):
        Lm = L.transpose(-1, -2).conj() if upper else L
        z = torch.linalg.solve_triangular(Lm, b, upper=False)
        return torch.linalg.solve_triangular(Lm.transpose(-1, -2).conj(), z,
                                             upper=True)
    return apply_op("cholesky_solve", fn, x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def fn(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)
    return apply_op("triangular_solve", fn, x, y)


def solve(x, y, name=None):
    return apply_op("solve", torch.linalg.solve, x, y)


def lstsq(x, y, rcond=None, driver=None, name=None):
    def fn(a, b):
        r = torch.linalg.lstsq(a, b, rcond=rcond,
                               driver=driver or ("gelsd" if a.device.type
                                                 == "cpu" else None))
        return r.solution, r.residuals, r.rank, r.singular_values
    return apply_op("lstsq", fn, x, y)


def inv(x, name=None):
    return apply_op("inv", torch.linalg.inv, x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply_op("pinv", lambda a: torch.linalg.pinv(
        a, rtol=rcond, hermitian=hermitian), x)


def det(x, name=None):
    return apply_op("det", torch.linalg.det, x)


def slogdet(x, name=None):
    def fn(a):
        s, ld = torch.linalg.slogdet(a)
        return torch.stack([s, ld])
    return apply_op("slogdet", fn, x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply_op("matrix_rank", lambda a: torch.linalg.matrix_rank(
        a, atol=tol, hermitian=hermitian), x)


def matrix_power(x, n, name=None):
    return apply_op("matrix_power", lambda a: torch.linalg.matrix_power(a, n),
                    x)


def qr(x, mode="reduced", name=None):
    def fn(a):
        q, r = torch.linalg.qr(a, mode=mode)
        return r if mode == "r" else (q, r)
    return apply_op("qr", fn, x)


def svd(x, full_matrices=False, name=None):
    return apply_op("svd", lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), x)


def eig(x, name=None):
    return apply_op("eig", lambda a: tuple(torch.linalg.eig(a)), x)


def eigh(x, UPLO="L", name=None):
    return apply_op("eigh", lambda a: tuple(torch.linalg.eigh(a, UPLO)), x)


def eigvals(x, name=None):
    return apply_op("eigvals", torch.linalg.eigvals, x)


def eigvalsh(x, UPLO="L", name=None):
    return apply_op("eigvalsh", lambda a: torch.linalg.eigvalsh(a, UPLO), x)


def lu(x, pivot=True, get_infos=False, name=None):
    """``(LU, pivots)`` with LAPACK's 1-based int32 pivots (and a zero
    info tensor with ``get_infos``)."""
    def fn(a):
        lu_mat, piv = torch.linalg.lu_factor(a, pivot=pivot)
        return lu_mat, piv.to(torch.int32)
    outs = apply_op("lu", fn, x)
    if get_infos:
        info = Tensor._wrap(torch.zeros((), dtype=torch.int32,
                                        device=outs[0]._data.device))
        return outs[0], outs[1], info
    return outs


def multi_dot(tensors, name=None):
    return apply_op("multi_dot", lambda *xs: torch.linalg.multi_dot(xs),
                    *tensors)


def cross(x, y, axis=9, name=None):
    def fn(a, b):
        ax = axis
        if ax == 9:
            ax = next(i for i, d in enumerate(a.shape) if d == 3)
        return torch.linalg.cross(a, b, dim=ax)
    return apply_op("cross", fn, x, y)


def _host(t) -> np.ndarray:
    return t.numpy() if isinstance(t, Tensor) else np.asarray(t)


def _back(like, arr) -> Tensor:
    dev = like._data.device if isinstance(like, Tensor) else None
    return Tensor(torch.from_numpy(np.array(arr)).to(dev))


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    arr = _host(input)
    lo, hi = (min, max) if (min != 0 or max != 0) else (arr.min(), arr.max())
    h, _ = np.histogram(arr, bins=bins, range=(lo, hi))
    return _back(input, h.astype(np.int64))


def bincount(x, weights=None, minlength=0, name=None):
    w = _host(weights) if weights is not None else None
    return _back(x, np.bincount(_host(x), weights=w, minlength=minlength))


def corrcoef(x, rowvar=True, name=None):
    return apply_op("corrcoef", lambda a: torch.corrcoef(
        a if rowvar else a.t()), x)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply_op("cov", lambda a: torch.cov(a if rowvar else a.t(),
                                               correction=1 if ddof else 0),
                    x)


def matrix_exp(x, name=None):
    return apply_op("matrix_exp", torch.linalg.matrix_exp, x)


def householder_product(x, tau, name=None):
    return apply_op("householder_product", torch.linalg.householder_product,
                    x, tau)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """The exact thin SVD of the (centred) input, truncated to ``q``
    (default 6), as the reference computes it."""
    def fn(a):
        qq = q if q is not None else min(6, a.shape[-2], a.shape[-1])
        b = a - a.mean(-2, keepdim=True) if center else a
        u, s, vh = torch.linalg.svd(b, full_matrices=False)
        return u[..., :qq], s[..., :qq], vh.transpose(-1, -2)[..., :qq]
    return apply_op("pca_lowrank", fn, x)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``(P, L, U)`` from :func:`lu`'s results (None for the parts not
    unpacked)."""
    P, L, U = apply_op("lu_unpack", lambda a, piv: tuple(torch.lu_unpack(
        a, piv.to(torch.int32))), x, y)
    return (P if unpack_pivots else None, L if unpack_ludata else None,
            U if unpack_ludata else None)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return apply_op("matrix_norm", lambda a: torch.linalg.matrix_norm(
        a, p, tuple(axis), keepdim), x)


def svd_lowrank(x, q=None, niter=2, M=None, name=None):
    """The exact thin SVD of ``x - M`` truncated to ``q`` (default 6), as
    the reference computes it."""
    def fn(a, *m):
        b = a - m[0] if m else a
        u, s, vh = torch.linalg.svd(b, full_matrices=False)
        k = min(q if q is not None else 6, s.shape[-1])
        return u[..., :k], s[..., :k], vh.transpose(-1, -2)[..., :k]
    if M is not None:
        return apply_op("svd_lowrank", fn, x, M)
    return apply_op("svd_lowrank", fn, x)


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    return apply_op("ormqr", lambda a, t_, o: torch.ormqr(
        a, t_, o, left=left, transpose=transpose), x, tau, y)
