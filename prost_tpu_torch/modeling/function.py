"""Function factories: each returns a closure ``(idx, count) -> Prox``
(counterpart of ``prost_tpu/modeling/function.py``; matlab/+prost/+function).
The 7-coefficient parametrization is

    c * f_{alpha,beta}(a x - b) + d x + (e/2) x^2

with each coefficient a scalar or a per-instance vector (sum_1d.m).
Array coefficients stay numpy here; ``Problem.create`` (or ``eval_prox``)
turns them into tensors of the working dtype on the way to the device.
The data of the standalone proxes (index sets, halfspaces, epigraphs,
ranges, permutations) become CPU tensors when the prox is made, as the
JAX package makes arrays of them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ProstError, dtype as config_dtype
from ..prox import (
    ProxElem1D,
    ProxElemEigen2x2,
    ProxElemEigenNxN,
    ProxElemIndSimplex,
    ProxElemIndSum,
    ProxElemMassNorm,
    ProxElemNorm2,
    ProxElemSingularNx2,
    ProxIndEpiPolyhedral,
    ProxIndEpiQuad,
    ProxIndHalfspace,
    ProxIndRange,
    ProxIndSOC,
    ProxIndSum,
    ProxMoreau,
    ProxPermute,
    ProxTransform,
    ProxZero,
)


def _coeffs(a, b, c, d, e, alpha, beta):
    def conv(v):
        v = np.asarray(v)
        return float(v) if v.ndim == 0 else v
    return tuple(conv(v) for v in (a, b, c, d, e, alpha, beta))


def zero():
    """f = 0 (prox is the identity)."""
    return lambda idx, count: ProxZero(index=idx, size=count)


def sum_1d(fun, a=1.0, b=0.0, c=1.0, d=0.0, e=0.0, alpha=0.0, beta=0.0):
    """Separable sum of 1D functions (sum_1d.m)."""
    cf = _coeffs(a, b, c, d, e, alpha, beta)
    return lambda idx, count: ProxElem1D(index=idx, size=count, fun=fun,
                                         coeffs=cf)


def sum_norm2(dim, interleaved, fun, a=1.0, b=0.0, c=1.0, d=0.0, e=0.0,
              alpha=0.0, beta=0.0):
    """Separable sum of h(||x||_2) over dim-vectors (sum_norm2.m)."""
    cf = _coeffs(a, b, c, d, e, alpha, beta)

    def make(idx, count):
        if count % dim:
            raise ProstError("sum_norm2: count not divisible by dim.")
        return ProxElemNorm2(index=idx, size=count, count=count // dim,
                             dim=dim, interleaved=interleaved, fun=fun,
                             coeffs=cf)
    return make


def sum_ind_simplex(dim, interleaved):
    """Projection onto the unit simplex per dim-vector (sum_ind_simplex.m)."""
    def make(idx, count):
        if count % dim:
            raise ProstError("sum_ind_simplex: count not divisible by dim.")
        return ProxElemIndSimplex(index=idx, size=count, count=count // dim,
                                  dim=dim, interleaved=interleaved)
    return make


def sum_ind_sum(dim, interleaved):
    """Projection onto {sum_i x_i = 1} per dim-vector (sum_ind_sum.m)."""
    def make(idx, count):
        if count % dim:
            raise ProstError("sum_ind_sum: count not divisible by dim.")
        return ProxElemIndSum(index=idx, size=count, count=count // dim,
                              dim=dim, interleaved=interleaved)
    return make


def sum_ind_sum2(dim, inds, s1, dim2=None, inds2=None, s2=None):
    """Projection onto one or two general index-set sum constraints
    (sum_ind_sum2.m -> the standalone 'ind_sum' prox).  inds are local
    0-based indices, grouped per constraint instance of length dim (resp.
    dim2)."""
    inds = torch.as_tensor(np.asarray(inds, dtype=np.int32).reshape(-1))
    if inds2 is not None:
        inds2 = torch.as_tensor(np.asarray(inds2, dtype=np.int32).reshape(-1))

    def make(idx, count):
        if inds.numel() % dim:
            raise ProstError("sum_ind_sum2: len(inds) not divisible by dim.")
        kw = dict(index=idx, size=count, count=inds.numel() // dim, dim=dim,
                  sum_target=float(s1), inds=inds)
        if inds2 is not None:
            if inds2.numel() % dim2:
                raise ProstError(
                    "sum_ind_sum2: len(inds2) not divisible by dim2.")
            kw.update(count2=inds2.numel() // dim2, dim2=dim2,
                      sum_target2=float(s2), inds2=inds2)
        return ProxIndSum(**kw)
    return make


def sum_ind_soc(dim, interleaved=False, alpha=1.0):
    """Projection onto the second-order cone alpha||x|| <= y
    (sum_ind_soc.m); planar layout, any alpha > 0."""
    if interleaved:
        raise ProstError("sum_ind_soc: only planar layout supported.")

    def make(idx, count):
        if count % dim:
            raise ProstError("sum_ind_soc: count not divisible by dim.")
        return ProxIndSOC(index=idx, size=count, count=count // dim,
                          dim=dim, alpha=alpha)
    return make


def _tensor(v):
    """A flat CPU tensor of the working dtype."""
    return torch.as_tensor(np.asarray(v, dtype=np.float64).reshape(-1),
                           dtype=config_dtype())


def sum_ind_halfspace(dim, interleaved, a, b):
    """Projection onto {<a, x> <= b} per dim-vector (sum_ind_halfspace.m)."""
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    if interleaved:
        raise ProstError("sum_ind_halfspace: only planar layout supported.")

    def make(idx, count):
        if count % dim:
            raise ProstError("sum_ind_halfspace: count not divisible by dim.")
        return ProxIndHalfspace(index=idx, size=count, count=count // dim,
                                dim=dim, a=_tensor(a), b=_tensor(b))
    return make


def sum_ind_epi_quad(dim, interleaved, a, b, c):
    """Projection onto the epigraph of a x^T x + <b, x> + c
    (sum_ind_epi_quad.m)."""
    if interleaved:
        raise ProstError("sum_ind_epi_quad: only planar layout supported.")

    def make(idx, count):
        if count % dim:
            raise ProstError("sum_ind_epi_quad: count not divisible by dim.")
        return ProxIndEpiQuad(index=idx, size=count, count=count // dim,
                              dim=dim, a=_tensor(a), b=_tensor(b),
                              c=_tensor(c))
    return make


def sum_ind_epi_polyhedral(dim, interleaved, coeff_a, coeff_b,
                           count_vec, index_vec, sweeps=400, tol=5e-7,
                           omega=1.7):
    """Projection onto the epigraph of the max-of-affine function
    f(x) = max_i(<a_i, x> - b_i) per dim-vector (dim = d + 1).

    Signature and coefficient layout follow the reference's test
    (test_prox_sum_ind_epi_polyhedral.m:27-30): coeff_a holds, per point,
    count_vec[p] rows of d contiguous coefficients; coeff_b the offsets;
    index_vec[p] is the row offset of point p into both (in rows)."""
    if interleaved:
        raise ProstError(
            "sum_ind_epi_polyhedral: only planar layout supported.")

    d = dim - 1
    coeff_a = np.asarray(coeff_a, dtype=np.float64).reshape(-1)
    coeff_b = np.asarray(coeff_b, dtype=np.float64).reshape(-1)
    count_vec = np.asarray(count_vec, dtype=np.int64).reshape(-1)
    index_vec = np.asarray(index_vec, dtype=np.int64).reshape(-1)

    def make(idx, count):
        if count % dim:
            raise ProstError(
                "sum_ind_epi_polyhedral: count not divisible by dim.")
        n_pts = count // dim
        if count_vec.size != n_pts or index_vec.size != n_pts:
            raise ProstError(
                "sum_ind_epi_polyhedral: count_vec/index_vec must have one "
                f"entry per point ({n_pts}).")
        m_max = int(count_vec.max())
        a = np.zeros((m_max, d, n_pts))
        b = np.zeros((m_max, n_pts))
        mask = np.zeros((m_max, n_pts))
        for p in range(n_pts):
            m_p, off = int(count_vec[p]), int(index_vec[p])
            a[:m_p, :, p] = coeff_a[off * d:(off + m_p) * d].reshape(m_p, d)
            b[:m_p, p] = coeff_b[off:off + m_p]
            mask[:m_p, p] = 1.0
        return ProxIndEpiPolyhedral.create(
            index=idx, size=count, count=n_pts, dim=dim, a=a, b=b,
            mask=mask, sweeps=sweeps, tol=tol, omega=omega)
    return make


def sum_eigen_2x2(interleaved, fun, a=1.0, b=0.0, c=1.0, d=0.0, e=0.0,
                  alpha=0.0, beta=0.0):
    """Spectral prox of symmetric 2x2 matrices, dim=4 (sum_eigen_2x2.m)."""
    cf = _coeffs(a, b, c, d, e, alpha, beta)

    def make(idx, count):
        if count % 4:
            raise ProstError("sum_eigen_2x2: count not divisible by 4.")
        return ProxElemEigen2x2(index=idx, size=count, count=count // 4,
                                interleaved=interleaved, fun=fun, coeffs=cf)
    return make


def sum_eigen_3x3(interleaved, fun, a=1.0, b=0.0, c=1.0, d=0.0, e=0.0,
                  alpha=0.0, beta=0.0):
    """Spectral prox of symmetric 3x3 matrices, dim=9 (sum_eigen_3x3.m)."""
    return sum_eigen_nxn(3, interleaved, fun, a, b, c, d, e, alpha, beta)


def sum_eigen_nxn(n, interleaved, fun, a=1.0, b=0.0, c=1.0, d=0.0, e=0.0,
                  alpha=0.0, beta=0.0):
    """Spectral prox of symmetric n x n matrices, dim=n*n
    (sum_eigen_nxn.m; no cap on n)."""
    cf = _coeffs(a, b, c, d, e, alpha, beta)

    def make(idx, count):
        if count % (n * n):
            raise ProstError(f"sum_eigen_nxn: count not divisible by {n*n}.")
        return ProxElemEigenNxN(index=idx, size=count,
                                count=count // (n * n), n=n,
                                interleaved=interleaved, fun=fun, coeffs=cf)
    return make


def sum_singular_nx2(dim, interleaved, fun, a=1.0, b=0.0, c=1.0, d=0.0,
                     e=0.0, alpha=0.0, beta=0.0):
    """Prox on the two singular values of a (dim/2) x 2 matrix per vector
    (sum_singular_nx2.m).  fun keys FUN_2D, e.g. 'sum_1d:abs',
    'ind_l1_ball', 'moreau:ind_l1_ball'."""
    cf = _coeffs(a, b, c, d, e, alpha, beta)

    def make(idx, count):
        if count % dim:
            raise ProstError("sum_singular_nx2: count not divisible by dim.")
        return ProxElemSingularNx2(index=idx, size=count,
                                   count=count // dim, dim=dim,
                                   interleaved=interleaved, fun=fun,
                                   coeffs=cf)
    return make


def sum_mass_norm(n, interleaved, cost=1.0):
    """Mass norm of a 2-vector in R^n, n in {4, 5} (sum_mass_norm.m)."""
    return _mass(n, interleaved, conjugate=False, cost=cost)


def sum_ind_comass_ball(n, interleaved):
    """Indicator of the comass-norm unit ball (sum_ind_comass_ball.m)."""
    return _mass(n, interleaved, conjugate=True, cost=1.0)


def _mass(n, interleaved, conjugate, cost):
    if n not in (4, 5):
        raise ProstError("mass norm: only n in {4, 5} supported.")
    dim = 6 if n == 4 else 10

    def make(idx, count):
        if count % dim:
            raise ProstError(f"mass norm: count not divisible by {dim}.")
        return ProxElemMassNorm(index=idx, size=count, count=count // dim,
                                n=n, interleaved=interleaved,
                                conjugate=conjugate, cost=cost)
    return make


def ind_range(A, AA=None):
    """Projection onto range(A): x = A (A^T A)^{-1} A^T y (ind_range.m).

    A may be dense or scipy.sparse / a torch sparse tensor; a sparse A is
    kept sparse (the reference's contract: 'A must be a sparse matrix');
    AA = A^T A may be precomputed."""
    rows = A.shape[0] if hasattr(A, "shape") else len(A)

    def make(idx, count):
        if int(rows) != count:
            raise ProstError("ind_range: A has wrong number of rows.")
        return ProxIndRange.create(idx, count, A, AA)
    return make


def conjugate(fun):
    """Convex conjugate via Moreau's identity (conjugate.m)."""
    def make(idx, count):
        inner = fun(idx, count)
        return ProxMoreau(index=idx, size=count, child=inner)
    return make


def transform(fun, a=1.0, b=0.0, c=1.0, d=0.0, e=0.0):
    """c * f(a x - b) + d x + (e/2) x^2 around any function
    (transform.m)."""
    def make(idx, count):
        inner = fun(idx, count)
        return ProxTransform(index=idx, size=count, child=inner,
                             a=a, b=b, c=c, d=d, e=e)
    return make


def permute(fun, perm):
    """f(P x) for a permutation given by local 0-based indices (permute.m,
    which takes 1-based MATLAB indices)."""
    perm = torch.as_tensor(np.ascontiguousarray(perm, dtype=np.int64).reshape(-1))

    def make(idx, count):
        if perm.numel() != count:
            raise ProstError("permute: permutation has wrong size.")
        inner = fun(idx, count)
        return ProxPermute(index=idx, size=count, child=inner, perm=perm)
    return make
