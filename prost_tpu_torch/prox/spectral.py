"""Spectral prox operators: functions of the eigenvalues or singular values
of small matrices stored per vector in the flat variable (counterpart of
``prost_tpu/prox/spectral.py``).

Every decomposition is batched: a closed form for the symmetric 2x2 and the
N x 2 singular values, and one ``torch.linalg.eigh`` over the (count, n, n)
stack otherwise.  The outputs are functions of the spectra, so they do not
depend on the eigenvectors' signs or on the basis chosen within a repeated
eigenvalue, which differ between solvers (the CPU's LAPACK, the card's).

The skew-symmetric (mass-norm) decomposition: for skew M, M M^T = -M^2 is
symmetric PSD with doubly-degenerate eigenvalues sigma^2; picking a unit
eigenvector u per plane and v = M u / sigma gives
M = sum_k sigma_k (v_k u_k^T - u_k v_k^T), on which the shrink (mass prox)
or clamp (comass-ball projection) acts.
"""

from __future__ import annotations

import dataclasses

import torch

from .base import ProxSeparableSum, effective_tau
from .elemop import _where, scaled_fun_1d
from .fun1d import FUN_1D
from .fun2d import FUN_2D


def scaled_fun_2d(fun, y1, y2, tau, coeffs):
    """2D analog of scaled_fun_1d: prox of c*f(a*(s1,s2) - b) + d*s +
    e/2 s^2 applied through a 2D base function."""
    a, b, c, d, e, alpha, beta = coeffs
    degenerate = (a == 0.0) | (c == 0.0)
    safe_a = _where(degenerate, 1.0, a, y1)

    denom = 1.0 + tau * e
    lin1 = (y1 - tau * d) / denom
    lin2 = (y2 - tau * d) / denom

    p1 = (safe_a * (y1 - d * tau)) / denom - b
    p2 = (safe_a * (y2 - d * tau)) / denom - b
    step = (c * safe_a * safe_a * tau) / denom
    x1, x2 = fun(p1, p2, step, alpha, beta)
    x1 = (x1 + b) / safe_a
    x2 = (x2 + b) / safe_a

    return (_where(degenerate, lin1, x1, y1),
            _where(degenerate, lin2, x2, y1))


def _eig_sym_2x2(a11, a12, a22):
    """Closed-form eigendecomposition of symmetric 2x2 matrices
    ([[a11, a12], [a12, a22]]), batched.  Returns (rt1, rt2, cs, sn) with
    rt1 >= rt2 and first eigenvector (cs, sn)."""
    tr = a11 + a22
    df = a11 - a22
    rad = torch.sqrt(df * df + 4.0 * a12 * a12)
    rt1 = 0.5 * (tr + rad)
    rt2 = 0.5 * (tr - rad)

    # eigenvector for rt1: (rt1 - a22, a12)
    v1 = rt1 - a22
    v2 = a12
    nrm = torch.sqrt(v1 * v1 + v2 * v2)
    safe = nrm > 0
    safe_nrm = _where(safe, nrm, 1.0, nrm)
    cs = _where(safe, v1 / safe_nrm, 1.0, nrm)
    sn = _where(safe, v2 / safe_nrm, 0.0, nrm)
    return rt1, rt2, cs, sn


@dataclasses.dataclass(eq=False)
class ProxElemEigen2x2(ProxSeparableSum):
    """Spectral prox of symmetric 2x2 matrices (dim=4, stored row-major
    per vector; the input is symmetrized (arg + arg^T)/2)."""

    index: int
    size: int
    count: int
    interleaved: bool
    fun: str
    coeffs: tuple = ()

    @property
    def dim(self):
        return 4

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)  # (4, count)
        tau = effective_tau(self.vector_tau(tau_diag), tau_scal, invert_tau)

        a11, a12 = vecs[0], (vecs[1] + vecs[2]) / 2.0
        a22 = vecs[3]
        rt1, rt2, cs, sn = _eig_sym_2x2(a11, a12, a22)

        f = FUN_1D[self.fun]
        s1 = scaled_fun_1d(f, rt1, tau, self.coeffs)
        s2 = scaled_fun_1d(f, rt2, tau, self.coeffs)

        t11 = s1 * cs * cs + s2 * sn * sn
        t12 = s1 * cs * sn - s2 * sn * cs
        t22 = s1 * sn * sn + s2 * cs * cs
        return self.from_vectors(torch.stack([t11, t12, t12, t22]))


def _spectral_prox_nxn(mats, taus, fun, coeffs):
    """Batched spectral prox: eigh each (n, n) symmetric matrix, prox the
    eigenvalues, reconstruct.  mats: (count, n, n); taus: (count,)."""
    sym = (mats + mats.transpose(-1, -2)) / 2.0
    evals, evecs = torch.linalg.eigh(sym)  # (count, n), (count, n, n)
    s = scaled_fun_1d(fun, evals, taus[:, None], coeffs)
    return torch.einsum("cij,cj,ckj->cik", evecs, s, evecs)


@dataclasses.dataclass(eq=False)
class ProxElemEigenNxN(ProxSeparableSum):
    """Spectral prox of symmetric n x n matrices (dim = n*n, row-major per
    vector), covering the reference's eigen_3x3 and eigen_nxn as one
    batched eigh, with no cap on n."""

    index: int
    size: int
    count: int
    n: int
    interleaved: bool
    fun: str
    coeffs: tuple = ()

    @property
    def dim(self):
        return self.n * self.n

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)  # (n*n, count)
        tau = effective_tau(self.vector_tau(tau_diag), tau_scal, invert_tau)
        tau = torch.broadcast_to(torch.as_tensor(tau, dtype=arg.dtype,
                                                 device=arg.device),
                                 (self.count,))
        mats = vecs.T.reshape(self.count, self.n, self.n)
        out = _spectral_prox_nxn(mats, tau, FUN_1D[self.fun], self.coeffs)
        return self.from_vectors(out.reshape(self.count, self.dim).T)


@dataclasses.dataclass(eq=False)
class ProxElemSingularNx2(ProxSeparableSum):
    """Prox acting on the two singular values of an N x 2 matrix per
    vector (elem_operation_singular_nx2.hpp): the layout is the two columns
    concatenated, dim = 2*N.  The 2D base function (FUN_2D) receives
    (smax, smin)."""

    index: int
    size: int
    count: int
    dim: int
    interleaved: bool
    fun: str  # key into FUN_2D
    coeffs: tuple = ()

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)  # (2n, count)
        n = self.dim // 2
        tau = effective_tau(self.vector_tau(tau_diag), tau_scal, invert_tau)

        a, b = vecs[:n], vecs[n:]
        d11 = torch.sum(a * a, dim=0)
        d12 = torch.sum(a * b, dim=0)
        d22 = torch.sum(b * b, dim=0)

        trace = d11 + d22
        det = d11 * d22 - d12 * d12
        disc = torch.sqrt(torch.clamp(0.25 * trace * trace - det, min=0.0))
        lmax = torch.clamp(0.5 * trace + disc, min=0.0)
        lmin = torch.clamp(0.5 * trace - disc, min=0.0)
        smax, smin = torch.sqrt(lmax), torch.sqrt(lmin)

        s1, s2 = scaled_fun_2d(FUN_2D[self.fun], smax, smin, tau,
                               self.coeffs)

        # eigenvectors of A^T A (2x2): (v11,v21) for lmax, (v12,v22) for lmin
        off = d12 != 0.0
        w11, w21 = lmax - d22, d12
        l1 = torch.sqrt(w11 * w11 + w21 * w21)
        l1s = _where(l1 > 0, l1, 1.0, l1)
        w12, w22 = lmin - d22, d12
        l2 = torch.sqrt(w12 * w12 + w22 * w22)
        l2s = _where(l2 > 0, l2, 1.0, l2)
        first = (d11 >= d22).to(arg.dtype)  # 1 where the first column leads
        v11 = torch.where(off, w11 / l1s, first)
        v21 = torch.where(off, w21 / l1s, 1.0 - first)
        v12 = torch.where(off, w12 / l2s, 1.0 - first)
        v22 = torch.where(off, w22 / l2s, first)

        # T = V diag(s1/smax, s2/smin) V^T  (Sigma^+ Sigma_p)
        r1 = _where(smax > 0, s1 / _where(smax > 0, smax, 1.0, smax), 0.0,
                    smax)
        r2 = _where(smin > 0, s2 / _where(smin > 0, smin, 1.0, smin), 0.0,
                    smin)
        t11 = r1 * v11 * v11 + r2 * v12 * v12
        t12 = r1 * v11 * v21 + r2 * v12 * v22
        t21 = t12
        t22 = r1 * v21 * v21 + r2 * v22 * v22

        ra = a * t11 + b * t21
        rb = a * t12 + b * t22

        # degenerate case smax == 0 (zero matrix): the result is
        # diag(s1, s2) embedded in the N x 2 matrix
        zero_case = smax <= 0
        ra = torch.where(zero_case[None, :], torch.zeros_like(ra), ra)
        rb = torch.where(zero_case[None, :], torch.zeros_like(rb), rb)
        ra[0] = torch.where(zero_case, s1, ra[0])
        rb[1] = torch.where(zero_case, s2, rb[1])

        return self.from_vectors(torch.cat([ra, rb]))


# -- mass norm / comass ball --------------------------------------------------

_TRI4 = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_TRI5 = [
    (0, 1), (0, 2), (0, 3), (0, 4),
    (1, 2), (1, 3), (1, 4),
    (2, 3), (2, 4),
    (3, 4),
]


def _skew_from_components(vecs, n):
    """(dim, count) upper-triangle components -> (count, n, n) skew
    matrices, components in row-major upper-triangle order."""
    tri = _TRI4 if n == 4 else _TRI5
    count = vecs.shape[1]
    M = vecs.new_zeros((count, n, n))
    for k, (i, j) in enumerate(tri):
        M[:, i, j] = vecs[k]
        M[:, j, i] = -vecs[k]
    return M


def _components_from_skew(M, n):
    tri = _TRI4 if n == 4 else _TRI5
    return torch.stack([M[:, i, j] for (i, j) in tri])


def _mass_decompose_apply(M, n, transform):
    """Decompose skew M (count, n, n) into two orthogonal planes with
    weights sigma_k >= 0, apply ``transform(sigma)`` and rebuild.

    M M^T is symmetric PSD with eigenvalues {s1^2, s1^2, s2^2, s2^2(, 0)}.
    u1 = top eigenvector, v1 = M u1/s1; u2 = the remaining eigenvector
    component orthogonal to span(u1, v1) (chosen among the next three
    eigenvectors so that s1 == s2 degeneracy does no harm), v2 = M u2/s2.
    """
    S = torch.einsum("cij,ckj->cik", M, M)  # M M^T
    _, W = torch.linalg.eigh(S)  # ascending; take the last columns
    u1 = W[:, :, -1]  # (count, n) top eigenvector

    Mu1 = torch.einsum("cij,cj->ci", M, u1)
    sig1 = torch.linalg.vector_norm(Mu1, dim=1)
    v1 = Mu1 / _where(sig1 > 0, sig1, 1.0, sig1)[:, None]

    # candidates for u2: the next three eigenvectors, largest first; pick
    # the one with the largest residual after projecting out u1 and v1
    cands = W[:, :, n - 4:n - 1].flip(-1)  # (count, n, 3)
    proj_u = torch.einsum("cnk,cn->ck", cands, u1)
    proj_v = torch.einsum("cnk,cn->ck", cands, v1)
    resid = (cands - u1[:, :, None] * proj_u[:, None, :]
             - v1[:, :, None] * proj_v[:, None, :])
    norms = torch.linalg.vector_norm(resid, dim=1)  # (count, 3)
    best = torch.argmax(norms, dim=1)
    u2 = torch.gather(resid, 2,
                      best[:, None, None].expand(-1, n, 1))[:, :, 0]
    nu2 = torch.linalg.vector_norm(u2, dim=1)
    u2 = u2 / _where(nu2 > 0, nu2, 1.0, nu2)[:, None]

    Mu2 = torch.einsum("cij,cj->ci", M, u2)
    sig2 = torch.linalg.vector_norm(Mu2, dim=1)
    v2 = Mu2 / _where(sig2 > 0, sig2, 1.0, sig2)[:, None]

    s1, s2 = transform(sig1), transform(sig2)

    def plane(u, v):
        return (torch.einsum("ci,cj->cij", v, u)
                - torch.einsum("ci,cj->cij", u, v))

    return (s1[:, None, None] * plane(u1, v1)
            + s2[:, None, None] * plane(u2, v2))


@dataclasses.dataclass(eq=False)
class ProxElemMassNorm(ProxSeparableSum):
    """Prox of the (weighted) mass norm of 2-vectors in R^4 (dim 6) or R^5
    (dim 10), or, with conjugate=True, projection onto the comass unit
    ball (elem_operation_mass_norm.hpp)."""

    index: int
    size: int
    count: int
    n: int  # 4 or 5
    interleaved: bool
    conjugate: bool = False
    cost: float = 1.0  # weight

    @property
    def dim(self):
        return 6 if self.n == 4 else 10

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)  # (dim, count)
        tau = effective_tau(self.vector_tau(tau_diag), self.cost * tau_scal,
                            invert_tau)
        tau = torch.broadcast_to(torch.as_tensor(tau, dtype=arg.dtype,
                                                 device=arg.device),
                                 (self.count,))

        M = _skew_from_components(vecs, self.n)
        if self.conjugate:
            def transform(s):
                return torch.clamp(s, -1.0, 1.0)
        else:
            def transform(s):
                return torch.sign(s) * torch.clamp(torch.abs(s) - tau,
                                                   min=0.0)
        out = _mass_decompose_apply(M, self.n, transform)
        return self.from_vectors(_components_from_skew(out, self.n))
