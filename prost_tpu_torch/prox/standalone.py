"""Standalone prox operators (counterpart of ``prost_tpu/prox/standalone.py``):
zero, second-order cone, halfspace, quadratic and polyhedral epigraphs,
index-set sum constraints and range projection, each a vectorized torch
expression over a (dim, count) view of its segment."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import ProstError
from .base import Prox, ProxSeparableSum
from .elemop import _where


@dataclasses.dataclass(eq=False)
class ProxZero(Prox):
    """Identity: prox of the zero function."""

    index: int
    size: int

    @property
    def diagsteps(self) -> bool:
        return True

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        return arg


@dataclasses.dataclass(eq=False)
class ProxIndSOC(ProxSeparableSum):
    """Projection onto the second-order cone {(x, y): alpha ||x||_2 <= y}.

    Layout: the dim-1 x-components planar, the scalar y last, i.e.
    segment = [x_1..., x_2..., ..., y...].  Closed-form three-case
    projection for any alpha > 0: with t = (||x||/alpha + y) /
    (1 + 1/alpha^2), the boundary projection is (t/alpha) * x/||x|| with
    height t."""

    index: int
    size: int
    count: int
    dim: int
    alpha: float = 1.0

    @property
    def interleaved(self):
        return False

    def __post_init__(self):
        if self.alpha <= 0.0:
            raise ProstError("ProxIndSOC: alpha must be positive.")

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        al = self.alpha
        vecs = arg.reshape(self.dim, self.count)
        x0, y0 = vecs[: self.dim - 1], vecs[self.dim - 1]
        norm = torch.sqrt(torch.sum(x0 * x0, dim=0))
        safe_norm = _where(norm > 0, norm, 1.0, norm)
        t = (norm / al + y0) / (1.0 + 1.0 / al**2)
        fac = (t / al) / safe_norm

        inside = al * norm <= y0
        polar = norm <= -al * y0  # inside the polar cone -> project to 0
        scale = _where(inside, 1.0, _where(polar, 0.0, fac, fac), fac)
        x = x0 * scale[None, :]
        y = _where(inside, y0, _where(polar, 0.0, t, t), t)
        return torch.cat([x, y[None, :]]).reshape(self.size)


@dataclasses.dataclass(eq=False)
class ProxIndHalfspace(ProxSeparableSum):
    """Projection onto {x : <a, x> <= b} per dim-vector
    (prox_ind_halfspace.cu).

    a has size dim (shared) or count*dim (per-instance, planar layout);
    b has size 1 or count."""

    index: int
    size: int
    count: int
    dim: int
    a: torch.Tensor = None
    b: torch.Tensor = None

    @property
    def interleaved(self):
        return False

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        v = arg.reshape(self.dim, self.count)
        if self.a.numel() == self.dim:
            a = self.a.reshape(self.dim, 1)
        else:
            a = self.a.reshape(self.dim, self.count)
        b = self.b.reshape(-1)  # (1,) or (count,)

        sq_norm = torch.sum(a * a, dim=0)
        iprod = torch.sum(a * v, dim=0)
        # projection onto the halfspace: only move if violated
        s = torch.clamp(iprod - b, min=0.0) / sq_norm
        return (v - s[None, :] * a).reshape(self.size)


def _project_parabola_nd(x0_sq_norm, x0_norm, y0, alpha):
    """Scale factor for projecting (x0, y0) onto the epigraph of
    y >= alpha ||x||^2, via the closed-form depressed-cubic root
    (helper.hpp:44-105).  Returns v: x = (v/(2 alpha)) * x0/||x0||."""
    a = 2.0 * alpha * x0_norm
    b = 2.0 * (1.0 - 2.0 * alpha * y0) / 3.0

    # discriminant, written to avoid cancellation for b < 0
    sq = torch.pow(torch.abs(b), 1.5)
    d = torch.where(b < 0, (a - sq) * (a + sq), a * a + b * b * b)

    # d >= 0: single real root via Cardano (real cube root)
    r = a + torch.sqrt(torch.clamp(d, min=0.0))
    c = torch.sign(r) * torch.pow(torch.abs(r), 1.0 / 3.0)
    safe_c = _where(torch.abs(c) > 1e-6, c, 1.0, c)
    v_pos = _where(torch.abs(c) > 1e-6, c - b / safe_c, 0.0, c)

    # d < 0: trigonometric form (three real roots; take the relevant one)
    safe_sq = _where(sq > 0, sq, 1.0, sq)
    ratio = torch.clamp(a / safe_sq, -1.0, 1.0)
    v_neg = 2.0 * torch.sqrt(torch.clamp(-b, min=0.0)) * torch.cos(
        torch.arccos(ratio) / 3.0)

    return torch.where(d >= 0, v_pos, v_neg)


@dataclasses.dataclass(eq=False)
class ProxIndEpiQuad(ProxSeparableSum):
    """Projection onto the epigraph of y >= a||x||^2 + <b, x> + c
    (prox_ind_epi_quad.cu): complete the square, project onto the standard
    parabola epigraph, undo the shift.

    Layout as SOC: dim-1 x-components planar, then y.  a, c are (1,) or
    (count,); b is (dim-1,) or (dim-1) * count planar."""

    index: int
    size: int
    count: int
    dim: int
    a: torch.Tensor = None
    b: torch.Tensor = None
    c: torch.Tensor = None

    @property
    def interleaved(self):
        return False

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        d = self.dim - 1
        vecs = arg.reshape(self.dim, self.count)
        x0, y0 = vecs[:d], vecs[d]

        a = self.a.reshape(-1)  # (1,) or (count,)
        c = self.c.reshape(-1)
        b = self.b.reshape(d, -1)  # (d, 1) or (d, count)

        shift = b / (2.0 * a)
        xs = x0 + shift
        sq_norm_b = torch.sum(b * b, dim=0)
        ys = y0 - c + sq_norm_b / (4.0 * a)

        sq_norm_xs = torch.sum(xs * xs, dim=0)
        norm_xs = torch.sqrt(sq_norm_xs)
        inside = ys >= a * sq_norm_xs

        v = _project_parabola_nd(sq_norm_xs, norm_xs, ys, a)
        safe_norm = _where(norm_xs > 0, norm_xs, 1.0, norm_xs)
        scale = _where(norm_xs > 0, (v / (2.0 * a)) / safe_norm, 0.0,
                       norm_xs)
        xp = xs * scale[None, :]
        yp = a * torch.sum(xp * xp, dim=0)

        x_out = torch.where(inside, x0, xp - shift)
        y_out = torch.where(inside, y0, yp + c - sq_norm_b / (4.0 * a))
        return torch.cat([x_out, y_out[None, :]]).reshape(self.size)


@dataclasses.dataclass(eq=False)
class ProxIndEpiPolyhedral(ProxSeparableSum):
    """Projection onto the epigraph of a polyhedral (max-of-affine) function

        f(x) = max_i ( <a_i, x> - b_i ),   i.e. onto {(x, y): A x - y <= b },

    per dim-vector with dim = d + 1 (x planar, then y).

    The dual of the projection QP is the non-negative QP

        min_{lam >= 0}  1/2 lam^T M lam - lam^T q,
        M = Atil Atil^T,  q = Atil z0 - b,  Atil = [A, -1],  z0 = (x0, y0),

    recovered by z = z0 - Atil^T lam, and solved by batched projected SOR
    (over-relaxed Gauss-Seidel coordinate descent), all ``count`` problems
    advancing in lockstep; ragged per-point constraint counts are padded
    rows with mask 0 that never activate.  A sweep refreshes w = M lam from
    scratch, then takes the m coordinate steps.  The solve stops once the
    largest update of a sweep is at most ``tol * (1 + max|q|)``, or after
    ``sweeps`` sweeps, as the JAX package's ``lax.while_loop`` does.  Here
    the sweeps run in blocks of ``SWEEP_BLOCK`` with the stop held in a
    device flag: once it is set, ``lam`` is frozen, so the result is the
    early exit's, and the host reads the flag once per block."""

    index: int
    size: int
    count: int
    dim: int  # d + 1
    sweeps: int = 400
    tol: float = 5e-7
    omega: float = 1.7  # SOR over-relaxation
    a: torch.Tensor = None     # (m, d, count) padded coefficient rows
    b: torch.Tensor = None     # (m, count)
    mask: torch.Tensor = None  # (m, count) 1.0 = real constraint, 0.0 = pad
    M: torch.Tensor = None     # (m, m, count) Gram matrix of [A, -1] rows
    Mii: torch.Tensor = None   # (m, count) diag(M), padded entries set to 1

    SWEEP_BLOCK = 16

    @staticmethod
    def create(index, size, count, dim, a, b, mask=None, sweeps=400,
               tol=5e-7, omega=1.7):
        """a: (m, d, count) or (m, d) shared; b: (m, count) or (m,)."""
        from ..config import dtype

        dt = dtype()
        a = torch.as_tensor(np.asarray(a), dtype=dt)
        b = torch.as_tensor(np.asarray(b), dtype=dt)
        if a.ndim == 2:
            a = a[:, :, None].expand(*a.shape, count)
        if b.ndim == 1:
            b = b[:, None].expand(b.shape[0], count)
        a, b = a.contiguous(), b.contiguous()
        m = a.shape[0]
        if mask is None:
            mask = torch.ones((m, count), dtype=dt)
        else:
            mask = torch.as_tensor(np.asarray(mask), dtype=dt)
        # Gram of the augmented rows (a_i, -1): M_ij = <a_i, a_j> + 1,
        # zeroed outside the active block so padded lambdas stay inert
        both = mask[:, None, :] * mask[None, :, :]
        M = (torch.einsum("idc,jdc->ijc", a, a) + 1.0) * both
        Mii = torch.einsum("iic->ic", M)
        Mii_safe = torch.where(mask > 0, Mii, torch.ones_like(Mii))
        eye = torch.eye(m, dtype=dt)[:, :, None].expand_as(M)
        M = torch.where(both > 0, M, eye).contiguous()
        return ProxIndEpiPolyhedral(
            index=index, size=size, count=count, dim=dim, sweeps=sweeps,
            tol=tol, omega=omega, a=a, b=b, mask=mask, M=M,
            Mii=Mii_safe.contiguous())

    @property
    def interleaved(self):
        return False

    @property
    def diagsteps(self) -> bool:
        return True  # projection: tau is irrelevant

    def _sweep(self, lam, q):
        """One SOR sweep from ``lam``: (new lam, largest |update|)."""
        lam = lam.clone()
        w = torch.einsum("ijc,jc->ic", self.M, lam)
        dmax = lam.new_zeros(())
        for i in range(lam.shape[0]):
            g = w[i] - q[i]
            new = torch.clamp(lam[i] - self.omega * g / self.Mii[i],
                              min=0.0) * self.mask[i]
            delta = new - lam[i]
            w = w + self.M[:, i] * delta[None, :]
            lam[i] = new
            dmax = torch.maximum(dmax, torch.max(torch.abs(delta)))
        return lam, dmax

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        d = self.dim - 1
        vecs = arg.reshape(self.dim, self.count)
        x0, y0 = vecs[:d], vecs[d]  # (d, count), (count,)

        # q_i = <a_i, x0> - y0 - b_i, masked so padded rows never activate
        q = (torch.einsum("idc,dc->ic", self.a, x0) - y0[None, :]
             - self.b) * self.mask

        lam = torch.zeros_like(q)
        dtol = self.tol * (1.0 + torch.max(torch.abs(q)))
        done = torch.zeros((), dtype=torch.bool, device=q.device)
        k = 0
        while k < self.sweeps:
            for _ in range(min(self.SWEEP_BLOCK, self.sweeps - k)):
                new_lam, dmax = self._sweep(lam, q)
                lam = torch.where(done, lam, new_lam)
                done = done | (dmax <= dtol)
                k += 1
            if bool(done):
                break

        x = x0 - torch.einsum("ic,idc->dc", lam, self.a)
        y = y0 + torch.sum(lam, dim=0)
        return torch.cat([x, y[None, :]]).reshape(self.size)


@dataclasses.dataclass(eq=False)
class ProxIndSum(Prox):
    """Projection onto {x : sum over index set(s) = fixed total}, identity
    elsewhere, with step-size-weighted correction (prox_ind_sum.cu).

    inds is a (count, dim) int array of local indices into the segment;
    the tau-weighted projection respects diagonal step sizes:

        res[I_j] = arg[I_j] - tau[I_j] * (sum(arg[I]) - total) / sum(tau[I])

    Optionally a second constraint set (inds2/sum_target2) is applied on
    top, gathering from the argument as the first does."""

    index: int
    size: int
    count: int
    dim: int
    sum_target: float = 1.0
    count2: int = 0
    dim2: int = 0
    sum_target2: float = 1.0
    inds: torch.Tensor = None
    inds2: torch.Tensor = None

    @property
    def diagsteps(self) -> bool:
        return True

    @staticmethod
    def _apply_set(res, arg, taus, inds, count, dim, total):
        inds = inds.reshape(count, dim).long()
        a = arg[inds]  # (count, dim) gather
        t = taus[inds]
        corr = (torch.sum(a, dim=1) - total) / torch.sum(t, dim=1)
        upd = a - t * corr[:, None]
        res[inds.reshape(-1)] = upd.reshape(-1)
        return res

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        taus = tau_diag * tau_scal
        if invert_tau:
            taus = 1.0 / taus
        res = arg.clone()  # identity on untouched indices
        res = self._apply_set(res, arg, taus, self.inds, self.count,
                              self.dim, self.sum_target)
        if self.inds2 is not None:
            res = self._apply_set(res, arg, taus, self.inds2, self.count2,
                                  self.dim2, self.sum_target2)
        return res


def _sparse_csr(A, dt):
    """A torch sparse CSR tensor of dtype ``dt`` from a scipy.sparse
    matrix."""
    A = A.tocsr()
    A.sort_indices()
    return torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr.astype(np.int64)),
        torch.as_tensor(A.indices.astype(np.int64)),
        torch.as_tensor(A.data, dtype=dt), size=A.shape,
        check_invariants=False)


@dataclasses.dataclass(eq=False)
class ProxIndRange(Prox):
    """Projection onto range(A) for a dense OR sparse matrix A:
    result = A (A^T A)^{-1} A^T arg (prox_ind_range.cu).

    A sparse A (scipy.sparse or a torch sparse tensor) stays sparse: A and
    A^T are kept as torch sparse CSR tensors, with O(nnz + k^2) memory.  A
    dense A stays dense, and its matvecs are matrix products.  The (k, k)
    lower Cholesky factor of A^T A (from ``AA`` when given) is computed
    once, when the prox is made; each evaluation is two matvecs and a
    Cholesky solve."""

    index: int
    size: int
    A: torch.Tensor = None    # (size, k) dense, or sparse CSR
    At: torch.Tensor = None   # (k, size) sparse CSR, or None for dense A
    chol: torch.Tensor = None  # lower Cholesky factor of A^T A, (k, k)

    @staticmethod
    def create(index, size, A, AA=None):
        import scipy.sparse as ssp

        from ..config import dtype

        dt = dtype()
        if isinstance(A, torch.Tensor) and A.layout != torch.strided:
            A = A.to_sparse_coo().coalesce()
            idx = A.indices().numpy()
            A = ssp.coo_matrix((A.values().numpy(), (idx[0], idx[1])),
                               shape=tuple(A.shape))
        if ssp.issparse(A):
            if AA is None:
                AA = (A.T @ A).toarray()
            At, A = _sparse_csr(A.T, dt), _sparse_csr(A, dt)
        else:
            A = torch.as_tensor(np.asarray(A), dtype=dt)
            At = None
            if AA is None:
                AA = (A.T @ A).numpy()
        chol = torch.linalg.cholesky(
            torch.as_tensor(np.asarray(AA), dtype=dt))
        return ProxIndRange(index=index, size=size, A=A, At=At, chol=chol)

    @property
    def diagsteps(self) -> bool:
        return True  # projection ignores tau entirely

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        At = self.A.T if self.At is None else self.At
        atb = At @ arg
        coef = torch.cholesky_solve(atb[:, None], self.chol)[:, 0]
        return self.A @ coef
