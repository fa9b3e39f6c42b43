"""Pieces shared by the fused PDHG chunk routes, ROF (``ops/fused_rof.py``),
fast multilabel (``ops/fused_multilabel.py``), deblurring
(``ops/fused_deblur.py``), tight multilabel (``ops/fused_tight.py``) and
volumetric TV (``ops/fused_vol.py``): the Python side of
``csrc/pdhg_chunk.cuh``.

* the slots of the kernels' device scalar buffer;
* the plain versions' stencils, dead-dual projection and ball scale, which
  act on the last two axes (nx, ny) of one plane or of a stack of label
  planes, and the canonicalization of a state's duals;
* ``RowOps``, the row stencils, dead-dual projection and norm sum of a
  chunk's planes: the whole plane, or one halo-extended shard of a
  row-partitioned plane (``halo_row_ops``, the plain side of the row
  context of ``csrc/pdhg_chunk.cuh`` and of the JAX package's
  ``_shift_ops`` with a row offset);
* the structure matchers' readings of data terms, prox coefficients and
  preconditioner segments;
* ``adapt_scalars``, the multichunk's adaptation and stopping test, and the
  host-side state updates after a chunk or a multichunk launch;
* ``run_pdhg_route``, a route's phase plan with its epilogue;
* the launch plumbing of a kernel library with a plain C interface: the
  wrappers' common argument checks, typing its functions once, loading the
  scalar buffer, the buffers of one call, and the launch itself with its
  error check and its count;
* the batched chunks' side of the instance axis: a (n, B) ``scal`` of
  per-instance rows becomes one scalar block per instance, the norms come
  back (4, B), and ``vmap_plain`` runs a single-instance plain version over
  the instances.

The ADMM route (``ops/fused_admm.py``) reuses the stencils and the launch
plumbing with its own slot layout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable

import torch

from ..backend.pdhg import BackendPDHG, PDHGState, hold_if, residual_and_adapt
from ..config import ProstError
from ..prox.combinators import ProxMoreau
from ..prox.elemop import ProxElem1D, ProxElemNorm2
from .phases import run_phases

# alg2 never reaches a fused route; alg1 runs the stopping test only
STEPSIZES = {"alg1": 0, "goldstein": 1, "boyd": 2}

# slots of the kernels' device scalar buffer (csrc/pdhg_chunk.cuh, enum S_*)
S_CONV, S_DONE, S_NORM, S_LEN = 13, 14, 15, 19
# a halo chunk's scal8: the family's five scalars, then the row context
# (row_offset, own_lo, own_hi) in slots S_ROW_OFF .. S_OWN_HI
N_HALO_SCAL = 8
SOUT = (0, 1, 5, 6, 7, S_CONV, S_DONE)  # tau sigma aa arb_l arb_u conv done
# instances of a batched launch: the grid's z axis (csrc/pdhg_chunk.cuh)
MAX_BATCH = 65535


# ---------------------------------------------------------------------------
# plain PyTorch pieces of the chunk math
# ---------------------------------------------------------------------------

def dx(u):
    """Forward difference along rows, Neumann (zero last row)."""
    return torch.cat([u[..., 1:, :] - u[..., :-1, :],
                      torch.zeros_like(u[..., :1, :])], dim=-2)


def dy(u):
    """Forward difference along columns, Neumann (zero last column)."""
    return torch.cat([u[..., 1:] - u[..., :-1], torch.zeros_like(u[..., :1])],
                     dim=-1)


def dxt(p):
    """Maskless adjoint of dx, exact given p[..., -1, :] == 0."""
    return torch.roll(p, 1, -2) - p


def dyt(p):
    """Maskless adjoint of dy, exact given p[..., -1] == 0."""
    return torch.roll(p, 1, -1) - p


def project_dead_dual(qx, qy):
    """Zero the dead dual coordinates: q_x's last row and q_y's last
    column (of every label plane) never enter K^T y, the ball projection
    maps zeros to zeros, so this is a no-op on every state the solver
    produces from y0 = 0.  A warm start with mass there is projected off it
    (the generic path lets it decay instead; tests pin this deviation)."""
    qx, qy = qx.clone(), qy.clone()
    qx[..., -1, :] = 0.0
    qy[..., -1] = 0.0
    return qx, qy


def dead_dual_flat(yf, L: int, nx: int, ny: int):
    """``yf`` with the dead coordinates of its gradient duals zeroed: its
    first 2 L nx ny entries are [q_x (L planes); q_y (L planes)]
    (``project_dead_dual``); the rest (a label-difference or multiplier
    segment, if any) comes back as it is."""
    n2 = 2 * L * nx * ny
    q = yf[:n2].reshape(2, L, nx, ny)
    qx, qy = project_dead_dual(q[0], q[1])
    return torch.cat([qx.reshape(-1), qy.reshape(-1), yf[n2:]])


def label_sum(a):
    """sum_l a_l over the label axis (axis 0), left to right as the kernels
    sum it: ``torch.sum``'s order depends on the tensor's layout, and the
    tiled chunks' plain twins sum windows where the plain versions sum
    whole planes."""
    acc = a[0]
    for l in range(1, a.shape[0]):
        acc = acc + a[l]
    return acc


def dyt_masked(p):
    """Adjoint of dy that reads no last column: p_{j-1}[j>0] -
    p_j[j<n-1]."""
    j = torch.arange(p.shape[-1], device=p.device)
    return (torch.where(j > 0, torch.roll(p, 1, -1), 0.0)
            - torch.where(j < p.shape[-1] - 1, p, 0.0))


@dataclasses.dataclass(frozen=True)
class RowOps:
    """The parts of a chunk's math that depend on where its rows lie in
    the global plane: the row forward difference ``dx`` and its adjoint
    ``dxt`` (maskless: exact given a zero dead row), the masked adjoint
    ``dxt_masked`` (for duals that stay live on the global last row), the
    dead-dual projection ``project`` (q_x's global last row, q_y's last
    column) and the norms' sum ``nsum``; and the column difference ``dy``,
    its adjoint ``dyt`` and the masked one ``dyt_masked``, the whole
    width's unless the planes are a window of the plane's columns (the
    tiled chunks' plain twins)."""

    dx: Callable
    dxt: Callable
    dxt_masked: Callable
    project: Callable
    nsum: Callable
    dy: Callable = dy
    dyt: Callable = dyt
    dyt_masked: Callable = dyt_masked


def dxt_masked(p):
    """Adjoint of dx that reads no last row: p_{i-1}[i>0] - p_i[i<n-1]."""
    i = torch.arange(p.shape[-2], device=p.device)[:, None]
    return (torch.where(i > 0, torch.roll(p, 1, -2), 0.0)
            - torch.where(i < p.shape[-2] - 1, p, 0.0))


WHOLE_PLANE = RowOps(dx, dxt, dxt_masked, project_dead_dual, torch.sum)


def halo_row_ops(row_offset: int, nx_global: int, own_lo: int,
                 own_hi: int) -> RowOps:
    """``RowOps`` of one halo-extended shard of a plane of ``nx_global``
    rows whose local row 0 is global row ``row_offset``: a row neighbour is
    read only where the local and the global row both have one (the
    Neumann boundary lies at global rows 0 and nx_global - 1, not at the
    shard's edges), q_x is dead on the global last row, and the norms sum
    the owned local rows [own_lo, own_hi).  With (0, nx, 0, nx) this is
    ``WHOLE_PLANE``, value for value."""
    def rows(a):
        li = torch.arange(a.shape[-2], device=a.device)
        return li, li + row_offset

    def hdx(u):
        li, gi = rows(u)
        below = ((li < u.shape[-2] - 1) & (gi < nx_global - 1))[:, None]
        return torch.where(below, torch.roll(u, -1, -2) - u, 0.0)

    def hdxt(p):
        li, gi = rows(p)
        above = ((li > 0) & (gi > 0))[:, None]
        return torch.where(above, torch.roll(p, 1, -2), 0.0) - p

    def hdxt_masked(p):
        li, gi = rows(p)
        above = ((li > 0) & (gi > 0))[:, None]
        live = (gi < nx_global - 1)[:, None]
        return (torch.where(above, torch.roll(p, 1, -2), 0.0)
                - torch.where(live, p, 0.0))

    def project(qx, qy):
        _, gi = rows(qx)
        qx = torch.where((gi == nx_global - 1)[:, None], 0.0, qx)
        qy = qy.clone()
        qy[..., -1] = 0.0
        return qx, qy

    def nsum(v):
        li, _ = rows(v)
        return torch.sum(torch.where(((li >= own_lo) & (li < own_hi))[:, None],
                                     v, 0.0))

    return RowOps(hdx, hdxt, hdxt_masked, project, nsum)


def halo_scal_rows(scal, nx_global: int) -> RowOps:
    """``halo_row_ops`` from a halo chunk's scal8 (its row context read on
    the host: the plain versions only)."""
    off, lo, hi = (int(v) for v in scal[5:N_HALO_SCAL].tolist())
    return halo_row_ops(off, int(nx_global), lo, hi)


def ball_scale(nn, radius):
    """min(1, r / |a|) for the r-ball projection, from nn = |a|^2.  A zero
    vector keeps scale 1 (its projection is itself): rsqrt(0) = inf would
    make radius * inf NaN for radius == 0, where the JAX package's form
    gives NaN."""
    s = torch.clamp(radius * torch.rsqrt(nn), max=1.0)
    return torch.where(nn > 0, s, torch.ones_like(s))


def isscalar(v) -> bool:
    return isinstance(v, (int, float))


# ---------------------------------------------------------------------------
# structure matching
# ---------------------------------------------------------------------------

def coeff_vector(v, n: int, device):
    """A prox coefficient, a Python scalar or a tensor that broadcasts to
    ``n``, as a float32 vector of length ``n``."""
    if isinstance(v, torch.Tensor):
        return torch.broadcast_to(v.to(torch.float32).reshape(-1), (n,))
    return torch.full((n,), float(v), dtype=torch.float32, device=device)


def segment_const(t):
    """The constant value of a preconditioner segment, or None."""
    if t.numel() == 0:
        return None
    v = float(t[0])
    return v if bool(torch.allclose(t, torch.full_like(t, v))) else None


def leq0_ball_radius(p, dim: int):
    """Radius b/a of a planar norm2 ind_leq0 ball of dimension ``dim``
    with scalar a > 0, b, c and d = e = 0 (I(a|x| - b <= 0)); None for any
    other prox."""
    if not isinstance(p, ProxElemNorm2) or p.fun != "ind_leq0":
        return None
    if p.dim != dim or p.interleaved:
        return None
    ia, ib, ic, idd, ie, _, _ = p.coeffs
    if not all(isscalar(v) for v in (ia, ib, ic)):
        return None
    if idd != 0.0 or ie != 0.0 or ia <= 0:
        return None
    return float(ib) / float(ia)


def dual_ball_radius(p, dim: int = 2):
    """Radius of the per-pixel dim-``dim`` ball of a gradient-row dual
    prox: Moreau(norm2 abs, coeffs (1, 0, c, 0, 0)), the conjugate of c|x|,
    or a dim-``dim`` ind_leq0 ball; None otherwise."""
    if not isinstance(p, ProxMoreau):
        return leq0_ball_radius(p, dim)
    inner = p.child
    if not isinstance(inner, ProxElemNorm2) or inner.fun != "abs":
        return None
    if inner.dim != dim or inner.interleaved:
        return None
    ia, ib, ic, idd, ie, _, _ = inner.coeffs
    for v, want in ((ia, 1.0), (ib, 0.0), (idd, 0.0), (ie, 0.0)):
        if not (isscalar(v) and v == want):
            return None
    return float(ic) if isscalar(ic) else None


def _const_tensor(v, shape, device):
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).reshape(shape).contiguous()
    return torch.full(shape, float(v), dtype=torch.float32, device=device)


def match_dataterm(pg, shape, device):
    """The fused ROF and volumetric data term of prox_g ``pg``, a 1D square
    or abs with coeffs (1, f, lmb, 0, 0), or a square with a per-pixel a
    (the masked inpainting term, lmb/2 (a u - b)^2 == lmb/2 a^2 (u - b/a)^2);
    returns (dataterm, f, w, lmb) with f and w float32 tensors of
    ``shape`` (w = f, a placeholder, unless wsquare), or None."""
    if not isinstance(pg, ProxElem1D) or pg.fun not in ("square", "abs"):
        return None
    a, b, c, d, e, _, _ = pg.coeffs
    if not (isscalar(c) and isscalar(d) and d == 0.0
            and isscalar(e) and e == 0.0):
        return None
    if isscalar(a) and a == 1.0:
        f = _const_tensor(b, shape, device)
        return ("square" if pg.fun == "square" else "abs"), f, f, float(c)
    if not (pg.fun == "square" and isinstance(a, torch.Tensor)
            and a.numel() == math.prod(shape)):
        return None
    a64 = a.to(torch.float64).reshape(-1)
    b64 = (b.to(torch.float64).reshape(-1) if isinstance(b, torch.Tensor)
           else torch.full_like(a64, float(b)))
    b64 = torch.broadcast_to(b64, a64.shape)
    safe = torch.where(a64 != 0, a64, torch.ones_like(a64))
    f = torch.where(a64 != 0, b64 / safe, torch.zeros_like(a64))
    return ("wsquare", _const_tensor(f, shape, device),
            _const_tensor(a64 ** 2, shape, device), float(c))


def adapt_scalars(stepsize: str, consts, tols4, it, tau, sigma, arg_alpha,
                  arb_l, arb_u, pr, pn, dr, dn):
    """The scalar math of ``backend.pdhg.residual_and_adapt`` as the
    multichunk kernel runs it between chunks: same operations in the same
    order on f32 0-d tensors.  ``consts`` = (sqrt_nrows, sqrt_ncols,
    arg_delta, arg_nu, arb_delta, arb_tau) are Python floats; ``it`` is the
    pre-increment counter of the residual iteration as f32.

    Returns (tau, sigma, arg_alpha, arb_l, arb_u, converged)."""
    trp, trd, tap, tad = tols4
    sqrt_nrows, sqrt_ncols, arg_delta, arg_nu, arb_delta, arb_tau = consts
    eps_pri = sqrt_nrows * tap + trp * pn
    eps_dua = sqrt_ncols * tad + trd * dn
    conv = (pr < eps_pri) & (dr < eps_dua)
    if stepsize == "goldstein":
        scale = eps_dua / eps_pri
        up = dr > scale * pr * arg_delta
        dn_ = dr < scale * pr / arg_delta
        fac = 1.0 - arg_alpha
        tau = torch.where(up, tau / fac, torch.where(dn_, tau * fac, tau))
        sigma = torch.where(up, sigma * fac,
                            torch.where(dn_, sigma / fac, sigma))
        arg_alpha = torch.where(up | dn_, arg_alpha * arg_nu, arg_alpha)
    elif stepsize == "boyd":
        c1 = (dr < eps_dua) & (arb_tau * it > arb_l)
        c2 = (pr < eps_pri) & (arb_tau * it > arb_u) & ~c1
        tau = torch.where(c1, tau / arb_delta,
                          torch.where(c2, tau * arb_delta, tau))
        sigma = torch.where(c1, sigma * arb_delta,
                            torch.where(c2, sigma / arb_delta, sigma))
        arb_u = torch.where(c1, it, arb_u)
        arb_l = torch.where(c2, it, arb_l)
    return tau, sigma, arg_alpha, arb_l, arb_u, conv


def multichunk_plain(chunk, planes, scal, count: int, k_chunks: int,
                     stepsize: str, consts):
    """The loop of the PDHG routes' plain multichunk versions: up to
    ``k_chunks`` chunks of ``count`` iterations with ``adapt_scalars``
    between them.  ``chunk(tau, sigma, planes)`` runs one chunk and returns
    (its planes, its 4 squared norms); ``planes`` is the launch's tuple of
    state, previous iterate and carried planes; ``scal`` holds the 13
    multichunk scalars (+ the converged-at-entry flag).  Every chunk is
    computed and kept only while not converged, where the JAX kernels branch
    around it with ``lax.cond``.

    Returns (planes, the last executed chunk's sqrt'd norms, sout)."""
    dt = planes[0].dtype
    it0 = scal[8]
    tols4 = (scal[9], scal[10], scal[11], scal[12])
    zero = torch.zeros((), dtype=dt, device=scal.device)
    sc = (scal[0], scal[1], scal[5], scal[6], scal[7],
          entry_converged(scal, 13), zero)
    norms = (zero, zero, zero, zero)
    for c in range(int(k_chunks)):
        tau, sigma, aa, al, au, conv, done = sc
        new_planes, nrm = chunk(tau, sigma, planes)
        pr, pn = torch.sqrt(nrm[0]), torch.sqrt(nrm[1])
        dr, dn = torch.sqrt(nrm[2]), torch.sqrt(nrm[3])
        it = it0 + float((c + 1) * int(count) - 1)
        tau2, sigma2, aa2, al2, au2, cv = adapt_scalars(
            stepsize, consts, tols4, it, tau, sigma, aa, al, au,
            pr, pn, dr, dn)
        new_sc = (tau2, sigma2, aa2, al2, au2, cv, done + 1.0)
        planes = tuple(torch.where(conv, a, b)
                       for a, b in zip(planes, new_planes))
        sc = tuple(torch.where(conv, a, b) for a, b in zip(sc, new_sc))
        norms = tuple(torch.where(conv, a, b)
                      for a, b in zip(norms, (pr, pn, dr, dn)))
    tau, sigma, aa, al, au, conv, done = sc
    sout = torch.stack([tau, sigma, aa, al, au, conv.to(dt), done])
    return planes, torch.stack(norms), sout


def pdhg_adapt_consts(problem, opts) -> tuple:
    """The constant tuple for ``adapt_scalars``."""
    return (math.sqrt(float(problem.nrows)), math.sqrt(float(problem.ncols)),
            float(opts.arg_delta), float(opts.arg_nu),
            float(opts.arb_delta), float(opts.arb_tau))


def vmap_plain(plain, planes, scal, *static):
    """A batched chunk's plain version: the single-instance ``plain``
    version, called as ``plain(*planes, scal, *static)``, vmapped over the
    instances, the leading axis of ``planes`` and the columns of the (n, B)
    ``scal``; the last output, its norms, comes back (4, B)."""
    out = torch.func.vmap(lambda *a: plain(*a, *static))(*planes, scal.T)
    return (*out[:-1], out[-1].T)


def entry_converged(scal, n: int):
    """The optional converged-at-entry flag after the first ``n`` scalars."""
    if scal.numel() > n:
        return scal[n] != 0
    return torch.zeros((), dtype=torch.bool, device=scal.device)


# ---------------------------------------------------------------------------
# the solver state after a launch
# ---------------------------------------------------------------------------

def multichunk_state(s: PDHGState, ri: int, x, y, x_prev, y_prev, norms,
                     sout) -> PDHGState:
    """``s`` after a multichunk launch of ``ri``-iteration chunks that
    returned the flat iterates, the sqrt'd norms and ``sout``; held where
    ``s`` had converged already."""
    done = sout[6].to(torch.int32)
    new = dataclasses.replace(
        s, x=x, y=y, x_prev=x_prev, y_prev=y_prev,
        tau=sout[0], sigma=sout[1], arg_alpha=sout[2], arb_l=sout[3],
        arb_u=sout[4], converged=sout[5] > 0.5,
        primal_residual=norms[0], primal_var_norm=norms[1],
        dual_residual=norms[2], dual_var_norm=norms[3],
        iteration=s.iteration + done * ri,
    )
    return hold_if(s.converged, s, new)


def chunk_state(b: BackendPDHG, s: PDHGState, ri: int, x, y, x_prev, y_prev,
                norms2) -> PDHGState:
    """``s`` after a chunk launch of ``ri`` iterations that returned the
    flat iterates and the SQUARED norms: the residual step and the
    adaptation of backend ``b``, held where ``s`` had converged already."""
    norms = torch.sqrt(norms2)
    new = dataclasses.replace(s, x=x, y=y, x_prev=x_prev, y_prev=y_prev)
    # the chunk covers iterations s.iteration .. s.iteration + ri - 1; the
    # residual iteration's pre-increment counter is the last of them
    new = residual_and_adapt(b.problem, b.opts, b.tols, new,
                             norms[0], norms[1], norms[2], norms[3],
                             s.iteration + (ri - 1))
    new = dataclasses.replace(new, iteration=new.iteration + ri)
    return hold_if(s.converged, s, new)


def canonical_duals(L: int, nx: int, ny: int):
    """A route's canonicalization for ``run_pdhg_route``: the dead dual
    coordinates of y and y_prev zeroed (``dead_dual_flat``)."""
    def canonicalize(s):
        return dataclasses.replace(s, y=dead_dual_flat(s.y, L, nx, ny),
                                   y_prev=dead_dual_flat(s.y_prev, L, nx, ny))
    return canonicalize


def run_pdhg_route(b: BackendPDHG, state: PDHGState, until: int, start: int,
                   chunk, canonicalize=None, multichunk=None) -> PDHGState:
    """The phases of ``ops.phases.run_phases`` around a route's launches on
    backend ``b``: a chunk starts where iteration % ri == 1 (pre-increment
    counter), so it ends on a residual iteration; the epilogue refreshes
    kx, kty, kx_prev and kty_prev, which the chunks do not carry.
    ``chunk`` and ``multichunk`` take and return the state;
    ``canonicalize`` is None where the kernels take the state as it is."""
    lin = b.problem.linop
    ri = max(int(b.opts.residual_iter), 1)

    def epilogue(s):
        return dataclasses.replace(
            s, kx=lin.apply(s.x), kty=lin.apply_adjoint(s.y),
            kx_prev=lin.apply(s.x_prev),
            kty_prev=lin.apply_adjoint(s.y_prev))

    return run_phases(state, start, until, ri, 1 % ri, b.generic_step,
                      canonicalize, chunk, multichunk=multichunk,
                      epilogue=epilogue)


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

VP, CI, CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def typed_lib(name: str, num_blocks: str, signatures: dict):
    """The kernel library built from ``csrc/<name>.cu`` on first use, its C
    functions typed once: ``num_blocks`` (nx, ny) -> the blocks of a
    plane's grid, ``prost_error_string``, and each launch function of
    ``signatures`` ({name: argtypes}), which returns a CUDA error code."""
    from .cuda_build import load

    lib = load(name).lib
    if not getattr(lib, "_prost_typed", False):
        getattr(lib, num_blocks).argtypes = [CI, CI]
        getattr(lib, num_blocks).restype = CI
        lib.prost_error_string.argtypes = [CI]
        lib.prost_error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = CI
        lib._prost_typed = True
    return lib


def check_halo(nx_global: int, state=(), prev=()) -> None:
    """A halo chunk wrapper's checks: its global row count (the row
    context itself stays on the device) and, for the in-place form, its
    ``state`` and ``prev`` buffers (``check_inplace``)."""
    if int(nx_global) < 2:
        raise ProstError(f"nx_global must be >= 2, got {nx_global}.")
    check_inplace(state, prev)


def check_inplace(state, prev) -> None:
    """An in-place chunk's ``state`` and ``prev`` buffers: contiguous and
    of one shape and device each."""
    for a, b in zip(state, prev):
        if b.shape != a.shape or b.device != a.device:
            raise ProstError(f"A previous-iterate buffer must be "
                             f"{tuple(a.shape)} on {a.device}, got "
                             f"{tuple(b.shape)} on {b.device}.")
    if not all(a.is_contiguous() for a in (*state, *prev)):
        raise ProstError("An in-place halo chunk takes contiguous buffers "
                         "only.")


def instance_strides(state, prev, what: str):
    """The floats from one instance to the next of each of the batched
    buffers ``state`` and of ``prev``, which must match them: each
    instance contiguous in itself, the instances at any one stride (a
    batched in-place chunk's buffers may be views of a route's flat (B, n)
    rows, several buffers to a row); ``what`` names the chunk."""
    strides = []
    for a, b in zip(state, prev):
        inner = a.shape[1:]
        for t in (a, b):
            if t.shape != a.shape or t.device != a.device:
                raise ProstError(f"A previous-iterate buffer must be "
                                 f"{tuple(a.shape)} on {a.device}, got "
                                 f"{tuple(t.shape)} on {t.device}.")
            if not t[0].is_contiguous():
                raise ProstError(f"{what} takes instances that are each "
                                 "contiguous.")
        size = torch.Size(inner).numel()
        if a.shape[0] > 1 and a.stride(0) != b.stride(0):
            raise ProstError(f"{what}: a buffer and its previous iterate's "
                             "must space their instances alike.")
        if a.shape[0] > 1 and a.stride(0) < size:
            raise ProstError(f"{what}: the instances of a buffer overlap.")
        strides.append(a.stride(0) if a.shape[0] > 1 else size)
    return strides


def halo_into(state, prev, out, scal, n_scal: int = N_HALO_SCAL):
    """An in-place chunk from its plain version's outputs ``out`` (the
    state, the previous iterate, the norms): ``state`` takes the new
    iterate and ``prev`` the previous one, except where the converged flag
    (after the ``n_scal`` scalars of ``scal``, a halo chunk's eight by
    default; for a batched chunk's (n, B) ``scal``, each instance's) is
    set, which leaves ``prev`` as it was.  Returns the squared norms."""
    if scal.dim() == 2:
        conv = (scal[n_scal] != 0 if scal.shape[0] > n_scal else
                torch.zeros(scal.shape[1], dtype=torch.bool,
                            device=scal.device))
    else:
        conv = entry_converged(scal, n_scal)
    k = len(state)
    for t, v in zip(state, out[:k]):
        t.copy_(v)
    for t, v in zip(prev, out[k:2 * k]):
        c = conv.reshape(conv.shape + (1,) * (t.dim() - conv.dim()))
        t.copy_(torch.where(c, t, v))
    return out[-1]


def halo_copy(inplace, state, *args):
    """The functional form of an in-place chunk ``inplace`` (a halo chunk,
    or the batched ROF chunk's tiled or streaming path) on the ``state``
    planes: it works
    on copies and returns (state, previous iterate, norms2), the previous
    iterate the state where nothing ran."""
    new = [t.contiguous().clone() for t in state]
    prev = [t.clone() for t in new]
    norms2 = inplace(*new, *prev, *args)
    return (*new, *prev, norms2)


class LightChunk:
    """The scalar side of a route's light chunk call (the grid-resident
    routes' ``ROFChunk``, ``DeblurChunk`` and ``MLChunk``, and with a
    ``batch`` of instances ``ROFBatchedChunk``, ``MLBatchedChunk``,
    ``VolBatchedChunk`` and ``DeblurBatchedChunk``): one device scalar
    buffer per route (one
    block of S_LEN per instance), its family's two scalars (and a halo
    band's row context) written once; a call writes its step sizes and
    converged flag into it in place and zeros into its norms (a call the
    flag stops returns zeros, as the in-place forms do), a few small
    device copies and no allocation of state.  ``scal()`` is the same call's ``scal`` as the
    wrappers take it ((n, B) for a batch), for the plain versions."""

    def __init__(self, consts, device, batch=None):
        self.n_scal = 3 + len(consts)
        shape = (S_LEN,) if batch is None else (int(batch), S_LEN)
        self.sc = torch.zeros(shape, dtype=torch.float32, device=device)
        self.sc[..., 3:self.n_scal] = torch.stack(
            [torch.as_tensor(c, dtype=torch.float32).to(device).expand(
                shape[:-1]) for c in consts], -1)

    def scalars_(self, tau, sigma, theta, converged) -> None:
        if self.sc.dim() == 1:
            torch.stack([tau, sigma, theta], out=self.sc[:3])
        else:
            self.sc[:, :3] = torch.stack([tau, sigma, theta], 1)
        self.sc[..., S_CONV].copy_(converged)
        self.sc[..., S_NORM:S_NORM + 4].zero_()  # what a flagged call leaves

    def scal(self):
        sc = torch.cat([self.sc[..., :self.n_scal],
                        self.sc[..., S_CONV:S_CONV + 1]], -1)
        return sc if sc.dim() == 1 else sc.T

    def norms2(self):
        norms = self.sc[..., S_NORM:S_NORM + 4]
        return norms if norms.dim() == 1 else norms.T


class LightMultichunk:
    """A route's light call of its multichunk (``ROFMultichunk``,
    ``VolMultichunk``, ``MLMultichunk``): the family's in-place multichunk
    on the views of the run's own x, y, x_prev and y_prev, with what
    depends only on the shapes and the route ``m`` made once per route: the
    path, the scratch and the norm partials (``_card``) and the scalar
    buffer with the family's two scalars (``_consts``, keys of ``m``) and
    the tolerances.  A call writes tau, sigma, theta, arg_alpha, arb_l,
    arb_u, the iteration counter and the flag into the scalar buffer, and
    zeros into the chunk count and the norms, in one stack and one indexed
    copy, launches (``_launch``) on the data planes (``_data``, keys of
    ``m``) with ``m``'s data term where the family has one
    (``_dataterm``), and reads the norms and sout out of it in one gather;
    on the CPU it runs the in-place form (``_inplace``, the plain
    version)."""

    # the slots a call writes: the step sizes and the adaptation state, the
    # counter, the flag, the chunk count and the norms
    _IN = (0, 1, 2, 5, 6, 7, 8, S_CONV, S_DONE) + tuple(
        range(S_NORM, S_NORM + 4))
    _consts = ("lmb_t", "radius_t")  # slots 3 and 4
    _data = ("f", "w")
    _dataterm = True

    def __init__(self, m, count: int, k_chunks: int, stepsize: str, device):
        self.m, self.count, self.k_chunks = m, int(count), int(k_chunks)
        self.stepsize = stepsize
        self.sc = torch.zeros(S_LEN, dtype=torch.float32, device=device)
        self.sc[3] = m[self._consts[0]]
        self.sc[4] = m[self._consts[1]]
        self.sc[9:13] = torch.stack(m["tols_t"])
        self.stage = torch.zeros(len(self._IN), dtype=torch.float32,
                                 device=device)
        self.slots_in = torch.tensor(self._IN, device=device)
        self.slots_out = torch.tensor(
            tuple(range(S_NORM, S_NORM + 4)) + SOUT, device=device)
        self.resident = None  # the path on a card
        if torch.device(device).type == "cuda":
            self.resident, self.partial, self.scratch = self._card(device)

    def __call__(self, state, prev, tau, sigma, theta, arg_alpha, arb_l,
                 arb_u, it, converged):
        """Up to k_chunks chunks on ``state`` in place, the previous
        iterate into ``prev``, from the state's scalars (``it`` its
        iteration counter); returns (norms, sout)."""
        dt = self.sc.dtype
        torch.stack([tau, sigma, theta, arg_alpha, arb_l, arb_u, it.to(dt),
                     converged.to(dt)], out=self.stage[:8])
        self.sc.index_copy_(0, self.slots_in, self.stage)
        m = self.m
        data = [m[k] for k in self._data]
        args = (self.count, self.k_chunks,
                *((m["dataterm"],) if self._dataterm else ()), self.stepsize,
                m["adapt_consts"])
        if self.resident is None:
            return self._inplace(*state, *prev, *data,
                                 torch.cat([self.sc[:13],
                                            self.sc[S_CONV:S_CONV + 1]]),
                                 *args)
        self._launch(state, prev, *data, self.sc, self.partial, self.scratch,
                     self.resident, *args)
        out = self.sc.index_select(0, self.slots_out)
        return out[:4], out[4:]


def own_vectors(s):
    """``s`` with copies of its x, y, x_prev and y_prev, which the run then
    owns: a route whose chunks work in place on the state's vectors takes
    them once per run, so no state a caller holds changes under it."""
    return dataclasses.replace(s, x=s.x.clone(), y=s.y.clone(),
                               x_prev=s.x_prev.clone(),
                               y_prev=s.y_prev.clone())


def resident_rows(nrows: int, sms: int) -> int:
    """Rows of the largest band of a grid-resident chunk (one block per SM,
    ``band_of`` in csrc/pdhg_chunk.cuh) over ``nrows`` rows."""
    return -(-int(nrows) // int(sms))


# a grid-resident block's reduction array (csrc/pdhg_chunk.cuh RES_RED_BYTES)
RES_RED_BYTES = 4 * 512 * 4
PATHS = (None, "resident", "streaming")
# the paths of the wrappers that also have a tiled launch (ROF, Chebyshev
# ADMM, deblur)
TILED_PATHS = PATHS + ("tiled",)


def check_path(path, what: str) -> None:
    """An in-place form's ``path`` is one of ``TILED_PATHS``, on any
    device."""
    if path not in TILED_PATHS:
        raise ProstError(f"{what}: path must be one of {TILED_PATHS}, got "
                         f"{path!r}.")


def pick_path(path, fits: bool, what: str) -> bool:
    """Whether a chunk runs grid-resident: by the shape rule's ``fits``
    where ``path`` is None, else as the caller asks ("resident" where it
    does not fit raises)."""
    if path not in PATHS:
        raise ProstError(f"{what}: path must be one of {PATHS}, got {path!r}.")
    if path == "resident" and not fits:
        raise ProstError(f"{what}: the chunk's planes do not fit in the "
                         "shared memory of one block per SM.")
    return fits if path is None else path == "resident"


def card_sms(device) -> int:
    """The streaming multiprocessors of the card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_buffers(kind: str, shapes, scal, n_scal: int,
                  batch: int | None = None) -> None:
    """The checks every chunk wrapper makes after its own: each (name,
    tensor, shape) of ``shapes`` has that shape, ``scal`` holds ``n_scal``
    scalars (+1 converged flag), or, for a ``batch`` of instances, is
    (n_scal, batch) (+1 row of flags) with 1 <= batch <= MAX_BATCH, and all
    of them lie on one device, the CPU or a card, in float32 on a card: the
    ``kind`` kernels take nothing else."""
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ProstError(f"{name} must be {shape}, got {tuple(t.shape)}.")
    if batch is None and scal.numel() not in (n_scal, n_scal + 1):
        raise ProstError(f"scal must hold {n_scal} scalars "
                         f"(+1 converged flag), got {scal.numel()}.")
    if batch is not None:
        if tuple(scal.shape) not in ((n_scal, batch), (n_scal + 1, batch)):
            raise ProstError(f"scal must be ({n_scal}, {batch}) (+1 row of "
                             f"converged flags), got {tuple(scal.shape)}.")
        if not 1 <= batch <= MAX_BATCH:
            raise ProstError(f"A batched launch takes 1 to {MAX_BATCH} "
                             f"instances, got {batch}.")
    dev = scal.device
    for t in [t for _, t, _ in shapes] + [scal]:
        if t.device != dev:
            raise ProstError("All tensors must be on one device.")
        if dev.type == "cuda" and t.dtype != torch.float32:
            raise ProstError(f"The CUDA {kind} kernels take float32 only.")
    if dev.type not in ("cpu", "cuda"):
        raise ProstError(f"No {kind} kernel for device {dev}.")


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def scalar_buffer(scal, n_scal: int, conv_slot: int, length: int):
    """The device scalar buffer of one call: the first ``n_scal`` scalars
    in their slots, the optional converged-at-entry flag in ``conv_slot``,
    zeros elsewhere; for a batched call's (n, B) ``scal``, one such block of
    ``length`` per instance, (B, length)."""
    rows = scal if scal.dim() == 1 else scal.t()
    sc = torch.zeros(rows.shape[:-1] + (length,), dtype=torch.float32,
                     device=scal.device)
    sc[..., :n_scal] = rows[..., :n_scal]
    if rows.shape[-1] > n_scal:
        sc[..., conv_slot] = rows[..., n_scal]
    return sc


def launch(lib, fn: str, what: str, counts: dict, device, buffers, *args):
    """Queue ``lib.fn(buffer pointers..., *args, stream)`` on ``device``'s
    current stream, raise ``ProstError`` on a launch error, and count the
    launch under ``what``.  ``buffers`` stay referenced until the launches
    are queued."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*[ptr(t) for t in buffers], *args, stream)
    if rc != 0:
        msg = lib.prost_error_string(rc).decode()
        raise ProstError(f"{what}: CUDA launch failed ({rc}: {msg}).")
    counts[what] += 1


class ChunkWork:
    """The buffers one PDHG chunk-kernel call works on in place: copies of
    the state planes (so a call that returns at once hands its inputs
    back), the previous iterate's, two carried planes (this iterate's and
    the previous one's) for each of ``carried``, the scalar buffer and the
    norm partials of ``nblocks`` blocks, for each instance of a batched
    call (a (n, B) ``scal``).  Given ``prev``, the call works on the
    caller's buffers instead: ``state`` and ``prev`` themselves (an
    in-place halo chunk; nothing changes when nothing runs)."""

    def __init__(self, state, carried, scal, n_scal: int, nblocks: int,
                 prev=None):
        if prev is None:
            self.state = [t.contiguous().clone() for t in state]
            self.prev = [t.clone() for t in self.state]
        else:
            self.state, self.prev = list(state), list(prev)
        self.carried = [torch.empty(t.shape, dtype=torch.float32,
                                    device=t.device)
                        for t in carried for _ in range(2)]
        self.sc = scalar_buffer(scal, n_scal, S_CONV, S_LEN)
        batch = 1 if scal.dim() == 1 else scal.shape[1]
        self.partial = torch.empty(4 * nblocks * batch, dtype=torch.float32,
                                   device=scal.device)

    def buffers(self, *inputs):
        """The kernel's buffer arguments: state, previous, carried, the
        read-only ``inputs``, scalars, partials."""
        return (self.state + self.prev + self.carried
                + [t.contiguous() for t in inputs] + [self.sc, self.partial])

    def outputs(self):
        """The state and the previous iterate, then the 4 norms (squared
        after a chunk, sqrt'd after a multichunk), (4, B) after a batched
        chunk."""
        norms = self.sc[..., S_NORM:S_NORM + 4]
        return (*self.state, *self.prev,
                norms.T if norms.dim() == 2 else norms)

    def sout(self):
        return torch.stack([self.sc[i] for i in SOUT])
