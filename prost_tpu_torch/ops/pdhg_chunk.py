"""Pieces shared by the fused PDHG chunk routes, ROF (``ops/fused_rof.py``),
fast multilabel (``ops/fused_multilabel.py``), deblurring
(``ops/fused_deblur.py``) and tight multilabel (``ops/fused_tight.py``): the
Python side of ``csrc/pdhg_chunk.cuh``.

* the slots of the kernels' device scalar buffer;
* the plain versions' stencils, dead-dual projection and ball scale, which
  act on the last two axes (nx, ny) of one plane or of a stack of label
  planes;
* the structure matchers' readings of prox coefficients and
  preconditioner segments;
* ``adapt_scalars``, the multichunk's adaptation and stopping test, and the
  host-side state updates after a chunk or a multichunk launch;
* ``run_pdhg_route``, a route's phase plan with its epilogue;
* the launch plumbing of a kernel library with a plain C interface: typing
  its functions once, loading the scalar buffer, the buffers of one call,
  and the launch itself with its error check and its count.

The ADMM route (``ops/fused_admm.py``) reuses the stencils and the launch
plumbing with its own slot layout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..backend.pdhg import BackendPDHG, PDHGState, hold_if, residual_and_adapt
from ..config import ProstError
from ..prox.combinators import ProxMoreau
from ..prox.elemop import ProxElemNorm2
from .phases import run_phases

# alg2 never reaches a fused route; alg1 runs the stopping test only
STEPSIZES = {"alg1": 0, "goldstein": 1, "boyd": 2}

# slots of the kernels' device scalar buffer (csrc/pdhg_chunk.cuh, enum S_*)
S_CONV, S_DONE, S_NORM, S_LEN = 13, 14, 15, 19
SOUT = (0, 1, 5, 6, 7, S_CONV, S_DONE)  # tau sigma aa arb_l arb_u conv done


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


def dual_ball_radius(p):
    """Radius of the per-pixel dim-2 ball of a gradient-row dual prox:
    Moreau(norm2 abs, coeffs (1, 0, c, 0, 0)), the conjugate of c|x|, or a
    dim-2 ind_leq0 ball; None otherwise."""
    if not isinstance(p, ProxMoreau):
        return leq0_ball_radius(p, 2)
    inner = p.child
    if not isinstance(inner, ProxElemNorm2) or inner.fun != "abs":
        return None
    if inner.dim != 2 or inner.interleaved:
        return None
    ia, ib, ic, idd, ie, _, _ = inner.coeffs
    for v, want in ((ia, 1.0), (ib, 0.0), (idd, 0.0), (ie, 0.0)):
        if not (isscalar(v) and v == want):
            return None
    return float(ic) if isscalar(ic) else None


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


def pdhg_adapt_consts(problem, opts) -> tuple:
    """The constant tuple for ``adapt_scalars``."""
    return (math.sqrt(float(problem.nrows)), math.sqrt(float(problem.ncols)),
            float(opts.arg_delta), float(opts.arg_nu),
            float(opts.arb_delta), float(opts.arb_tau))


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


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def scalar_buffer(scal, n_scal: int, conv_slot: int, length: int):
    """The device scalar buffer of one call: the first ``n_scal`` scalars
    in their slots, the optional converged-at-entry flag in ``conv_slot``,
    zeros elsewhere."""
    sc = torch.zeros(length, dtype=torch.float32, device=scal.device)
    sc[:n_scal] = scal[:n_scal]
    if scal.numel() > n_scal:
        sc[conv_slot] = scal[n_scal]
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
    norm partials of ``nblocks`` blocks."""

    def __init__(self, state, carried, scal, n_scal: int, nblocks: int):
        self.state = [t.contiguous().clone() for t in state]
        self.prev = [t.clone() for t in self.state]
        self.carried = [torch.empty(t.shape, dtype=torch.float32,
                                    device=t.device)
                        for t in carried for _ in range(2)]
        self.sc = scalar_buffer(scal, n_scal, S_CONV, S_LEN)
        self.partial = torch.empty(4 * nblocks, dtype=torch.float32,
                                   device=scal.device)

    def buffers(self, *inputs):
        """The kernel's buffer arguments: state, previous, carried, the
        read-only ``inputs``, scalars, partials."""
        return (self.state + self.prev + self.carried
                + [t.contiguous() for t in inputs] + [self.sc, self.partial])

    def outputs(self):
        """The state and the previous iterate, then the 4 norms (squared
        after a chunk, sqrt'd after a multichunk)."""
        return (*self.state, *self.prev, self.sc[S_NORM:S_NORM + 4])

    def sout(self):
        return torch.stack([self.sc[i] for i in SOUT])
