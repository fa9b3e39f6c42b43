"""Halo-exchange sharded fused PDHG and ADMM (counterpart of
``prost_tpu/parallel/spatial_fused.py``: its ROF, fast-multilabel,
volumetric-TV, tight-multilabel, deblurring and Chebyshev-ADMM routes).

``ShardedPDHG`` (spatial.py) leaves the communication to DTensor, which
gathers or exchanges on every stencil of every iteration.  These routes
schedule it by hand for matched structures, the classic stencil-halo
design:

* the pixel rows (the nx axis) are partitioned over the mesh axis; each
  rank holds its ``rows = nx / S`` rows of every plane in a persistent
  buffer of ``rows + 2 H`` rows, its own rows in the middle;
* before each residual_iter-sized chunk, ``HaloExchange.extend_`` sends
  the rank's first and last ``H = 2 * ri + 2`` owned rows to its ring
  neighbours and receives theirs straight into its top and bottom ``H``
  rows (an edge rank's outer halo is zeroed: ``ppermute``'s semantics);
* each rank runs the halo chunk kernel in place on its buffers through
  its route's light call (``ROFChunk``, ``MLChunk``, ``VolChunk``,
  ``TightChunk`` and ``DeblurChunk``, made once per route with the band's
  row context, which make the scalar buffer, the scratch and the path
  once), recomputing the halo
  rows redundantly: information moves at most one row per half-step (the
  blur's row reach for deblurring, whose halo is that many times wider),
  so the owned rows come out as the whole-plane kernel's, bit for bit (the
  row masks use global rows);
* the kernel's residual norms cover the owned rows only, so one 4-float
  ``all_reduce`` per chunk gives the global norms (in another order of
  summation than one card's, so a long run may take another boyd decision
  after a one-ulp difference), and the step adaptation and the stopping
  test run on them on every rank alike (``chunk_state``).

Communication per chunk: two exchanges of H rows of the state planes (x,
q_x, q_y for ROF; u, q, s for multilabel; u, q for volumetric TV; u, v, q,
p, s for tight; x, yv, q for deblurring) with each neighbour and one
all-reduce of 4 floats.  The JAX package also exchanges the data planes f
(and w; fb and sv) every chunk; here every rank holds the whole problem, so
each cuts its extended data planes once.  The deblur route partitions the
rows of the full-convolution grid (nx2 = nx + kx - 1), as the JAX package
does, and cuts x and q at the same global rows; its chunk recomputes the
carried products B x and grad x from x, so they are not exchanged.  The
planes enter the buffers once per ``run`` (at phase B) and leave once,
where the epilogue refreshes kx and kty.  Phases A and C are
``ShardedPDHG``'s generic step.  There is no VMEM gate: a halo chunk takes
a shard of any size, so the JAX package's banding within a shard has no
counterpart.

``ShardedFusedADMM`` shards Chebyshev graph-projection ADMM the same way,
but one outer iteration moves information 2 cheby_degree + 4 rows (the
halo, ``admm_cheby_halo_rows``), so it exchanges 8 state planes before
every iteration and runs ``admm_iter_halo_`` on them; the chunk's last
iteration takes the owned rows' norms, one 4-float all-reduce and the
Boyd adaptation.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ..backend.admm import ADMMState, BackendADMM, admm_adapt
from ..backend.pdhg import PDHGState, hold_if
from ..config import ProstError
from ..ops.fused_admm import admm_cheby_halo_rows, admm_iter_halo_
from ..ops.fused_deblur import (DeblurChunk, deblur_halo_rows,
                                match_deblur_structure)
from ..ops.fused_multilabel import MLChunk, match_multilabel_structure
from ..ops.fused_rof import ROFChunk, match_rof_structure
from ..ops.fused_tight import TightChunk, match_tight_structure
from ..ops.fused_vol import VolChunk, match_vol_structure
from ..ops.pdhg_chunk import chunk_state
from ..ops.phases import run_phases
from .spatial import ShardedPDHG, shard_state, sp_mesh, whole


class HaloExchange:
    """The communication of one rank of a halo-sharded route over
    ``group``: the halo exchange along axis -2 of extended buffers and the
    all-reduce of the norms, with counts of calls and bytes (sent and
    received by this rank) that the comm-volume test reads."""

    def __init__(self, group, halo: int):
        self.group = group
        self.halo = int(halo)
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        self.prev = dist.get_global_rank(group, rank - 1) if rank else None
        self.next = (dist.get_global_rank(group, rank + 1)
                     if rank < size - 1 else None)
        self.counts = {"exchanges": 0, "sent_bytes": 0, "received_bytes": 0,
                       "all_reduces": 0, "reduced_bytes": 0}

    def extend_(self, buffers) -> None:
        """Fill the top and bottom ``halo`` rows (axis -2) of each extended
        buffer in place: the previous rank's last owned rows into the top,
        the next rank's first owned rows into the bottom, zeros at an edge.
        One message each way per neighbour carries every buffer's rows."""
        H = self.halo
        ops, recv = [], {}
        for peer, send_rows in ((self.prev, slice(H, 2 * H)),
                                (self.next, slice(-2 * H, -H))):
            if peer is None:
                continue
            out = torch.cat([a[..., send_rows, :].reshape(-1)
                             for a in buffers])
            recv[peer] = torch.empty_like(out)
            ops += [dist.P2POp(dist.isend, out, peer, self.group),
                    dist.P2POp(dist.irecv, recv[peer], peer, self.group)]
            self.counts["sent_bytes"] += out.numel() * out.element_size()
            self.counts["received_bytes"] += out.numel() * out.element_size()
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for peer, rows in ((self.prev, slice(0, H)),
                           (self.next, slice(-H, None))):
            at = 0
            for a in buffers:
                dst = a[..., rows, :]
                if peer is None:
                    dst.zero_()
                    continue
                dst.copy_(recv[peer][at:at + dst.numel()].view(dst.shape))
                at += dst.numel()
        self.counts["exchanges"] += 1

    def all_reduce(self, t):
        """The sum of ``t`` over the group (a new tensor)."""
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        self.counts["all_reduces"] += 1
        self.counts["reduced_bytes"] += t.numel() * t.element_size()
        return t


def window(a, lo: int, hi: int):
    """Rows ``lo .. hi - 1`` (axis -2) of ``a``, zeros where they lie
    outside it."""
    out = a.new_zeros(a.shape[:-2] + (hi - lo, a.shape[-1]))
    a_lo, a_hi = max(lo, 0), min(hi, a.shape[-2])
    out[..., a_lo - lo:a_hi - lo, :] = a[..., a_lo:a_hi, :]
    return out


def _geometry(kind: str, grid: str, n: int, n_shards: int, halo: int,
              rule: str, knob: str = "residual_iter") -> int:
    """The rows of one shard of the ``n`` rows of ``grid``; raises where
    they do not divide or fall below the halo (``rule``, set by ``knob``)."""
    if n % n_shards:
        raise ProstError(f"{kind}: {grid}={n} not divisible by {n_shards} "
                         "shards.")
    rows = n // n_shards
    if rows < halo:
        raise ProstError(
            f"{kind}: shard height {rows} < halo {halo} (= {rule}); lower "
            f"{knob} or use fewer shards.")
    return rows


class _Band:
    """A rank's rows of a row-partitioned route: its ``rows`` owned rows
    from global row ``lo + halo``, ``halo`` rows of each neighbour above
    and below them, over the 1-D ``mesh``."""

    def _window(self, a):
        """This rank's extended block of the whole plane stack ``a``."""
        return window(a, self.lo, self.lo + self.rows + 2 * self.halo)

    def _gather(self, a):
        """The whole plane stack of this rank's extended buffer ``a``."""
        own = a[..., self.halo:self.halo + self.rows, :].contiguous()
        return DTensor.from_local(own, self.mesh,
                                  [Shard(a.dim() - 2)]).full_tensor()


class _HaloRoute(_Band, ShardedPDHG):
    """The phase plan of a halo-sharded route on ``ShardedPDHG``'s state.
    A subclass names its structure (``kind``, ``_match``), its planes
    (``_planes``: flat x, y -> plane stacks with the rows on axis -2;
    ``_flat``: back), its data planes (``_data``) and the class of its
    light chunk call (``_light``, made once with the band's row context);
    the rows it partitions (``_grid``, a key of its match) and its halo
    (``_halo``, ``_halo_rule``) where they differ from the pixel rows and
    2 ri + 2."""

    kind = ""
    _grid = "nx"
    _halo_rule = "2*residual_iter + 2"

    def __init__(self, problem, opts, solver_opts, mesh,
                 axis_name: str = "sp"):
        super().__init__(problem, opts, solver_opts, mesh, axis_name)
        if opts.reference_residuals:
            raise ProstError(
                f"{self.kind}: the fused chunk kernels compute "
                "consistent-mode residual norms; reference_residuals=True "
                "requires the generic path (BackendPDHG / ShardedPDHG).")
        if opts.stepsize == "alg2":
            raise ProstError(f"{self.kind}: alg2 changes the step sizes "
                             "every iteration, a chunk holds them fixed; "
                             "use ShardedPDHG.")
        self.m = self._match(problem)
        if self.m is None:
            raise ProstError(f"{self.kind}: problem does not match the "
                             "fused structure; use ShardedPDHG for the "
                             "generic sharded path.")
        n_shards, rank = self.mesh.size(), self.mesh.get_local_rank()
        self.ri = max(int(opts.residual_iter), 1)
        self.halo = self._halo()
        self.rows = _geometry(self.kind, self._grid, self.m[self._grid],
                              n_shards, self.halo, self._halo_rule)
        self.lo = rank * self.rows - self.halo
        # the data planes' extended blocks, cut once from the whole problem
        self.data = tuple(self._window(self.m[k]) for k in self._data)
        self.exchange = HaloExchange(self.mesh.get_group(), self.halo)
        # the band: the global rows, its rows, row_offset, own_lo, own_hi
        self.call = self._light(
            self.m, self.ri, problem.scaling_left.device,
            (self.m["nx"], self.rows + 2 * self.halo, self.lo, self.halo,
             self.halo + self.rows))

    def _halo(self) -> int:
        return 2 * self.ri + 2

    def run(self, state: PDHGState, until_iter: int,
            start_iter: int) -> PDHGState:
        return run_phases(state, start_iter, until_iter, self.ri,
                          1 % self.ri, self.generic_step, self._enter,
                          self._chunk, epilogue=self._leave)

    def _enter(self, s: PDHGState):
        """Phase B's carry: the state and this rank's persistent extended
        buffers of its planes and of the previous iterate's, which every
        chunk updates in place."""
        cur = self._planes(whole(s.x), whole(s.y))
        prev = self._planes(whole(s.x_prev), whole(s.y_prev))
        return (s, tuple(self._window(a) for a in cur),
                tuple(self._window(a) for a in prev))

    def _chunk(self, carry):
        s, cur, prev = carry
        self.exchange.extend_(cur)
        norms2 = self.exchange.all_reduce(self._chunk_step(s, cur, prev))
        # the planes live in the buffers until _leave: the state's vectors
        # stay as they are, its scalars take the chunk's residual step
        s = chunk_state(self, s, self.ri, s.x, s.y, s.x_prev, s.y_prev,
                        norms2)
        return s, cur, prev

    def _chunk_step(self, s: PDHGState, cur, prev):
        """This rank's chunk on its buffers; returns its owned rows'
        norms2."""
        return self.call(cur, prev, *self.data, s.tau, s.sigma, s.theta,
                         s.converged)

    def _leave(self, carry) -> PDHGState:
        """The state after phase B: the owned rows back into sharded
        vectors, and the epilogue's kx, kty, kx_prev, kty_prev."""
        s, cur, prev = carry
        x, y = self._flat(*(self._gather(a) for a in cur))
        xp, yp = self._flat(*(self._gather(a) for a in prev))
        lin = self.problem.linop
        s = dataclasses.replace(
            s, x=x, y=y, x_prev=xp, y_prev=yp, kx=lin.apply(x),
            kty=lin.apply_adjoint(y), kx_prev=lin.apply(xp),
            kty_prev=lin.apply_adjoint(yp))
        return shard_state(s, self.mesh)


class ShardedFusedROF(_HaloRoute):
    """Halo-sharded fused backend for matched ROF/TV structures
    (``ops/fused_rof.py``): one exchange of x, q_x, q_y halo rows and one
    4-float all-reduce per chunk around ``rof_chunk_halo``.  Requires
    nx % S == 0 and nx / S >= 2 * residual_iter + 2; follows the
    trajectory of ``FusedROFPDHG``'s ROF route up to the order of the norm
    sums."""

    kind = "ShardedFusedROF"
    _data = ("f", "w")
    _light = ROFChunk

    def _match(self, problem):
        return match_rof_structure(problem)

    def _planes(self, x, y):
        nx, ny = self.m["nx"], self.m["ny"]
        return x.reshape(nx, ny), y.reshape(2, nx, ny)

    def _flat(self, x, q):
        return x.reshape(-1), q.reshape(-1)


class ShardedFusedMultilabel(_HaloRoute):
    """Halo-sharded fused backend for the fast-multilabel structure
    (``ops/fused_multilabel.py``): one exchange of the u, q and s halo rows
    (3L + 1 planes) and one 4-float all-reduce per chunk around
    ``ml_chunk_halo``."""

    kind = "ShardedFusedMultilabel"
    _data = ("f",)
    _light = MLChunk

    def _match(self, problem):
        return match_multilabel_structure(problem)

    def _planes(self, x, y):
        L, nx, ny = self.m["L"], self.m["nx"], self.m["ny"]
        nq = 2 * L * nx * ny
        return (x.reshape(L, nx, ny), y[:nq].reshape(2 * L, nx, ny),
                y[nq:].reshape(nx, ny))

    def _flat(self, u, q, s):
        return u.reshape(-1), torch.cat([q.reshape(-1), s.reshape(-1)])



class ShardedFusedVol(_HaloRoute):
    """Halo-sharded fused backend for the volumetric-TV structure
    (``ops/fused_vol.py``): the nx axis of the (L, nx, ny) volume is
    partitioned (the label axis keeps its Dirichlet ends on every rank);
    one exchange of the u and q halo rows (4L planes) and one 4-float
    all-reduce per chunk around ``vol_chunk_halo``."""

    kind = "ShardedFusedVol"
    _data = ("f", "w")
    _light = VolChunk

    def _match(self, problem):
        return match_vol_structure(problem)

    def _planes(self, x, y):
        L, nx, ny = self.m["L"], self.m["nx"], self.m["ny"]
        return x.reshape(L, nx, ny), y.reshape(3, L, nx, ny)

    def _flat(self, u, q):
        return u.reshape(-1), q.reshape(-1)


class ShardedFusedTight(_HaloRoute):
    """Halo-sharded fused backend for the tight multilabel relaxation
    (``ops/fused_tight.py``): one exchange of the u, v, q, p and s halo rows
    (3L + 4k + 1 planes; v and p are pointwise, but the halo rows' u and q
    updates read them) and one 4-float all-reduce per chunk around
    ``tight_chunk_halo``."""

    kind = "ShardedFusedTight"
    _data = ("f",)
    _light = TightChunk

    def _match(self, problem):
        return match_tight_structure(problem)

    def _planes(self, x, y):
        L, k, nx, ny = (self.m[key] for key in ("L", "k", "nx", "ny"))
        nL, nk2 = nx * ny * L, 2 * nx * ny * k
        return (x[:nL].reshape(L, nx, ny), x[nL:].reshape(2 * k, nx, ny),
                y[:2 * nL].reshape(2 * L, nx, ny),
                y[2 * nL:2 * nL + nk2].reshape(2 * k, nx, ny),
                y[2 * nL + nk2:].reshape(nx, ny))

    def _flat(self, u, v, q, p, s):
        return (torch.cat([u.reshape(-1), v.reshape(-1)]),
                torch.cat([q.reshape(-1), p.reshape(-1), s.reshape(-1)]))


class ShardedFusedDeblur(_HaloRoute):
    """Halo-sharded fused backend for TV deblurring (``ops/fused_deblur.py``):
    the rows of the (nx2, ny2) full-convolution grid partitioned over the
    ranks (nx2 % S == 0), x and q cut at the same global rows; the halo is
    (2 ri + 2) times the blur's row reach (``deblur_halo_rows``), so prefer
    a small residual_iter with a tall blur.  One exchange of the x, yv and
    q halo rows and one 4-float all-reduce per chunk around
    ``deblur_chunk_halo``."""

    kind = "ShardedFusedDeblur"
    _grid = "nx2"
    _halo_rule = "(2*residual_iter + 2) * conv row reach"
    _data = ("fb", "sv")
    _light = DeblurChunk

    def _match(self, problem):
        return match_deblur_structure(problem, self.prox_g, self.prox_fstar)

    def _halo(self) -> int:
        return deblur_halo_rows(self.ri, self.m["taps"])

    def _planes(self, x, y):
        nx, ny, nx2, ny2 = (self.m[k] for k in ("nx", "ny", "nx2", "ny2"))
        m2 = nx2 * ny2
        return (x.reshape(nx, ny), y[:m2].reshape(nx2, ny2),
                y[m2:].reshape(2, nx, ny))

    def _flat(self, x, yv, q):
        # the gathered x and q hold the nx2 rows of the grid: the image's
        # nx come first
        nx = self.m["nx"]
        return (x[:nx].reshape(-1),
                torch.cat([yv.reshape(-1), q[:, :nx].reshape(-1)]))



# the ADMM state arrays in the order of the halo iteration's arguments
_ADMM_PLANES = ("x_half", "x_proj", "x_dual", "z_half", "z_proj", "z_dual",
                "cg_warm")


class ShardedFusedADMM(_Band, BackendADMM):
    """Halo-sharded fused graph-projection ADMM for matched ROF/TV
    structures with the Chebyshev projection: the pixel rows partitioned
    over ``mesh``'s ``axis_name``, one exchange of 8 state planes (x_half,
    x_proj, x_dual, z_half (2), z_dual (2), cg_warm; z_proj is never read
    before the iteration writes it) before every outer iteration, since
    one iteration moves information 2 cheby_degree + 4 rows, and one
    ``admm_iter_halo_`` launch sequence per iteration.  The chunk's last
    iteration takes the owned rows' norms, one 4-float all-reduce and
    ``admm_adapt``.  Phases A and C run the generic Chebyshev step on the
    gathered state on every rank (which holds the whole problem), the
    result re-sharded; the chunks start where iteration % ri == 0.

    CGLS takes two global dot products every CG step, so it is refused;
    there is no multichunk, as in the JAX package."""

    kind = "ShardedFusedADMM"

    def __init__(self, problem, opts, solver_opts, mesh,
                 axis_name: str = "sp"):
        if opts.projection not in ("auto", "cheby"):
            raise ProstError(
                "ShardedFusedADMM: requires projection='auto' or 'cheby' "
                "(CGLS needs global reductions every CG step; use the "
                "generic BackendADMM for that).")
        super().__init__(problem, dataclasses.replace(opts,
                                                      projection="cheby"),
                         solver_opts)
        self.mesh = sp_mesh(mesh, axis_name)
        self.axis_name = axis_name
        self.m = match_rof_structure(problem)
        if self.m is None:
            raise ProstError("ShardedFusedADMM: problem does not match the "
                             "fused ROF/TV structure.")
        n_shards, rank = self.mesh.size(), self.mesh.get_local_rank()
        self.ri = max(int(self.opts.residual_iter), 1)
        self.degree = int(self.opts.cheby_degree)
        self.halo = admm_cheby_halo_rows(self.degree)
        self.rows = _geometry(self.kind, "nx", self.m["nx"], n_shards,
                              self.halo, "2*cheby_degree + 4, rounded up "
                              "to 8", "cheby_degree")
        self.lo = rank * self.rows - self.halo
        like = problem.scaling_left
        self.lmb_t = like.new_full((), float(self.m["lmb"]))
        self.radius_t = like.new_full((), float(self.m["radius"]))
        self.data = tuple(self._window(self.m[k]) for k in ("f", "w"))
        self.exchange = HaloExchange(self.mesh.get_group(), self.halo)

    def _whole(self, s: ADMMState) -> ADMMState:
        return dataclasses.replace(s, **{
            f.name: whole(getattr(s, f.name)) for f in dataclasses.fields(s)})

    def initial_state(self) -> ADMMState:
        return shard_state(super().initial_state(), self.mesh)

    def generic_step(self, s: ADMMState, it: int) -> ADMMState:
        return shard_state(super().generic_step(self._whole(s), it),
                           self.mesh)

    def current_solution(self, state: ADMMState):
        return super().current_solution(self._whole(state))

    def run(self, state: ADMMState, until_iter: int,
            start_iter: int) -> ADMMState:
        return run_phases(state, start_iter, until_iter, self.ri, 0,
                          self.generic_step, self._enter, self._chunk,
                          epilogue=self._leave)

    def _enter(self, s: ADMMState):
        """Phase B's carry: the state and this rank's persistent extended
        buffers of the 7 state arrays (x-like (nxb, ny), z-like (2, nxb,
        ny)), which every iteration updates in place."""
        nx, ny = self.m["nx"], self.m["ny"]
        return s, tuple(
            self._window(whole(getattr(s, name)).reshape(
                (2, nx, ny) if name.startswith("z") else (nx, ny)))
            for name in _ADMM_PLANES)

    def _chunk(self, carry):
        s, bufs = carry
        xh, xp, xd, zh, zp, zd, warm = bufs
        m = self.m
        scal = torch.stack([s.rho, self.lmb_t, self.radius_t,
                            s.converged.to(s.rho.dtype)])
        for k in range(self.ri):
            self.exchange.extend_((xh, xp, xd, zh, zd, warm))
            norms2 = admm_iter_halo_(
                *bufs, *self.data, scal, self.degree, self.opts.alpha,
                m["nx"], self.lo, self.halo, self.halo + self.rows,
                m["dataterm"], with_norms=k == self.ri - 1)
        norms = torch.sqrt(self.exchange.all_reduce(norms2))
        # the adaptation sees the post-increment counter of the chunk's last
        # iteration; the duals live in the buffers, which take its rescale
        new, fac = admm_adapt(self.problem, self.opts, self.tols,
                              dataclasses.replace(
                                  s, iteration=s.iteration + self.ri),
                              norms[0], norms[1], norms[2], norms[3])
        fac = torch.where(s.converged, torch.ones_like(fac), fac)
        xd.mul_(fac)
        zd.mul_(fac)
        return hold_if(s.converged, s, new), bufs

    def _leave(self, carry) -> ADMMState:
        """The state after phase B: the owned rows back into sharded
        vectors."""
        s, bufs = carry
        s = dataclasses.replace(s, **{
            name: self._gather(a).reshape(-1)
            for name, a in zip(_ADMM_PLANES, bufs)})
        return shard_state(s, self.mesh)
