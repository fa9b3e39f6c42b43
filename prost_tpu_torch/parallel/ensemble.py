"""Batched problem ensembles: B instances of one structure solved together
(counterpart of ``prost_tpu/parallel/ensemble.py``; BASELINE config 5,
``ensemble1024x128``).

All instances share one static structure (the same blocks, prox kinds and
sizes); their data (prox coefficients, block values) may differ.

* ``stack_problems`` (and ``stack_trees`` for any tree of the port's
  dataclasses) stacks B trees into one: every leaf that differs between
  instances, a tensor or a Python number among a prox's ``coeffs``, gets a
  leading batch axis; a leaf equal in every instance stays shared.  Any
  other difference (a string, an int, a shape, a prox kind) raises.
* ``BatchedPDHG`` iterates every instance at once.  The generic step is the
  port's ``pdhg_step`` under ``torch.func.vmap``, each instance's problem
  and proxes rebuilt inside the mapped function from its slices of the
  stacked leaves.  ROF, fast-multilabel, deblur, tight-multilabel and
  volumetric-TV ensembles take a fused route instead, one batched chunk
  kernel launch (sequence) per chunk for all instances
  (``rof_chunk_batched`` where a cluster holds an instance, else
  ``ROFBatchedChunk``; ``ml_chunk_batched``, ``deblur_chunk_batched``,
  ``tight_chunk_batched`` and ``vol_chunk_batched`` through their light
  calls ``MLBatchedChunk``, ``DeblurBatchedChunk``, ``TightBatchedChunk``
  and ``VolBatchedChunk``; the light calls in place on the run's own
  vectors) on the phase plan of ``ops/phases.py``.  A route is matched when every instance matches it
  with the same launch constants (sizes, taps, preconditioner constants);
  its per-instance data is stacked.  Other ensembles (deblur frames with
  different blurs, tight instances with different label counts) take the
  generic step.

As in the JAX package, converged instances go on iterating: the run stops
when every instance has converged or at ``until``.  The state's scalars,
``iteration`` and ``converged`` included, have shape (B,), its vectors
(B, n).  The JAX package's fallback to the generic path when a kernel fails
to compile is not ported: a matched route on a card launches its kernels or
raises.

With a ``mesh`` (``make_mesh``; every rank passes the same B problems) the
batch axis is split over the ranks of its ``dp`` axis: rank r takes
instances [r B/S, (r + 1) B/S) and runs the routes above on them alone, so
its state holds B/S instances, with no collective inside a step or a
chunk.  The stop rule spans the ranks: after every step or chunk that may
change a converged flag (a residual iteration) one all-reduce of one flag
tells every rank whether every instance of every rank has converged, which
is when the one-card run holds its state.  Every instance then takes the
trajectory it takes on one card.  ``current_solution`` (and ``gather``)
all-gather the instances.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..backend.pdhg import (BackendPDHG, PDHGOptions, PDHGState, hold_if,
                            pdhg_step, residual_and_adapt)
from ..config import ProstError, dtype as config_dtype
from ..ops.fused_deblur import DeblurBatchedChunk, match_deblur_structure
from ..ops.fused_multilabel import MLBatchedChunk, match_multilabel_structure
from ..ops.fused_rof import (ROFBatchedChunk, match_rof_structure,
                             rof_chunk_batched)
from ..ops.fused_tight import TightBatchedChunk, match_tight_structure
from ..ops.fused_vol import VolBatchedChunk, match_vol_structure
from ..ops.pdhg_chunk import dead_dual_flat, own_vectors
from ..ops.phases import run_phases
from ..solver import SolverOptions
from .spatial import sp_mesh

_MISMATCH = "stack_problems: problems have different static structure."


# ---------------------------------------------------------------------------
# stacking trees of instances
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class Stacked:
    """B instances of one tree: ``tree`` is the first instance's, with the
    leaf at each of ``paths`` replaced by the stack of that leaf's values
    (a leading batch axis).  A path is the tuple of field names and tuple
    indices that leads to the leaf."""

    tree: object
    paths: tuple

    def leaves(self) -> list:
        """The stacked leaves, in the order of ``paths``."""
        return [_get(self.tree, p) for p in self.paths]

    def instance(self, leaves):
        """``tree`` with the stacked leaves replaced by ``leaves``: inside a
        vmap over the instances, one instance's tree."""
        tree = self.tree
        for path, leaf in zip(self.paths, leaves):
            tree = _put(tree, path, leaf)
        return tree


def _get(tree, path):
    for key in path:
        tree = getattr(tree, key) if isinstance(key, str) else tree[key]
    return tree


def _put(tree, path, leaf):
    if not path:
        return leaf
    key, rest = path[0], path[1:]
    if isinstance(key, str):
        return dataclasses.replace(
            tree, **{key: _put(getattr(tree, key), rest, leaf)})
    return type(tree)(_put(v, rest, leaf) if i == key else v
                      for i, v in enumerate(tree))


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _stack(trees, path, paths, device):
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        if any(not isinstance(t, torch.Tensor) or t.shape != t0.shape
               or t.dtype != t0.dtype for t in trees):
            raise ProstError(_MISMATCH)
        if all(torch.equal(t, t0) for t in trees[1:]):
            return t0
        paths.append(path)
        return torch.stack(trees)
    if _is_number(t0) and "coeffs" in path:
        # a prox coefficient is data (a leaf of the JAX package's pytrees)
        if not all(_is_number(t) for t in trees):
            raise ProstError(_MISMATCH)
        if all(t == t0 for t in trees[1:]):
            return t0
        paths.append(path)
        return torch.tensor([float(t) for t in trees], dtype=config_dtype(),
                            device=device)
    if isinstance(t0, (tuple, list)):
        if any(type(t) is not type(t0) or len(t) != len(t0) for t in trees):
            raise ProstError(_MISMATCH)
        return type(t0)(_stack([t[i] for t in trees], path + (i,), paths,
                               device) for i in range(len(t0)))
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        if any(type(t) is not type(t0) for t in trees):
            raise ProstError(_MISMATCH)
        return dataclasses.replace(t0, **{
            f.name: _stack([getattr(t, f.name) for t in trees],
                           path + (f.name,), paths, device)
            for f in dataclasses.fields(t0) if f.init})
    if any(type(t) is not type(t0) or t != t0 for t in trees[1:]):
        raise ProstError(_MISMATCH)
    return t0


def stack_trees(trees, device=None) -> Stacked:
    """Stack structurally identical trees of the port's dataclasses,
    tuples and tensors.  A differing Python number among a prox's
    ``coeffs`` is stacked as a tensor of the configured dtype on
    ``device``."""
    paths = []
    tree = _stack(list(trees), (), paths, device)
    return Stacked(tree, tuple(paths))


def stack_problems(problems) -> Stacked:
    """Stack structurally identical Problems into one batched tree
    (``Stacked``; its ``tree`` is a Problem whose differing leaves have a
    leading batch axis)."""
    if not problems:
        raise ProstError("stack_problems: empty list.")
    return stack_trees(problems, problems[0].scaling_left.device)


# ---------------------------------------------------------------------------
# the ensemble solver
# ---------------------------------------------------------------------------

# The fused routes in the JAX package's order of matching: (name, matcher
# of one instance and its backend, the keys every instance must share, the
# planes stacked, the scalars gathered per instance).  A shared key is a
# launch constant of the batched kernel.
_ROUTES = (
    ("rof", lambda p, b: match_rof_structure(p),
     ("nx", "ny", "dataterm"), ("f", "w"), ("lmb", "radius")),
    ("ml", lambda p, b: match_multilabel_structure(p),
     ("nx", "ny", "L"), ("f",), ("radius", "d_s")),
    # a MinProblem's data terms are prox_f: the deblur matcher reads the
    # prox_fstar the backend made from them by Moreau
    ("deblur", lambda p, b: match_deblur_structure(p, b.prox_g, b.prox_fstar),
     ("nx", "ny", "nx2", "ny2", "taps", "sig_q", "tau_t"), ("fb", "sv"),
     ("lmb", "radius")),
    ("tight", lambda p, b: match_tight_structure(p),
     ("nx", "ny", "L", "k", "taps", "consts"), ("f",), ("radius", "d_s")),
    ("vol", lambda p, b: match_vol_structure(p),
     ("L", "nx", "ny", "dataterm"), ("f", "w"), ("lmb", "radius")),
)
ROUTE_NAMES = tuple(r[0] for r in _ROUTES)


def _match_all(problems, backends, match, keys, stacks, scalars):
    """One fused route's batched matching: every instance matches (``match``
    of its problem and backend) with the same ``keys``; the ``stacks`` of
    their matches are stacked, the ``scalars`` gathered into (B,) float32
    tensors; None otherwise."""
    ms = [match(p, b) for p, b in zip(problems, backends)]
    if any(m is None for m in ms):
        return None
    if len({tuple(m[k] for k in keys) for m in ms}) != 1:
        return None
    out = {k: ms[0][k] for k in keys}
    out.update({k: torch.stack([m[k] for m in ms]) for k in stacks})
    dev = problems[0].scaling_left.device
    out.update({k: torch.tensor([m[k] for m in ms], dtype=torch.float32,
                                device=dev) for k in scalars})
    return out


class BatchedPDHG:
    """Solve a batch of problem instances together with PDHG.

    The generic iteration is ``pdhg_step`` vmapped over (problem data,
    proxes, state); the fused routes run one batched chunk launch sequence
    per chunk for all instances.  The run holds the state once every
    instance has converged, and stops at ``until``.  ``run(state, until,
    start)`` takes the host's iteration count like every port backend.
    With ``mesh``, this rank's share of the instances along ``axis_name``
    (``batch`` of them); ``flag_reduces`` counts the all-reduces of the
    stop rule."""

    def __init__(self, problems, opts: PDHGOptions = None,
                 solver_opts: SolverOptions = None, mesh=None,
                 axis_name: str = "dp"):
        self.group = None
        self.flag_reduces = 0
        if mesh is not None:
            n = mesh.size()
            if len(problems) % n:
                raise ProstError(
                    f"BatchedPDHG: batch size {len(problems)} must be "
                    f"divisible by the mesh's {n} devices (the batch axis "
                    "is sharded evenly over the mesh).")
            dp = sp_mesh(mesh, axis_name)
            per = len(problems) // dp.size()
            rank = dp.get_local_rank()
            problems = problems[rank * per:(rank + 1) * per]
            self.group = dp.get_group()
        # scale_steps_operator=False by default: a per-instance normest
        # would run B host-side power iterations (as in the JAX package)
        self.opts = opts or PDHGOptions(scale_steps_operator=False)
        self.solver_opts = solver_opts or SolverOptions(verbose=False)
        self.ri = max(int(self.opts.residual_iter), 1)
        self.batched_problem = stack_problems(problems)
        self.batch = len(problems)
        backends = [BackendPDHG(p, self.opts, self.solver_opts)
                    for p in problems]
        self._backend0 = backends[0]
        dev = problems[0].scaling_left.device
        self.prox_g = stack_trees([b.prox_g for b in backends], dev)
        self.prox_fstar = stack_trees([b.prox_fstar for b in backends], dev)
        # the first route every instance matches, in the JAX order; alg2
        # changes the steps every iteration and the reference-exact
        # residuals need the generic path
        self.rof = self.ml = self.deblur = self.tight = self.vol = None
        if self.opts.stepsize != "alg2" and not self.opts.reference_residuals:
            for name, match, keys, stacks, scalars in _ROUTES:
                m = _match_all(problems, backends, match, keys, stacks,
                               scalars)
                if m is not None:
                    setattr(self, name, m)
                    break

    @property
    def tols(self):
        return self._backend0.tols

    # ------------------------------------------------------------------
    def initial_state(self) -> PDHGState:
        """Instance 0's initial state, copied to every instance (a copy,
        not a view: the kernels write their buffers in place)."""
        s0 = self._backend0.initial_state()
        return PDHGState(**{
            k: v.unsqueeze(0).repeat(self.batch, *[1] * v.dim())
            for k, v in vars(s0).items()})

    def _all_converged(self, s: PDHGState):
        """Whether every instance has converged: this rank's, and with a
        mesh every rank's (one all-reduce of one flag)."""
        done = s.converged.all()
        if self.group is None:
            return done
        flag = done.to(s.tau.dtype).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        self.flag_reduces += 1
        return flag[0] > 0.5

    # ------------------------------------------------------------------
    def generic_step(self, s: PDHGState, it: int, done=None) -> PDHGState:
        """One generic iteration of every instance (``it`` the host's count
        of the iteration), the whole state held once every instance has
        converged (``done``, the run's flag, or ``_all_converged``)."""
        opts, tols, do_res = self.opts, self.tols, it % self.ri == 0
        P, G, F = self.batched_problem, self.prox_g, self.prox_fstar
        n_p, n_g = len(P.paths), len(G.paths)

        def one(fields, *leaves):
            new = pdhg_step(P.instance(leaves[:n_p]),
                            G.instance(leaves[n_p:n_p + n_g]),
                            F.instance(leaves[n_p + n_g:]), opts, tols,
                            PDHGState(**fields), do_res)
            return vars(new)

        new = torch.func.vmap(one)(vars(s), *P.leaves(), *G.leaves(),
                                   *F.leaves())
        if done is None:
            done = self._all_converged(s)
        return hold_if(done, s, PDHGState(**new))

    def _linop(self, name: str, v):
        """``linop.apply`` or ``linop.apply_adjoint`` of every instance on
        the rows of ``v``."""
        P = self.batched_problem

        def one(v, *leaves):
            return getattr(P.instance(leaves).linop, name)(v)

        return torch.func.vmap(one)(v, *P.leaves())

    def _epilogue(self, s: PDHGState) -> PDHGState:
        """The operator products the chunks do not carry, per instance."""
        return dataclasses.replace(
            s, kx=self._linop("apply", s.x),
            kty=self._linop("apply_adjoint", s.y),
            kx_prev=self._linop("apply", s.x_prev),
            kty_prev=self._linop("apply_adjoint", s.y_prev))

    def _scal(self, s: PDHGState, a, b, done):
        """The (6, B) scalar rows of a batched chunk: tau, sigma, theta, the
        family's two scalars ``a`` and ``b``, and every instance's converged
        flag set once all have converged (``done``)."""
        done = done.to(s.tau.dtype).expand(self.batch)
        return torch.stack([s.tau, s.sigma, s.theta, a, b, done])

    def _after_chunk(self, s: PDHGState, x, y, x_prev, y_prev, norms2,
                     done):
        """``s`` after a batched chunk that returned the instances' flat
        iterates and (4, B) squared norms: every instance's residual step
        and adaptation, held once all had converged (``done``)."""
        ri = self.ri
        norms = torch.sqrt(norms2)
        new = dataclasses.replace(s, x=x, y=y, x_prev=x_prev, y_prev=y_prev)
        # the chunk ends on the residual iteration s.iteration + ri - 1
        new = residual_and_adapt(self.batched_problem.tree, self.opts,
                                 self.tols, new, norms[0], norms[1],
                                 norms[2], norms[3], s.iteration + (ri - 1))
        new = dataclasses.replace(new, iteration=new.iteration + ri)
        return hold_if(done, s, new)

    def _rof_call(self, device) -> ROFBatchedChunk:
        """The ROF route's light call (``ROFBatchedChunk``), made once per
        route; its ``inplace`` says whether the route calls it."""
        if "call" not in self.rof:
            self.rof["call"] = ROFBatchedChunk(self.rof, self.batch, self.ri,
                                               device)
        return self.rof["call"]

    def _rof_chunk(self, s: PDHGState, done) -> PDHGState:
        """One batched chunk: in place on the views of the run's own x, y,
        x_prev and y_prev through the light call where no cluster holds an
        instance (its tiled launch or streaming sequence), else the
        cluster launch of ``rof_chunk_batched``, which returns new
        vectors."""
        r, B = self.rof, self.batch
        nx, ny = r["nx"], r["ny"]
        call = self._rof_call(s.x.device)
        if call.inplace:
            def planes(x, y):
                return x.view(B, nx, ny), y.view(B, 2, nx, ny)

            norms2 = call(planes(s.x, s.y), planes(s.x_prev, s.y_prev),
                          r["f"], r["w"], s.tau, s.sigma, s.theta, done)
            return self._after_chunk(s, s.x, s.y, s.x_prev, s.y_prev, norms2,
                                     done)
        x2, q2, xp, qp, norms2 = rof_chunk_batched(
            s.x.reshape(B, nx, ny), s.y.reshape(B, 2, nx, ny), r["f"],
            r["w"], self._scal(s, r["lmb"], r["radius"], done),
            self.ri, r["dataterm"])
        return self._after_chunk(s, x2.reshape(B, -1), q2.reshape(B, -1),
                                 xp.reshape(B, -1), qp.reshape(B, -1), norms2,
                                 done)

    def _rof_canonical(self, s: PDHGState) -> PDHGState:
        """The dead dual coordinates of every instance's y and y_prev zeroed
        once per run, as the JAX batched ROF run does (the batched ml and
        vol runs do not), into new vectors; where the light call works in
        place, also the run's own copies of x and x_prev, so no state a
        caller holds changes under it."""
        nx, ny = self.rof["nx"], self.rof["ny"]

        def canon(y):
            return torch.func.vmap(lambda v: dead_dual_flat(v, 1, nx, ny))(
                y).contiguous()

        s = dataclasses.replace(s, y=canon(s.y), y_prev=canon(s.y_prev))
        if not self._rof_call(s.x.device).inplace:
            return s
        return dataclasses.replace(
            s, x=s.x.clone(memory_format=torch.contiguous_format),
            x_prev=s.x_prev.clone(memory_format=torch.contiguous_format))

    def _ml_chunk(self, s: PDHGState, done) -> PDHGState:
        """One batched chunk in place on the views of the run's own x, y,
        x_prev and y_prev (``own_vectors``) through the route's light call
        (``MLBatchedChunk``, made once per route)."""
        m, B = self.ml, self.batch
        L, nx, ny = m["L"], m["nx"], m["ny"]
        n2 = 2 * L * nx * ny

        def planes(x, y):
            return (x.view(B, L, nx, ny), y[:, :n2].view(B, 2 * L, nx, ny),
                    y[:, n2:].view(B, nx, ny))

        if "call" not in m:
            m["call"] = MLBatchedChunk(m, B, self.ri, s.x.device)
        norms2 = m["call"](planes(s.x, s.y), planes(s.x_prev, s.y_prev),
                           m["f"], s.tau, s.sigma, s.theta, done)
        return self._after_chunk(s, s.x, s.y, s.x_prev, s.y_prev, norms2,
                                 done)

    def _vol_chunk(self, s: PDHGState, done) -> PDHGState:
        """One batched chunk in place on the views of the run's own x, y,
        x_prev and y_prev (``own_vectors``) through the route's light call
        (``VolBatchedChunk``, made once per route)."""
        v, B = self.vol, self.batch
        L, nx, ny = v["L"], v["nx"], v["ny"]

        def volumes(x, y):
            return x.view(B, L, nx, ny), y.view(B, 3, L, nx, ny)

        if "call" not in v:
            v["call"] = VolBatchedChunk(v, B, self.ri, s.x.device)
        norms2 = v["call"](volumes(s.x, s.y), volumes(s.x_prev, s.y_prev),
                           v["f"], v["w"], s.tau, s.sigma, s.theta, done)
        return self._after_chunk(s, s.x, s.y, s.x_prev, s.y_prev, norms2,
                                 done)

    def _deblur_chunk(self, s: PDHGState, done) -> PDHGState:
        """The frames' chunk in place on views of the run's own flat
        vectors (``own_vectors``) in the port's layout, x (nx, ny), yv
        (nx2, ny2), q (2, nx, ny) (the JAX run packs x and q into the
        embedded (nx2, ny2) geometry instead), through the route's light
        call (``DeblurBatchedChunk``, made once per route)."""
        d, B = self.deblur, self.batch
        nx, ny, nx2, ny2 = d["nx"], d["ny"], d["nx2"], d["ny2"]
        m2 = nx2 * ny2

        def planes(x, y):
            return (x.view(B, nx, ny), y[:, :m2].view(B, nx2, ny2),
                    y[:, m2:].view(B, 2, nx, ny))

        if "call" not in d:
            d["call"] = DeblurBatchedChunk(d, B, self.ri, s.x.device)
        norms2 = d["call"](planes(s.x, s.y), planes(s.x_prev, s.y_prev),
                           d["fb"], d["sv"], s.tau, s.sigma, s.theta, done)
        return self._after_chunk(s, s.x, s.y, s.x_prev, s.y_prev, norms2,
                                 done)

    def _tight_chunk(self, st: PDHGState, done) -> PDHGState:
        """One batched chunk in place on the views of the run's own x, y,
        x_prev and y_prev (``own_vectors``): u and v in x, q, p and s in y,
        through the route's light call (``TightBatchedChunk``, made once
        per route)."""
        t, B = self.tight, self.batch
        L, k, nx, ny = t["L"], t["k"], t["nx"], t["ny"]
        nL, nk2 = nx * ny * L, 2 * nx * ny * k

        def planes(x, y):
            return (x[:, :nL].view(B, L, nx, ny),
                    x[:, nL:].view(B, 2 * k, nx, ny),
                    y[:, :2 * nL].view(B, 2 * L, nx, ny),
                    y[:, 2 * nL:2 * nL + nk2].view(B, 2 * k, nx, ny),
                    y[:, 2 * nL + nk2:].view(B, nx, ny))

        if "call" not in t:
            t["call"] = TightBatchedChunk(t, B, self.ri, st.x.device)
        norms2 = t["call"](planes(st.x, st.y), planes(st.x_prev, st.y_prev),
                           t["f"], st.tau, st.sigma, st.theta, done)
        return self._after_chunk(st, st.x, st.y, st.x_prev, st.y_prev,
                                 norms2, done)

    def run(self, state: PDHGState, until_iter: int,
            start_iter: int) -> PDHGState:
        """Iterations ``start_iter`` (the host's copy of ``state.iteration``)
        to ``until_iter``: through a fused route's phase plan where one
        matched (generic steps until a chunk aligns, the ROF
        canonicalization, chunks, the epilogue, a generic tail), else by
        generic steps."""
        # whether every instance has converged, renewed after each step
        # or chunk that may set a flag (a residual iteration)
        done = [self._all_converged(state)]

        def generic(s, it):
            s = self.generic_step(s, it, done[0])
            if it % self.ri == 0:
                done[0] = self._all_converged(s)
            return s

        name = next((n for n in ROUTE_NAMES if getattr(self, n) is not None),
                    None)
        if name is None:
            for it in range(start_iter, until_iter):
                state = generic(state, it)
            return state
        route_chunk = getattr(self, f"_{name}_chunk")

        def chunk(s):
            s = route_chunk(s, done[0])
            done[0] = self._all_converged(s)
            return s

        # the ROF canonicalization; the ml, deblur, tight and vol chunks
        # work in place on the run's own copies of the state's vectors
        canonicalize = {"rof": self._rof_canonical, "ml": own_vectors,
                        "deblur": own_vectors, "tight": own_vectors,
                        "vol": own_vectors}.get(name)
        return run_phases(state, start_iter, until_iter, self.ri, 1 % self.ri,
                          generic, canonicalize, chunk,
                          epilogue=self._epilogue)

    # ------------------------------------------------------------------
    def gather(self, t):
        """``t``, a tensor with this rank's instances on its leading axis,
        with every rank's in rank order (``t`` itself without a mesh)."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def current_solution(self, state: PDHGState):
        """(x, z, y, w), each with a leading batch axis over every
        instance (with a mesh, every rank's, gathered)."""
        p = self.batched_problem.tree
        tau, sigma, theta = (v[:, None] for v in (state.tau, state.sigma,
                                                  state.theta))
        w = (state.x_prev - state.x) / (p.scaling_right * tau) - state.kty_prev
        z = (state.y_prev - state.y) / (sigma * p.scaling_left) + (
            1.0 + theta) * state.kx - theta * state.kx_prev
        return tuple(self.gather(v) for v in (state.x, z, state.y, w))
