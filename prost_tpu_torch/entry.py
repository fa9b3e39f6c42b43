"""Entry points for compile and launch checks (counterpart of the JAX
package's ``__graft_entry__.py``).

``entry()``            -> (fn, example_args): one PDHG iteration on the
                          flagship workload (ROF denoising at 128x128, the
                          reference's example_rof_primaldual.m), on
                          ``config.device()``.
``dryrun_multichip(n)`` -> n ranks of one process group (NCCL, one card
                          each; gloo with ``device="cpu"``) each run the
                          parallel layer's routes a few iterations on tiny
                          shapes: batched ensembles over a ``dp`` mesh and
                          spatial sharding of the pixel rows over ``sp``.
"""

from __future__ import annotations

import numpy as np


def _build_rof(nx, ny, lmb=16.0, seed=0):
    """A generic PDHG backend on the ROF model with the seed's random
    image, on ``config.device()``."""
    import prost_tpu_torch as ptt
    from prost_tpu_torch.backend import BackendPDHG, PDHGOptions
    from prost_tpu_torch.linop import BlockGradient2D, LinearOperator
    from prost_tpu_torch.prox import ProxElem1D, ProxElemNorm2, ProxMoreau

    n = nx * ny
    rng = np.random.RandomState(seed)
    f = rng.rand(n).astype(np.float32)

    grad = BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
    linop = LinearOperator.create([grad])
    prox_g = [
        ProxElem1D(index=0, size=n, fun="square",
                   coeffs=(1.0, f, lmb, 0.0, 0.0, 0.0, 0.0))
    ]
    pn = ProxElemNorm2(index=0, size=2 * n, count=n, dim=2, interleaved=False,
                       fun="abs", coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    prox_fstar = [ProxMoreau(index=0, size=2 * n, child=pn)]
    prob = ptt.Problem.create(linop, prox_g=prox_g, prox_fstar=prox_fstar)

    opts = ptt.SolverOptions(verbose=False)
    return BackendPDHG(prob, PDHGOptions(scale_steps_operator=False), opts)


def _build_vol(L, nx, ny, lmb=6.0, seed=0):
    """A generic PDHG backend on the volumetric TV model (gradient3d)."""
    import prost_tpu_torch as ptt
    from prost_tpu_torch.backend import BackendPDHG, PDHGOptions
    from prost_tpu_torch.linop import BlockGradient3D, LinearOperator
    from prost_tpu_torch.prox import ProxElem1D, ProxElemNorm2, ProxMoreau

    n = L * nx * ny
    rng = np.random.RandomState(seed)
    f = rng.rand(n).astype(np.float32)
    grad = BlockGradient3D(row=0, col=0, nx=nx, ny=ny, L=L)
    prox_g = [ProxElem1D(index=0, size=n, fun="square",
                         coeffs=(1.0, f, lmb, 0.0, 0.0, 0.0, 0.0))]
    pn = ProxElemNorm2(index=0, size=3 * n, count=n, dim=3,
                       interleaved=False, fun="abs",
                       coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    prob = ptt.Problem.create(
        LinearOperator.create([grad]), prox_g=prox_g,
        prox_fstar=[ProxMoreau(index=0, size=3 * n, child=pn)])
    opts = ptt.SolverOptions(verbose=False)
    return BackendPDHG(prob, PDHGOptions(scale_steps_operator=False), opts)


def _tight_problem(nx, ny, L=3, lmb=1.0, seed=0):
    """The tight multilabel relaxation (example_multilabel_tight's model)
    on the seed's random unaries, finalized."""
    import prost_tpu_torch as ptt
    from prost_tpu_torch.examples.example_multilabel_tight import (
        pair_local_matrix)
    from prost_tpu_torch.modeling import block, function

    n = nx * ny
    k = L * (L - 1) // 2
    f = np.random.RandomState(seed).rand(n * L)
    u, v = ptt.Variable(n * L), ptt.Variable(2 * n * k)
    q, p, s = ptt.Variable(2 * n * L), ptt.Variable(2 * n * k), ptt.Variable(n)
    prob = ptt.MinMaxProblem([u, v], [q, p, s])
    prob.add_function(u, function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(p, function.sum_norm2(2, False, "ind_leq0", 1 / lmb, 1,
                                            1))
    prob.add_function(s, function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, block.sparse_kron_id(np.ones((1, L)), n))
    prob.add_dual_pair(v, p, block.identity())
    prob.add_dual_pair(v, q, block.sparse_kron_id(pair_local_matrix(L).T, n))
    return prob.finalize()


def entry():
    """One PDHG iteration on ROF 128x128: (fn, (state,)) with ``fn(state)``
    the generic step (``pdhg_step``; residual_iter is 1, so every
    iteration is a residual iteration)."""
    from prost_tpu_torch.backend.pdhg import pdhg_step

    backend = _build_rof(128, 128)
    state = backend.initial_state()
    problem, prox_g, prox_fstar, opts = (
        backend.problem, backend.prox_g, backend.prox_fstar, backend.opts,
    )
    tols = (1e-6, 1e-6, 1e-6, 1e-6)

    def fn(state):
        return pdhg_step(problem, prox_g, prox_fstar, opts, tols, state, True)

    return fn, (state,)


def _finite(state) -> bool:
    import torch

    from prost_tpu_torch.parallel.spatial import whole

    return all(bool(torch.isfinite(whole(v)).all())
               for v in vars(state).values() if v.is_floating_point())


def _dryrun_rank() -> dict:
    """One rank's share of ``dryrun_multichip``: each route a few
    iterations; {step: iterations reached}."""
    import torch.distributed as dist

    from prost_tpu_torch.backend import ADMMOptions, PDHGOptions
    from prost_tpu_torch.ops.fused_admm import FusedROFADMM
    from prost_tpu_torch.parallel import (BatchedPDHG, ShardedFusedADMM,
                                          ShardedFusedROF, ShardedFusedVol,
                                          ShardedPDHG, make_mesh)
    from prost_tpu_torch.solver import SolverOptions

    n = dist.get_world_size()
    sopts = SolverOptions(verbose=False)
    popts = PDHGOptions(scale_steps_operator=False)
    popts_b = PDHGOptions(scale_steps_operator=False, residual_iter=2)
    dp_mesh = make_mesh((n,), axis_names=("dp",))
    sp_mesh = make_mesh((n,), axis_names=("sp",))
    mesh = make_mesh((2, n // 2) if n >= 4 else (n, 1),
                     axis_names=("dp", "sp"))
    reached = {}

    def done(name, state, until):
        it = state.iteration
        it = int(it.reshape(-1)[0]) if it.dim() else int(it)
        if it != until or not _finite(state):
            raise RuntimeError(f"dryrun {name}: iteration {it} of {until}, "
                               f"finite {_finite(state)}")
        reached[name] = it

    # dp: batched ensemble, the batch axis split over 'dp'; two generic
    # steps, then the fused batched ROF route
    problems = [_build_rof(16, 16, seed=s).problem for s in range(2 * n)]
    batched = BatchedPDHG(problems, popts, sopts, mesh=dp_mesh)
    state = batched.initial_state()
    for it in range(2):
        state = batched.generic_step(state, it)
    done("dp generic", state, 2)
    batched_f = BatchedPDHG(problems, popts_b, sopts, mesh=dp_mesh)
    if batched_f.rof is None:
        raise RuntimeError("dryrun: the fused ensemble route did not match")
    done("dp fused rof", batched_f.run(batched_f.initial_state(), 5, 0), 5)

    # sp: one problem, its pixel axis sharded over 'sp' (DTensor)
    backend = _build_rof(16, 16)
    sharded = ShardedPDHG(backend.problem, popts, sopts, mesh, "sp")
    done("sp generic", sharded.run(sharded.initial_state(), 2, 0), 2)

    # sp, hand-scheduled: the halo chunks with an explicit halo exchange
    backend = _build_rof(8 * n, 16)
    halo = ShardedFusedROF(backend.problem, popts_b, sopts, sp_mesh, "sp")
    done("sp halo rof", halo.run(halo.initial_state(), 5, 0), 5)

    # Chebyshev ADMM, fused, on one rank's device
    a_backend = _build_rof(64, 16)
    admm = FusedROFADMM(a_backend.problem,
                        ADMMOptions(residual_iter=2, projection="cheby",
                                    cheby_degree=4), sopts)
    if admm.rof is None:
        raise RuntimeError("dryrun: the fused ADMM route did not match")
    done("fused admm", admm.run(admm.initial_state(), 4, 0), 4)

    # sp, sharded ADMM: a halo exchange every iteration
    sa_backend = _build_rof(16 * n, 16)
    sadmm = ShardedFusedADMM(
        sa_backend.problem,
        ADMMOptions(residual_iter=2, projection="cheby", cheby_degree=2),
        sopts, sp_mesh, "sp")
    done("sp halo admm", sadmm.run(sadmm.initial_state(), 4, 0), 4)

    # sp, sharded volumetric TV: the nx-axis halo around the vol chunks
    v_backend = _build_vol(3, 8 * n, 16)
    svol = ShardedFusedVol(v_backend.problem, popts_b, sopts, sp_mesh, "sp")
    done("sp halo vol", svol.run(svol.initial_state(), 5, 0), 5)

    # dp, batched fused tight and vol
    t_problems = [_tight_problem(8, 16, L=3, lmb=1.0, seed=s)
                  for s in range(n)]
    batched_t = BatchedPDHG(t_problems, popts_b, sopts, mesh=dp_mesh)
    if batched_t.tight is None:
        raise RuntimeError("dryrun: the batched tight route did not match")
    done("dp fused tight", batched_t.run(batched_t.initial_state(), 5, 0), 5)
    v_problems = [_build_vol(3, 8, 16, seed=s).problem for s in range(n)]
    batched_v = BatchedPDHG(v_problems, popts_b, sopts, mesh=dp_mesh)
    if batched_v.vol is None:
        raise RuntimeError("dryrun: the batched vol route did not match")
    done("dp fused vol", batched_v.run(batched_v.initial_state(), 5, 0), 5)
    return reached


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Run the parallel layer on ``n_devices`` ranks at tiny shapes, both
    parallelism modes the package ships: 'dp', the batched instance axis
    (``parallel/ensemble.py``), and 'sp', the pixel rows of one problem
    (``parallel/spatial.py``, ``parallel/spatial_fused.py``).  The ranks
    are spawned processes of one group: NCCL with one card each (raises
    when there are fewer than ``n_devices`` cards), or gloo on the CPU
    with ``device="cpu"``.  Returns each rank's {step: iterations}.

    The JAX dryrun's banded steps are left out, because the port has no
    banding: each shard's chunk runs on the whole band (no ``band_nb``
    within a shard), the batched instances are not cut into bands, and
    the fused ADMM route has no banded mode."""
    from prost_tpu_torch.parallel.launch import run_ranks

    return run_ranks(n_devices, _dryrun_rank, device=device)
