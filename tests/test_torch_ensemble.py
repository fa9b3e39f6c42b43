"""Port parity for slices 7a and 7b: batched ensembles (BASELINE config 5,
``ensemble1024x128``) in prost_tpu_torch against prost_tpu.

* ``stack_problems``: its errors, which leaves it stacks, and per-instance
  Python-float coefficients (a prox's lmb) reaching each instance;
* the generic batched path (``pdhg_step`` under vmap) against the JAX
  generic batched run in f64 (ROF, deblur and tight ensembles, and one in
  which instances converge at different iterations) and against
  sequential single-instance runs;
* the ROF, ml and vol batched chunks' plain versions (what a CPU tensor
  runs) against the JAX batched kernels in Pallas interpret mode, f32:
  planes within 2e-5, norms 1e-4 relative (tests/test_torch_fused_*.py);
  ROF also against the JAX banded-batched kernel (row 7 of the kernel
  table); each instance of all five batched chunks against the
  single-instance chunk;
* ``BatchedPDHG``'s fused ROF, multilabel and volumetric routes against the
  JAX ``BatchedPDHG(interpret=True)`` (tests/test_parallel.py's setups and
  tolerances: x and y 2e-5, tau 1e-6 relative, ``current_solution``
  5e-5), warm starts with mass on the dead dual coordinates (the batched
  ROF run zeroes them once per run, the ml run does not), and the batched
  state hand-over of ``interop``;
* deblur and tight ensembles whose launch constants differ (blur kernels,
  pair matrices) take the generic path in both packages.

The deblur and tight batched chunks against the JAX kernels and their
routes against the JAX package's are in tests/test_torch_ensemble_conv.py.

The CUDA kernels are held against the plain versions, and each instance
against the single-instance kernel, on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.backend import BackendPDHG as JBackend
from prost_tpu.backend import PDHGOptions as JOptions
from prost_tpu.ops import fused_multilabel as jm
from prost_tpu.ops import fused_rof as jr
from prost_tpu.ops import fused_vol as jv
from prost_tpu.parallel import BatchedPDHG as JBatched
from prost_tpu_torch import interop
from prost_tpu_torch.backend import BackendPDHG as TBackend
from prost_tpu_torch.backend import PDHGOptions as TOptions
from prost_tpu_torch.ops import fused_deblur as td
from prost_tpu_torch.ops import fused_multilabel as tm
from prost_tpu_torch.ops import fused_rof as tr
from prost_tpu_torch.ops import fused_tight as tt
from prost_tpu_torch.ops import fused_vol as tv
from prost_tpu_torch.parallel import BatchedPDHG as TBatched
from prost_tpu_torch.parallel import stack_problems
from prost_tpu_torch.parallel.ensemble import ROUTE_NAMES
from test_torch_deblur import asym_kernel, deblur_model
from test_torch_tight import pair_matrix, tight_model
from test_torch_vol import bench_vol_problem

PLANE_ATOL, NORM_RTOL = 2e-5, 1e-4
RUN_ATOL, TAU_RTOL, SOL_ATOL = 2e-5, 1e-6, 5e-5
F64_ATOL = 1e-10  # f64 generic runs: the same operations in both packages


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    pt.set_dtype(jnp.float64)
    ptt.set_dtype(torch.float64)
    yield
    ptt.set_dtype(torch.float32)
    pt.set_dtype(jnp.float32)
    jax.config.update("jax_enable_x64", False)


def rof_problem(mod, nx, ny, f, lmb, fun="square"):
    """tests/test_parallel.py's ROF instance in package ``mod``."""
    n = nx * ny
    grad = mod.linop.BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
    prox_g = [mod.prox.ProxElem1D(index=0, size=n, fun=fun,
                                  coeffs=(1.0, f, lmb, 0.0, 0.0, 0.0, 0.0))]
    pn = mod.prox.ProxElemNorm2(index=0, size=2 * n, count=n, dim=2,
                                interleaved=False, fun="abs",
                                coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    return mod.Problem.create(
        mod.linop.LinearOperator.create([grad]), prox_g=prox_g,
        prox_fstar=[mod.prox.ProxMoreau(index=0, size=2 * n, child=pn)])


def ml_problem(mod, nx, ny, L, f_lin, lmb, d_s=1.0):
    """tests/test_parallel.py's fast-multilabel instance in ``mod``."""
    n = nx * ny
    u, q, s = mod.Variable(n * L), mod.Variable(2 * n * L), mod.Variable(n)
    prob = mod.MinMaxProblem([u], [q, s])
    prob.add_function(u, mod.function.sum_1d("ind_geq0", 1, 0, 1, f_lin, 0))
    prob.add_function(q, mod.function.sum_norm2(2 * L, False, "ind_leq0",
                                                1 / lmb, 1, 1))
    prob.add_function(s, mod.function.sum_1d("zero", 1, 0, 1, d_s, 0))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, mod.block.sparse_kron_id(np.ones((1, L)), n))
    return prob.finalize()


def _sopts(mod, t=0.0):
    return mod.SolverOptions(verbose=False, tol_rel_primal=t, tol_rel_dual=t,
                             tol_abs_primal=t, tol_abs_dual=t)


def _opts(mod, ri):
    cls = JOptions if mod is pt else TOptions
    return cls(stepsize="boyd", residual_iter=ri, scale_steps_operator=False)


def _batched(mod, problems, ri, t=0.0, fused=True):
    """``BatchedPDHG`` of ``mod``: the JAX one in interpret mode where
    ``fused`` (its fused routes on the CPU), the generic path otherwise;
    the port's takes its fused route on any device, and loses it by the
    JAX tests' idiom of setting the route to None."""
    if mod is pt:
        return JBatched(problems, _opts(pt, ri), _sopts(pt, t),
                        interpret=fused)
    b = TBatched(problems, _opts(ptt, ri), _sopts(ptt, t))
    if not fused:
        for name in ROUTE_NAMES:
            setattr(b, name, None)
    return b


def _run(b, until, state=None, start=0):
    if isinstance(b, JBatched):
        return b.run(b.initial_state() if state is None else state, until)
    return b.run(b.initial_state() if state is None else state, until, start)


def _assert_states(ts, js, atol, fields=("x", "y"), tau_rtol=TAU_RTOL):
    np.testing.assert_array_equal(ts.iteration.numpy(),
                                  np.asarray(js.iteration))
    np.testing.assert_array_equal(ts.converged.numpy(),
                                  np.asarray(js.converged))
    for name in fields:
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=atol,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(ts.tau.numpy(), np.asarray(js.tau),
                               rtol=tau_rtol)


# ---------------------------------------------------------------------------
# stack_problems
# ---------------------------------------------------------------------------

def _rof_fs(seed, B, n):
    rng = np.random.RandomState(seed)
    return [rng.rand(n).astype(np.float32) for _ in range(B)]


def test_stack_problems_rejects_empty_list():
    with pytest.raises(ptt.ProstError, match="empty list"):
        stack_problems([])


@pytest.mark.parametrize("case", ["shape", "fun", "coeff_kind"])
def test_stack_problems_rejects_other_structure(case):
    """A different plane shape (nx, ny swapped, the same sizes), prox kind,
    or a coefficient that is a tensor in one instance and a number in the
    other: the JAX treedef check's errors."""
    f = _rof_fs(0, 1, 48)[0]
    a = rof_problem(ptt, 6, 8, f, 4.0)
    b = {"shape": lambda: rof_problem(ptt, 8, 6, f, 4.0),
         "fun": lambda: rof_problem(ptt, 6, 8, f, 4.0, fun="abs"),
         "coeff_kind": lambda: rof_problem(ptt, 6, 8, 0.5, 4.0)}[case]()
    with pytest.raises(ptt.ProstError, match="different static structure"):
        stack_problems([a, b])


def test_stack_problems_stacks_what_differs():
    """f and the Python-float lmb differ and gain a batch axis, lmb as a
    (B,) tensor; the preconditioners and the other coefficients are equal
    in every instance and stay shared."""
    nx, ny, lmbs = 6, 5, (4.0, 8.0, 16.0)
    fs = _rof_fs(1, 3, nx * ny)
    st = stack_problems([rof_problem(ptt, nx, ny, f, lm)
                         for f, lm in zip(fs, lmbs)])
    assert st.paths == (("prox_g", 0, "coeffs", 1),
                        ("prox_g", 0, "coeffs", 2))
    f_st, lmb_st = st.leaves()
    np.testing.assert_array_equal(f_st.numpy(), np.stack(fs))
    assert lmb_st.tolist() == list(lmbs) and lmb_st.dtype == torch.float32
    assert st.tree.scaling_left.shape == (2 * nx * ny,)
    assert st.tree.prox_fstar[0].child.coeffs[2] == 1.0
    f1, lmb1 = f_st[1], lmb_st[1]
    one = st.instance([f1, lmb1])
    assert one.prox_g[0].coeffs[1] is f1 and one.prox_g[0].coeffs[2] is lmb1


def test_per_instance_lmb_reaches_each_instance():
    """Three instances with one f and Python-float lmb 4, 8, 16: the
    generic batched run equals the three single-instance runs bit for bit,
    and the three results differ (instance 0's lmb serving every instance
    would make them equal)."""
    nx, ny, lmbs = 12, 10, (4.0, 8.0, 16.0)
    f = _rof_fs(2, 1, nx * ny)[0]
    probs = [rof_problem(ptt, nx, ny, f, lm) for lm in lmbs]
    b = _batched(ptt, probs, 10, fused=False)
    s = _run(b, 40)
    for i, p in enumerate(probs):
        one = TBackend(p, _opts(ptt, 10), _sopts(ptt))
        ref = one.run(one.initial_state(), 40, 0)
        assert torch.equal(s.x[i], ref.x) and torch.equal(s.y[i], ref.y)
        assert torch.equal(s.tau[i], ref.tau)
    assert not torch.allclose(s.x[0], s.x[2], atol=1e-3)


# ---------------------------------------------------------------------------
# the generic batched path
# ---------------------------------------------------------------------------

def test_generic_matches_sequential():
    """tests/test_parallel.py::test_batched_matches_sequential: four
    instances, 300 iterations at tolerance 1e-6, against single-instance
    BackendPDHG runs of the port (bit-equal) and of the JAX package."""
    nx = ny = 12
    fs = _rof_fs(0, 4, nx * ny)
    probs = [rof_problem(ptt, nx, ny, f, 5.0) for f in fs]
    b = TBatched(probs, solver_opts=_sopts(ptt, 1e-6))
    b.rof = None
    s = b.run(b.initial_state(), 300, 0)
    xb = b.current_solution(s)[0]
    for i, f in enumerate(fs):
        one = TBackend(probs[i], TOptions(scale_steps_operator=False),
                       _sopts(ptt, 1e-6))
        ref = one.run(one.initial_state(), 300, 0)
        assert torch.equal(xb[i], ref.x)
        jb = JBackend(rof_problem(pt, nx, ny, f, 5.0),
                      JOptions(scale_steps_operator=False), _sopts(pt, 1e-6))
        js = jb.run(jb.initial_state(), 300)
        np.testing.assert_allclose(xb[i].numpy(), np.asarray(js.x),
                                   atol=1e-5)


def _deblur_probs(mod):
    return [deblur_model(mod, 10, 9, asym_kernel(), lmb=lm,
                         seed=i)[0].finalize()
            for i, lm in enumerate((20.0, 35.0, 50.0))]


def _tight_probs(mod):
    return [tight_model(mod, 7, 6, L=3, lmb=lm, seed=i)[0].finalize()
            for i, lm in enumerate((0.6, 1.0, 1.4))]


def _rof_probs(mod, nx=16, ny=16, seed=7, lmbs=(4.0, 8.0, 16.0)):
    rng = np.random.RandomState(seed)
    return [rof_problem(mod, nx, ny, rng.rand(nx * ny), lm) for lm in lmbs]


@pytest.mark.parametrize("case,ri,until", [("rof", 10, 60),
                                           ("deblur", 5, 31),
                                           ("tight", 5, 31)])
def test_generic_matches_jax_generic_f64(x64, case, ri, until):
    """The generic batched path against the JAX generic batched run in f64
    (no fused route takes f64): three ROF instances of 16x16 (lmb 4, 8,
    16), and the deblur and tight ensembles; iterates, tau and the residual
    norms."""
    build = {"rof": _rof_probs, "deblur": _deblur_probs,
             "tight": _tight_probs}[case]
    ts = _run(_batched(ptt, build(ptt), ri, fused=False), until)
    js = _run(_batched(pt, build(pt), ri, fused=False), until)
    _assert_states(ts, js, F64_ATOL,
                   ("x", "y", "x_prev", "y_prev", "kx", "kty"),
                   tau_rtol=1e-12)
    np.testing.assert_allclose(ts.primal_residual.numpy(),
                               np.asarray(js.primal_residual), rtol=1e-8)


def test_early_convergence_matches_jax_f64(x64):
    """Instances that converge at different iterations (tolerance 1e-4,
    lmb 2 to 32): converged instances go on iterating until every one has
    converged, at the same residual iteration as in the JAX package, with
    the same iteration counts, iterates, steps and flags."""
    probs = {mod: _rof_probs(mod, 10, 12, 11, (2.0, 8.0, 32.0))
             for mod in (pt, ptt)}
    ts = _run(_batched(ptt, probs[ptt], 1, 1e-4, fused=False), 400)
    js = _run(_batched(pt, probs[pt], 1, 1e-4, fused=False), 400)
    assert bool(ts.converged.all()) and int(ts.iteration[0]) < 400
    _assert_states(ts, js, F64_ATOL, tau_rtol=1e-12)
    # a single run of each instance converges at its own iteration, some
    # before the ensemble stops
    stops = []
    for p in probs[ptt]:
        one = TBackend(p, _opts(ptt, 1), _sopts(ptt, 1e-4))
        s = one.initial_state()
        for it in range(400):
            s = one.generic_step(s, it)
            if bool(s.converged):
                stops.append(it + 1)
                break
    assert len(stops) == 3 and min(stops) < int(ts.iteration[0])


# ---------------------------------------------------------------------------
# the batched chunks' plain versions against the JAX batched kernels
# ---------------------------------------------------------------------------

def _close(t_out, j_out, n_planes):
    for i, (a, b) in enumerate(zip(t_out[:n_planes], j_out[:n_planes])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PLANE_ATOL,
                                   rtol=0, err_msg=f"plane {i}")
    ref = np.asarray(j_out[n_planes])
    assert t_out[n_planes].shape == ref.shape
    np.testing.assert_allclose(t_out[n_planes].numpy(), ref, rtol=NORM_RTOL)


def _scal(rng, B, third):
    """(5, B) rows: tau, sigma, theta, and the family's two scalars."""
    return np.stack([0.8 + 0.2 * rng.rand(B), 0.9 + 0.3 * rng.rand(B),
                     np.ones(B), *third(rng, B)]).astype(np.float32)


def _rof_inputs(seed, B, nx, ny, clean=False):
    rng = np.random.RandomState(seed)
    q = 0.3 * rng.randn(B, 2, nx, ny)
    if clean:  # the banded JAX kernels take a canonical q
        q[:, 0, -1, :] = 0.0
        q[:, 1, :, -1] = 0.0
    arrs = [rng.rand(B, nx, ny), q, rng.rand(B, nx, ny),
            2.0 * (rng.rand(B, nx, ny) > 0.3)]
    arrs = [a.astype(np.float32) for a in arrs]
    return arrs + [_scal(rng, B, lambda r, b: (4 + 12 * r.rand(b),
                                              0.5 + r.rand(b)))]


@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
def test_rof_chunk_batched_matches_jax_kernel(dataterm):
    """Row 4: rof_fused_chunk_batched on three ragged 16x20 instances with
    their own steps, lmb and radius, and mass on the dead coordinates."""
    args = _rof_inputs(3, 3, 16, 20)
    j = jr.rof_fused_chunk_batched(*map(jnp.asarray, args), 10,
                                   dataterm=dataterm, interpret=True)
    t = tr.rof_chunk_batched(*map(torch.from_numpy, args), 10, dataterm)
    _close(t, j, 4)


def test_rof_chunk_batched_matches_jax_banded():
    """Row 7: rof_fused_chunk_banded_batched (2 bands of 16 rows, the JAX
    route for instances beyond a TPU core's VMEM) against the port's one
    batched chunk, which serves every instance size."""
    args = _rof_inputs(4, 3, 32, 16, clean=True)
    j = jr.rof_fused_chunk_banded_batched(*map(jnp.asarray, args), 5, 2,
                                          interpret=True)
    t = tr.rof_chunk_batched(*map(torch.from_numpy, args), 5)
    _close(t, j, 4)


def test_ml_chunk_batched_matches_jax_kernel():
    """Row 15: ml_fused_chunk_batched at (B, L, nx, ny) = (3, 4, 12, 10)."""
    B, L, nx, ny = 3, 4, 12, 10
    rng = np.random.RandomState(5)
    arrs = [rng.rand(B, L, nx, ny), 0.3 * rng.randn(B, 2 * L, nx, ny),
            0.1 * rng.randn(B, nx, ny), rng.rand(B, L, nx, ny)]
    args = [a.astype(np.float32) for a in arrs] + [
        _scal(rng, B, lambda r, b: (0.5 + r.rand(b), r.rand(b)))]
    j = jm.ml_fused_chunk_batched(*map(jnp.asarray, args), 10,
                                  interpret=True)
    t = tm.ml_chunk_batched(*map(torch.from_numpy, args), 10)
    _close(t, j, 6)


@pytest.mark.parametrize("L,dataterm", [(3, "square"), (3, "abs"),
                                        (1, "wsquare")])
def test_vol_chunk_batched_matches_jax_kernel(L, dataterm):
    """Row 25: vol_fused_chunk_batched at (3, L, 10, 12), L = 3 and a
    single label plane."""
    B, nx, ny = 3, 10, 12
    rng = np.random.RandomState(6 + L)
    arrs = [rng.rand(B, L, nx, ny), 0.3 * rng.randn(B, 3, L, nx, ny),
            rng.rand(B, L, nx, ny), 2.0 * (rng.rand(B, L, nx, ny) > 0.3)]
    args = [a.astype(np.float32) for a in arrs] + [
        _scal(rng, B, lambda r, b: (4 + 4 * r.rand(b), 0.5 + r.rand(b)))]
    j = jv.vol_fused_chunk_batched(*map(jnp.asarray, args), 7,
                                   dataterm=dataterm, interpret=True)
    t = tv.vol_chunk_batched(*map(torch.from_numpy, args), 7, dataterm)
    _close(t, j, 4)


@pytest.mark.parametrize("family", ["rof", "ml", "vol", "deblur", "tight"])
def test_batched_chunk_is_each_instance_alone(family):
    """Instance b of a batched chunk is the single-instance chunk on
    instance b; an instance whose converged flag is set gets its inputs
    back and zero norms.  Deblur at the asymmetric 5x5 blur (nx2 - nx and
    ny2 - ny both 4 on a 9x11 image), tight with L = 3 against k = 3 pairs
    on 9x11, each family's planes at their own per-instance sizes."""
    rng = np.random.RandomState(8)
    B, L, nx, ny = 3, 2, 9, 11
    conv = np.array([[0.0, 1.0, 0.0]], np.float32)
    extra = ()
    if family == "rof":
        *planes, scal = _rof_inputs(9, B, nx, ny)
        one, many, n_planes = tr.rof_chunk, tr.rof_chunk_batched, 4
        state = (0, 1)
    elif family == "ml":
        planes = [rng.rand(B, L, nx, ny), 0.3 * rng.randn(B, 2 * L, nx, ny),
                  0.1 * rng.randn(B, nx, ny), rng.rand(B, L, nx, ny)]
        scal = _scal(rng, B, lambda r, b: (0.5 + r.rand(b), r.rand(b)))
        one, many, n_planes = tm.ml_chunk, tm.ml_chunk_batched, 6
        state = (0, 1, 2)
    elif family == "vol":
        planes = [rng.rand(B, L, nx, ny), 0.3 * rng.randn(B, 3, L, nx, ny),
                  rng.rand(B, L, nx, ny), rng.rand(B, L, nx, ny)]
        scal = _scal(rng, B, lambda r, b: (6 + r.rand(b), 1.0 + 0 * r.rand(b)))
        one, many, n_planes = tv.vol_chunk, tv.vol_chunk_batched, 4
        state = (0, 1)
    elif family == "deblur":
        kernel = asym_kernel()
        nx2, ny2 = nx + 4, ny + 4
        planes = [rng.rand(B, nx, ny), rng.randn(B, nx2, ny2),
                  0.3 * rng.randn(B, 2, nx, ny), rng.rand(B, nx2, ny2),
                  0.5 + rng.rand(B, nx2, ny2)]
        scal = _scal(rng, B, lambda r, b: (20 + 20 * r.rand(b),
                                           0.5 + r.rand(b)))
        extra = (td.kernel_taps(torch.as_tensor(kernel.T,
                                                dtype=torch.float32)),
                 0.5, 0.2)
        one, many, n_planes = td.deblur_chunk, td.deblur_chunk_batched, 6
        state = (0, 1, 2)
    else:
        Lt, k = 3, 3
        m = tt.match_tight_structure(tight_model(ptt, nx, ny, Lt)[0]
                                     .finalize())
        planes = [rng.rand(B, Lt, nx, ny), 0.1 * rng.randn(B, 2 * k, nx, ny),
                  0.2 * rng.randn(B, 2 * Lt, nx, ny),
                  0.1 * rng.randn(B, 2 * k, nx, ny),
                  0.1 * rng.randn(B, nx, ny),
                  rng.rand(B, Lt, nx, ny)]
        scal = _scal(rng, B, lambda r, b: (0.5 + r.rand(b), r.rand(b)))
        extra = (m["taps"], m["consts"])
        one, many, n_planes = tt.tight_chunk, tt.tight_chunk_batched, 10
        state = (0, 1, 2, 3, 4)
    planes = [torch.from_numpy(np.asarray(a, np.float32)) for a in planes]
    scal = torch.from_numpy(np.concatenate([scal, conv]))
    out = many(*planes, scal, 4, *extra)
    assert out[n_planes].shape == (4, B)
    for b in range(B):
        ref = one(*[p[b] for p in planes], scal[:, b], 4, *extra)
        for a, r in zip(out[:n_planes], ref[:n_planes]):
            torch.testing.assert_close(a[b], r, atol=1e-6, rtol=0)
        torch.testing.assert_close(out[n_planes][:, b], ref[n_planes],
                                   rtol=1e-5, atol=0)
    for i, k in enumerate(state):  # instance 1 is held
        assert torch.equal(out[i][1], planes[k][1])
        assert torch.equal(out[n_planes // 2 + i][1], planes[k][1])
    assert float(out[n_planes][:, 1].abs().sum()) == 0.0


def test_batched_wrappers_reject_bad_input():
    x, q, f, w, scal = map(torch.from_numpy, _rof_inputs(1, 2, 6, 5))
    with pytest.raises(ptt.ProstError, match="scal must be"):
        tr.rof_chunk_batched(x, q, f, w, scal[:, :1], 3)
    with pytest.raises(ptt.ProstError, match="q must be"):
        tr.rof_chunk_batched(x, q[:1], f, w, scal, 3)
    with pytest.raises(ptt.ProstError, match="x must be"):
        tr.rof_chunk_batched(x[0], q, f, w, scal, 3)
    u = torch.zeros(2, 1, 6, 5)
    with pytest.raises(ptt.ProstError, match="q must be"):
        tv.vol_chunk_batched(u, torch.zeros(2, 2, 1, 6, 5), u, u, scal, 3)
    with pytest.raises(ptt.ProstError, match="s must be"):
        tm.ml_chunk_batched(u, torch.zeros(2, 2, 6, 5), torch.zeros(6, 5),
                            u, scal, 3)
    big = 65536  # one past the grid's z limit
    z = torch.zeros(big, 2, 2)
    with pytest.raises(ptt.ProstError, match="1 to 65535 instances"):
        tr.rof_chunk_batched(z, torch.zeros(big, 2, 2, 2), z, z,
                             torch.zeros(5, big), 1)


# ---------------------------------------------------------------------------
# BatchedPDHG's fused routes against the JAX package's
# ---------------------------------------------------------------------------

def _ml_probs(mod):
    rng = np.random.RandomState(9)
    nx = ny = 16
    L = 3
    return [ml_problem(mod, nx, ny, L, rng.rand(nx * ny * L).astype(
        np.float32), lm) for lm in (0.3, 0.5, 0.8)]


def _vol_probs(mod):
    rng = np.random.RandomState(3)
    L, nx, ny = 3, 12, 12
    return [bench_vol_problem(mod, L, nx, ny,
                              rng.rand(L * nx * ny).astype(np.float32), lm)
            for lm in (4.0, 8.0, 16.0)]


# tests/test_parallel.py's fused ensembles: (problems, residual_iter,
# iterations); the JAX runs compile once per family in this file
FUSED = {"rof": (_rof_probs, 10, 60), "ml": (_ml_probs, 5, 41),
         "vol": (_vol_probs, 5, 31)}


@pytest.mark.parametrize("family", ["rof", "ml", "vol"])
def test_fused_route_matches_jax_fused(family):
    """The port's fused batched route (the plain versions on the CPU)
    against the JAX BatchedPDHG in interpret mode: the route each takes,
    iterates, steps and current_solution."""
    build, ri, until = FUSED[family]
    tb, jb = _batched(ptt, build(ptt), ri), _batched(pt, build(pt), ri)
    for name in ROUTE_NAMES:
        assert (getattr(tb, name) is not None) == (name == family)
        assert (getattr(jb, name) is not None) == (name == family)
    ts, js = _run(tb, until), _run(jb, until)
    np.testing.assert_array_equal(ts.iteration.numpy(), until)
    _assert_states(ts, js, RUN_ATOL)
    for a, b in zip(tb.current_solution(ts), jb.current_solution(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=SOL_ATOL)


def _mismatched_deblur(mod):
    """Two 10x9 frames blurred by different 5x5 kernels (the asymmetric
    blur and its mirror image): the taps, a launch constant of the batched
    kernel, differ."""
    ker = asym_kernel()
    return [deblur_model(mod, 10, 9, k, seed=i)[0].finalize()
            for i, k in enumerate((ker, ker[:, ::-1].copy()))]


def _mismatched_tight(mod):
    """Two 7x6 instances with 3 labels whose pair matrices differ (the
    example's, and one with its first pair weighted twice): the taps and
    the preconditioner constants differ."""
    nx, ny, L = 7, 6, 3
    n, k = nx * ny, L * (L - 1) // 2
    probs = []
    for seed, w in enumerate((1.0, 2.0)):
        P = pair_matrix(L)
        P[[0, k]] *= w
        f = np.random.RandomState(seed).rand(n * L)
        u, v = mod.Variable(n * L), mod.Variable(2 * n * k)
        q, p, s = (mod.Variable(2 * n * L), mod.Variable(2 * n * k),
                   mod.Variable(n))
        prob = mod.MinMaxProblem([u, v], [q, p, s])
        prob.add_function(u, mod.function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
        prob.add_function(p, mod.function.sum_norm2(2, False, "ind_leq0", 1,
                                                    1, 1))
        prob.add_function(s, mod.function.sum_1d("zero", 1, 0, 1, 1, 0))
        prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, L))
        prob.add_dual_pair(u, s, mod.block.sparse_kron_id(np.ones((1, L)),
                                                          n))
        prob.add_dual_pair(v, p, mod.block.identity())
        prob.add_dual_pair(v, q, mod.block.sparse_kron_id(P.T, n))
        probs.append(prob.finalize())
    return probs


def test_deblur_and_tight_take_the_generic_path():
    """Ensembles whose instances each match a fused route but not with the
    same launch constants (deblur frames with different blurs, tight
    instances with different pair matrices) take the generic batched path
    in both packages, and run it alike; instances with different label
    counts do not even stack (the structure differs)."""
    for build in (_mismatched_deblur, _mismatched_tight):
        tb, jb = _batched(ptt, build(ptt), 5), _batched(pt, build(pt), 5)
        for b in (tb, jb):
            assert all(getattr(b, name) is None for name in ROUTE_NAMES)
        ts, js = _run(tb, 7), _run(jb, 7)
        _assert_states(ts, js, RUN_ATOL)
    with pytest.raises(ptt.ProstError, match="different static"):
        stack_problems([tight_model(ptt, 7, 6, L=L)[0].finalize()
                        for L in (2, 3)])


@pytest.mark.parametrize("family,until", [("rof", 9), ("rof", 31),
                                          ("ml", 4), ("ml", 21)])
def test_dead_dual_warm_start_matches_jax(family, until):
    """A warm start with mass on the dead dual coordinates (q_x's last row,
    q_y's last column): the batched ROF run zeroes them once per run, the
    batched ml run does not (its kernel zeroes them at each chunk's
    entry), both as in the JAX package; a run too short for a chunk shows
    the difference."""
    build, ri, _ = FUSED[family]
    tb, jb = _batched(ptt, build(ptt), ri), _batched(pt, build(pt), ri)
    ts0, js0 = tb.initial_state(), jb.initial_state()
    B, m = ts0.y.shape
    L = 1 if family == "rof" else 3
    nx = ny = 16
    y0 = 0.1 * np.random.RandomState(17).randn(B, m).astype(np.float32)
    q = y0[:, :2 * L * nx * ny].reshape(B, 2, L, nx, ny)
    q[:, 0, :, -1, :] = 0.5
    q[:, 1, :, :, -1] = -0.5
    ts0.y = torch.from_numpy(y0)
    ts = _run(tb, until, ts0)
    js = _run(jb, until, type(js0)(**{**vars(js0), "y": jnp.asarray(y0)}))
    _assert_states(ts, js, RUN_ATOL)
    tq = ts.y.numpy()[:, :2 * L * nx * ny].reshape(B, 2, L, nx, ny)
    dead = np.concatenate([tq[:, 0, :, -1, :].ravel(),
                           tq[:, 1, :, :, -1].ravel()])
    assert np.all(dead == 0.0) == (family == "rof" or until > ri)


def test_batched_state_hand_over():
    """The JAX batched ROF state after 30 iterations into the port through
    interop (vectors (B, n), scalars (B,)); both packages then go on to
    60 and agree; the port's state round-trips through numpy."""
    build, ri, _ = FUSED["rof"]
    jb, tb = _batched(pt, build(pt), ri), _batched(ptt, build(ptt), ri)
    js30 = _run(jb, 30)
    fields = {k: np.asarray(v) for k, v in vars(js30).items()}
    ts30 = interop.pdhg_state_from_numpy(fields, "cpu")
    assert ts30.x.shape == fields["x"].shape and ts30.tau.shape == (3,)
    assert ts30.iteration.tolist() == [30] * 3
    back = interop.pdhg_state_to_numpy(ts30)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v.astype(back[k].dtype))
    ts, js = tb.run(ts30, 60, 30), jb.run(js30, 60)
    _assert_states(ts, js, RUN_ATOL)


def test_mesh_is_refused():
    """A mesh that does not split the batch evenly is refused, with the JAX
    package's message (tests/test_parallel.py:196); an even split runs on
    the mesh's ranks (tests/test_torch_spatial_admm.py)."""

    class TwoRanks:
        def size(self):
            return 2

    with pytest.raises(ptt.ProstError,
                       match="batch size 3 must be divisible by the mesh's "
                             "2 devices"):
        TBatched(_rof_probs(ptt), mesh=TwoRanks())
