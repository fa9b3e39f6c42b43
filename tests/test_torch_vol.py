"""Port parity for slice 6: volumetric TV (examples/example_vol_tv.py,
``BlockGradient3D``) in prost_tpu_torch against prost_tpu.

* ``BlockGradient3D`` in both layouts against the JAX block in f64: apply,
  adjoint, the preconditioner sums, adjointness; L = 1 included;
* the volumetric chunk's and multichunk's plain versions (what a CPU
  tensor runs) against the JAX kernels in Pallas interpret mode, whole
  volume (rows 23 and 26 of the kernel table) and banded (rows 27 and 28,
  closed by the port's two kernels), f32: planes within 2e-5, norms 1e-4
  relative with a floor of 1e-4 of the largest norm (norms of differences
  of nearby iterates);
* the matcher, the problem arrays, the route in FusedROFPDHG, a warm start
  with mass on the boundary duals, and the example's model through
  ``ptt.solve`` against the JAX fused route and a generic f64 solve.

The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.backend import PDHGOptions as JOptions
from prost_tpu.ops import FusedROFPDHG as JFused
from prost_tpu.ops import fused_vol as jv
from prost_tpu_torch import interop
from prost_tpu_torch.backend import PDHGOptions as TOptions
from prost_tpu_torch.ops import FusedROFPDHG as TFused
from prost_tpu_torch.ops import fused_vol as tv

PLANE_ATOL, NORM_RTOL = 2e-5, 1e-4
RUN_ATOL = 3e-5  # whole runs (the JAX package's fused-route tests' bar)
ENERGY_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


@pytest.fixture
def x64():
    import jax

    jax.config.update("jax_enable_x64", True)
    pt.set_dtype(jnp.float64)
    ptt.set_dtype(torch.float64)
    yield
    ptt.set_dtype(torch.float32)
    pt.set_dtype(jnp.float32)
    jax.config.update("jax_enable_x64", False)


def vol_model(mod, nx, ny, L, f, lmb, label_first=False, grad3=True,
              scaling="alpha"):
    """examples/example_vol_tv.py's model in package ``mod``; returns
    (problem, u)."""
    n = L * nx * ny
    u = mod.Variable(n)
    q = mod.Variable((3 if grad3 else 2) * n)
    prob = mod.MinMaxProblem([u], [q], scaling=scaling)
    prob.add_function(u, mod.function.sum_1d("square", 1, f, lmb))
    prob.add_function(q, mod.function.conjugate(
        mod.function.sum_norm2(3 if grad3 else 2, False, "abs")))
    blk = (mod.block.gradient3d(nx, ny, L, label_first) if grad3
           else mod.block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, q, blk)
    return prob, u


def bench_vol_problem(mod, L, nx, ny, f, lmb, a=1.0, dataterm="square"):
    """The ``Problem.create`` form of bench.py build_vol in package
    ``mod``."""
    n = L * nx * ny
    grad = mod.linop.BlockGradient3D(row=0, col=0, nx=nx, ny=ny, L=L)
    prox_g = [mod.prox.ProxElem1D(index=0, size=n, fun=dataterm,
                                  coeffs=(a, f, lmb, 0.0, 0.0, 0.0, 0.0))]
    pn = mod.prox.ProxElemNorm2(index=0, size=3 * n, count=n, dim=3,
                                interleaved=False, fun="abs",
                                coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    return mod.Problem.create(
        mod.linop.LinearOperator.create([grad]), prox_g=prox_g,
        prox_fstar=[mod.prox.ProxMoreau(index=0, size=3 * n, child=pn)])


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label_first", [False, True])
@pytest.mark.parametrize("L", [1, 4])
def test_gradient3d_block_matches_jax_and_is_adjoint(x64, label_first, L):
    """apply, adjoint and the preconditioner sums against the JAX block in
    f64; <Kx, y> = <x, K^T y>; the segment order [gx; gy; gl] and the
    Dirichlet label boundary gl_{L-1} = -u_{L-1}."""
    from prost_tpu.linop import BlockGradient3D as JGrad3

    nx, ny = 7, 5
    jb = JGrad3(row=0, col=0, nx=nx, ny=ny, L=L, label_first=label_first)
    tb = ptt.linop.BlockGradient3D(row=0, col=0, nx=nx, ny=ny, L=L,
                                   label_first=label_first)
    assert (tb.nrows, tb.ncols) == (jb.nrows, jb.ncols) == (3 * nx * ny * L,
                                                            nx * ny * L)
    rng = np.random.RandomState(L)
    x, y = rng.randn(tb.ncols), rng.randn(tb.nrows)
    kx = tb.apply(torch.from_numpy(x)).numpy()
    kty = tb.apply_adjoint(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(kx, np.asarray(jb.apply(x)), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(kty, np.asarray(jb.apply_adjoint(y)),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(kx @ y, x @ kty, rtol=1e-12)
    for name, want in (("row_sum", 2.0), ("col_sum", 6.0)):
        got = getattr(tb, name)(1.0).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jb, name)(1.0)))
        assert np.all(got == want)
    u = x.reshape((nx, ny, L) if label_first else (L, nx, ny))
    gl = kx[2 * tb.ncols:].reshape(u.shape)
    last = (slice(None), slice(None), -1) if label_first else (-1,)
    np.testing.assert_allclose(gl[last], -u[last], rtol=1e-12)


def test_gradient3d_factory_places_the_block():
    n = 6 * 5 * 2
    for mod in (pt, ptt):
        blk, sz = mod.block.gradient3d(6, 5, 2)(3, 4, 0, 0)
        assert (blk.row, blk.col, blk.nx, blk.ny, blk.L) == (3, 4, 6, 5, 2)
        assert sz == (3 * n, n) and not blk.label_first


# ---------------------------------------------------------------------------
# the kernels: plain versions against the JAX kernels
# ---------------------------------------------------------------------------

def _chunk_inputs(seed, L, nx, ny, clean=False):
    """u, q (with mass on the dead coordinates unless ``clean``), f, w as
    numpy f32."""
    rng = np.random.RandomState(seed)
    q = 0.3 * rng.randn(3, L, nx, ny)
    if clean:  # the banded JAX kernels take a canonical q
        q[0, :, -1, :] = 0.0
        q[1, :, :, -1] = 0.0
    arrs = (rng.rand(L, nx, ny), q, rng.rand(L, nx, ny),
            2.0 * (rng.rand(L, nx, ny) > 0.3))
    return [a.astype(np.float32) for a in arrs]


def _close(t_out, j_out, n_planes=4):
    for i, (a, b) in enumerate(zip(t_out[:n_planes], j_out[:n_planes])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PLANE_ATOL,
                                   rtol=0, err_msg=f"plane {i}")
    ref = np.asarray(j_out[n_planes])
    np.testing.assert_allclose(t_out[n_planes].numpy(), ref, rtol=NORM_RTOL,
                               atol=NORM_RTOL * np.abs(ref).max())


ARGS = (0.9, 1.1, 1.0, 6.0, 0.5)  # tau, sigma, theta, lmb, radius


@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("L,ri", [(3, 1), (3, 7), (1, 1), (1, 7)])
def test_vol_chunk_matches_jax_kernel(L, ri, dataterm):
    """Row 23: vol_fused_chunk on a ragged 10x9 volume with mass on the
    dead dual coordinates (both zero them at entry)."""
    state = _chunk_inputs(10 * L + ri, L, 10, 9)
    j = jv.vol_fused_chunk(*map(jnp.asarray, state), *ARGS, ri,
                           dataterm=dataterm, interpret=True)
    t = tv.vol_chunk(*map(torch.from_numpy, state), torch.tensor(ARGS), ri,
                     dataterm)
    _close(t, j)


def _scal13(tol):
    return [1.0, 1.0, 1.0, 6.0, 1.0, 0.5, 0.0, 0.0, 1.0, tol, tol, tol, tol]


def _mc_consts(L, nx, ny):
    n = L * nx * ny
    return (float(np.sqrt(3 * n)), float(np.sqrt(n)), 1.5, 0.95, 1.05, 0.8)


def _mc_close(t_out, j_out):
    """Planes, the late norms and the 7 adaptation scalars; the converged
    flag and the executed-chunk count exactly."""
    _close(t_out, j_out)
    np.testing.assert_allclose(t_out[5].numpy(), np.asarray(j_out[5])[:7],
                               rtol=1e-6)
    assert t_out[5][5:].tolist() == np.asarray(j_out[5])[5:7].tolist()


@pytest.mark.parametrize("stepsize", ["boyd", "goldstein"])
def test_vol_multichunk_matches_jax_kernel(stepsize):
    """Row 26: a solve's start (u = f, q = 0); at tolerance 1e-2 both rules
    adapt and the launch converges in its fourth chunk of 8."""
    L, nx, ny, ri = 3, 16, 20, 5
    f = _chunk_inputs(7, L, nx, ny)[2]
    u, q = f, np.zeros((3, L, nx, ny), np.float32)
    consts = _mc_consts(L, nx, ny)
    j = jv.vol_fused_multichunk(
        *map(jnp.asarray, (u, q, f, f)), jnp.asarray(_scal13(1e-2),
                                                     jnp.float32),
        ri, 8, "square", stepsize, consts, interpret=True)
    t = tv.vol_multichunk(*map(torch.from_numpy, (u, q, f, f)),
                          torch.tensor(_scal13(1e-2)), ri, 8, "square",
                          stepsize, consts)
    _mc_close(t, j)
    assert 1 < float(t[5][6]) < 8 and float(t[5][5]) == 1.0


@pytest.mark.parametrize("double_buffer", [False, True])
def test_vol_chunk_matches_jax_banded(double_buffer):
    """Row 28: vol_fused_chunk_banded (2 bands of 32 rows;
    _vol_banded_kernel, and _vol_banded_db_kernel with the double buffer)
    against the port's chunk on the whole volume."""
    L, nx, ny, ri = 3, 64, 16, 4
    state = _chunk_inputs(21, L, nx, ny, clean=True)
    j = jv.vol_fused_chunk_banded(*map(jnp.asarray, state), *ARGS, ri, 2,
                                  interpret=True, double_buffer=double_buffer)
    t = tv.vol_chunk(*map(torch.from_numpy, state), torch.tensor(ARGS), ri)
    _close(t, j)


def test_vol_multichunk_matches_jax_banded():
    """Row 27: vol_fused_multichunk_banded (2 bands, ping-pong slots)
    against the port's multichunk on the whole volume; boyd adapts and the
    launch converges partway."""
    L, nx, ny, ri = 3, 64, 16, 3
    f = _chunk_inputs(22, L, nx, ny)[2]
    u, q = f, np.zeros((3, L, nx, ny), np.float32)
    consts = _mc_consts(L, nx, ny)
    j = jv.vol_fused_multichunk_banded(
        *map(jnp.asarray, (u, q, f, f)), jnp.asarray(_scal13(1e-2),
                                                     jnp.float32),
        ri, 8, 2, "square", "boyd", consts, interpret=True)
    t = tv.vol_multichunk(*map(torch.from_numpy, (u, q, f, f)),
                          torch.tensor(_scal13(1e-2)), ri, 8, "square",
                          "boyd", consts)
    _mc_close(t, j)
    assert float(t[5][5]) == 1.0 and float(t[5][6]) < 8


def test_converged_at_entry_returns_the_inputs():
    u, q, f, w = map(torch.from_numpy, _chunk_inputs(3, 2, 8, 7))
    c = tv.vol_chunk(u, q, f, w, torch.tensor([*ARGS, 1.0]), 5)
    for a, b in zip(c[:4], (u, q, u, q)):
        assert torch.equal(a, b)
    assert torch.equal(c[4], torch.zeros(4))
    scal = torch.tensor([0.9, 1.1, 1.0, 6.0, 1.0, 0.5, 2.0, 3.0, 11.0,
                         1e-3, 1e-3, 1e-3, 1e-3, 1.0])
    m = tv.vol_multichunk(u, q, f, w, scal, 5, 8, "square", "boyd",
                          _mc_consts(2, 8, 7))
    for a, b in zip(m[:4], (u, q, u, q)):
        assert torch.equal(a, b)
    assert m[5].tolist() == [0.8999999761581421, 1.100000023841858, 0.5,
                             2.0, 3.0, 1.0, 0.0]


def test_wrapper_rejects_bad_input():
    u, q, f, w = map(torch.from_numpy, _chunk_inputs(4, 2, 8, 7))
    scal = torch.tensor(ARGS)
    with pytest.raises(ptt.ProstError, match="q must be"):
        tv.vol_chunk(u, q[:2], f, w, scal, 3)
    with pytest.raises(ptt.ProstError, match="u must be"):
        tv.vol_chunk(u[0], q, f, w, scal, 3)
    with pytest.raises(ptt.ProstError, match="data term"):
        tv.vol_chunk(u, q, f, w, scal, 3, "huber")
    with pytest.raises(ptt.ProstError, match="count"):
        tv.vol_chunk(u, q, f, w, scal, 0)
    with pytest.raises(ptt.ProstError, match="stepsize"):
        tv.vol_multichunk(u, q, f, w, torch.tensor(_scal13(0.0)), 3, 8,
                          "square", "alg2", _mc_consts(2, 8, 7))


# ---------------------------------------------------------------------------
# structure matching, problem arrays and the route
# ---------------------------------------------------------------------------

def _assert_match_equal(tm, jm):
    for key in ("L", "nx", "ny", "lmb", "radius", "dataterm"):
        assert tm[key] == jm[key], key
    for key in ("f", "w"):
        np.testing.assert_array_equal(tm[key].numpy(), np.asarray(jm[key]),
                                      err_msg=key)


@pytest.mark.parametrize("form", ["example", "bench", "wsquare"])
def test_match_vol_structure_matches_jax(form):
    """The example's modeling form, the Problem.create form of bench.py
    build_vol, and a per-voxel weighted square (f = b/a, w = a^2)."""
    L, nx, ny = 3, 8, 6
    rng = np.random.RandomState(5)
    f = rng.rand(L * nx * ny).astype(np.float32)
    a = (rng.rand(L * nx * ny) > 0.2).astype(np.float32) * 1.5
    probs = []
    for mod in (pt, ptt):
        if form == "example":
            probs.append(vol_model(mod, nx, ny, L, f, 6.0)[0].finalize())
        elif form == "bench":
            probs.append(bench_vol_problem(mod, L, nx, ny, f, 6.0))
        else:
            probs.append(bench_vol_problem(mod, L, nx, ny, f, 6.0, a=a))
    jm, tm = jv.match_vol_structure(probs[0]), tv.match_vol_structure(probs[1])
    assert jm is not None and tm is not None
    assert tm["dataterm"] == ("wsquare" if form == "wsquare" else "square")
    _assert_match_equal(tm, jm)


@pytest.mark.parametrize("case", ["label_first", "gradient2d",
                                  "identity_scaling", "float64"])
def test_match_rejections_match_jax(case):
    """label_first=True, a gradient2d, the identity scaling (Sigma and Tau
    are then not 1/2 and 1/6) and float64 (the route is f32 only)."""
    L, nx, ny = 2, 6, 5
    f = np.random.RandomState(6).rand(L * nx * ny)
    if case == "float64":
        ptt.set_dtype(torch.float64)
        try:
            assert tv.match_vol_structure(
                vol_model(ptt, nx, ny, L, f, 6.0)[0].finalize()) is None
        finally:
            ptt.set_dtype(torch.float32)
        return
    probs = [vol_model(mod, nx, ny, L, f, 6.0,
                       label_first=case == "label_first",
                       grad3=case != "gradient2d",
                       scaling=("identity" if case == "identity_scaling"
                                else "alpha"))[0].finalize()
             for mod in (pt, ptt)]
    assert jv.match_vol_structure(probs[0]) is None
    assert tv.match_vol_structure(probs[1]) is None


def _compare(a, b, path):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _compare(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _compare(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, b, rtol=1e-7, err_msg=path)
    else:
        assert a == b, path


def test_problem_arrays_match_jax():
    """Both packages finalize the example's model alike: one
    BlockGradient3D (nx, ny, L, label_first), Sigma = 1/2, Tau = 1/6, the
    square data term and the conjugate dim-3 norm."""
    L, nx, ny = 3, 6, 5
    f = np.random.RandomState(2).rand(L * nx * ny)
    ja, ta = (interop.problem_arrays(vol_model(mod, nx, ny, L, f, 6.0)[0]
                                     .finalize()) for mod in (pt, ptt))
    _compare(ta, ja, "problem")
    blk = ta["blocks"][0]
    assert blk["type"] == "BlockGradient3D"
    assert (blk["nx"], blk["ny"], blk["L"], blk["label_first"]) == (nx, ny, L,
                                                                    False)
    np.testing.assert_allclose(ta["scaling_left"], 0.5, rtol=1e-6)
    np.testing.assert_allclose(ta["scaling_right"], 1 / 6, rtol=1e-6)
    assert ta["prox_fstar"][0]["child"]["dim"] == 3


def _assert_runs_agree(ts, js, atol=RUN_ATOL):
    assert int(ts.iteration) == int(js.iteration)
    assert bool(ts.converged) == bool(js.converged)
    for name in ("x", "y", "x_prev", "y_prev", "kx", "kty"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=atol,
                                   err_msg=name)
    np.testing.assert_allclose(float(ts.tau), float(js.tau), rtol=1e-6)


# one model and one set of options for the JAX fused runs of this file, so
# that they share one compile of the JAX route
NX, NY, LV, LMB = 16, 24, 4, 6.0
POPTS = dict(stepsize="boyd", residual_iter=10, scale_steps_operator=False)


def _data():
    """A drifting stack of noisy slices, as the example makes it."""
    rng = np.random.RandomState(42)
    x = np.linspace(0, 1, NY)
    base = np.where((x[None, :] - 0.5) ** 2 + (np.linspace(0, 1, NX)[:, None]
                                               - 0.5) ** 2 < 0.1, 0.8, 0.2)
    stack = np.stack([np.roll(base, s, axis=0) for s in range(LV)])
    return (stack + 0.08 * rng.randn(LV, NX, NY)).reshape(-1)


def _sopts(mod, t=0.0):
    return mod.SolverOptions(verbose=False, tol_rel_primal=t, tol_rel_dual=t,
                             tol_abs_primal=t, tol_abs_dual=t)


def _fused(mod, prob, sopts=None):
    if mod is pt:
        return JFused(prob, JOptions(**POPTS), sopts or _sopts(pt),
                      interpret=True)
    return TFused(prob, TOptions(**POPTS), sopts or _sopts(ptt))


def _model(mod):
    return vol_model(mod, NX, NY, LV, _data(), LMB)


def test_fused_backend_matches_jax_fused():
    """The port's FusedROFPDHG (vol route, plain versions) against the JAX
    FusedROFPDHG (vol route, interpret mode) over 100 iterations of boyd
    with ri 10: phase A, one multichunk (B0), one chunk (B), the epilogue
    and C."""
    jb, tb = (_fused(mod, _model(mod)[0].finalize()) for mod in (pt, ptt))
    assert jb.vol is not None and tb.vol is not None
    assert tb.rof is None and tb.ml is None and tb.deblur is None
    assert tb.tight is None
    js = jb.run(jb.initial_state(), 100)
    ts = tb.run(tb.initial_state(), 100, 0)
    assert int(ts.iteration) == 100
    _assert_runs_agree(ts, js)
    np.testing.assert_allclose(float(ts.primal_residual),
                               float(js.primal_residual), rtol=1e-3)


def test_boundary_dual_warm_start_matches_jax():
    """Mass on q_x's last row, q_y's last column and q_l's last label plane
    of a warm start: the route zeroes the first two (dead coordinates of
    the Neumann axes) and keeps the third (the Dirichlet label axis couples
    it to -u_last), as the JAX route does, and both go on alike."""
    n = NX * NY * LV
    rng = np.random.RandomState(17)
    y0 = (0.1 * rng.randn(3 * n)).astype(np.float32)
    q = y0.reshape(3, LV, NX, NY)
    q[0, :, -1, :] = 0.5
    q[1, :, :, -1] = -0.5
    q[2, -1] = 0.25

    def run(mod):
        b = _fused(mod, _model(mod)[0].finalize())
        s = b.initial_state()
        if mod is ptt:
            s = type(s)(**{**vars(s), "y": torch.from_numpy(y0)})
            return b.run(s, 26, 0)
        return b.run(type(s)(**{**vars(s), "y": jnp.asarray(y0)}), 26)

    ts, js = run(ptt), run(pt)
    np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), atol=RUN_ATOL)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=RUN_ATOL)
    tq = ts.y.numpy().reshape(3, LV, NX, NY)
    assert np.all(tq[0, :, -1, :] == 0.0) and np.all(tq[1, :, :, -1] == 0.0)
    assert np.all(tq[2, -1] != 0.0)


def vol_energy(x, f, lmb, L, nx, ny):
    """lmb/2 ||u - f||^2 + sum over voxels of |(gx, gy, gl)|_2 in f64."""
    u = np.asarray(x, np.float64).reshape(L, nx, ny)
    gx, gy = np.zeros_like(u), np.zeros_like(u)
    gx[:, :-1] = u[:, 1:] - u[:, :-1]
    gy[:, :, :-1] = u[:, :, 1:] - u[:, :, :-1]
    gl = np.concatenate([u[1:], np.zeros_like(u[:1])]) - u
    return float(0.5 * lmb * np.sum((u.reshape(-1) - f) ** 2)
                 + np.sum(np.sqrt(gx ** 2 + gy ** 2 + gl ** 2)))


def test_modeling_solve_matches_jax_and_generic_f64():
    """The example's model at 16x24x4 through ptt.solve (the fused vol
    route, plain versions on the CPU) against the JAX package's fused route
    (interpret mode): iterates within RUN_ATOL, the same iteration count;
    both energies within 1e-4 of a generic f64 solve of the port (5000
    iterations of boyd; its energy is within 1.2e-5 of that of 20000)."""
    f = _data()
    opts = dict(max_iters=4000, num_cback_calls=5, verbose=False,
                tol_rel_primal=1e-5, tol_rel_dual=1e-5, tol_abs_primal=1e-5,
                tol_abs_dual=1e-5)
    jprob, _ = _model(pt)
    jres = pt.Solver(jprob.finalize(), lambda p, o: _fused(pt, p, o),
                     pt.SolverOptions(**opts)).solve()
    tprob, tu = _model(ptt)

    class Recorded(ptt.modeling.Backend):
        def create(self, problem, solver_opts):
            self.made = super().create(problem, solver_opts)
            return self.made

    tbackend = Recorded("pdhg", TOptions(**POPTS))
    tres = ptt.solve(tprob, tbackend, ptt.options(**opts))
    assert tbackend.made.vol is not None  # the fused vol route
    assert tres.result.value == jres.result.value == "converged"
    assert tres.iterations == jres.iterations
    np.testing.assert_allclose(tu.val, tres.x)
    np.testing.assert_allclose(tres.x, np.asarray(jres.x), atol=RUN_ATOL)
    np.testing.assert_allclose(tres.y, np.asarray(jres.y), atol=RUN_ATOL)

    ptt.set_dtype(torch.float64)
    try:
        gprob, _ = vol_model(ptt, NX, NY, LV, f, LMB)
        gbackend = Recorded("pdhg", TOptions(**POPTS))
        t = 1e-9
        gres = ptt.solve(gprob, gbackend, ptt.options(
            max_iters=5000, num_cback_calls=5, verbose=False,
            tol_rel_primal=t, tol_rel_dual=t, tol_abs_primal=t,
            tol_abs_dual=t))
        assert gbackend.made.vol is None  # f64: the generic path
    finally:
        ptt.set_dtype(torch.float32)
    e_opt = vol_energy(gres.x, f, LMB, LV, NX, NY)
    for x in (tres.x, np.asarray(jres.x)):
        e = vol_energy(x, f, LMB, LV, NX, NY)
        assert abs(e - e_opt) <= ENERGY_RTOL * abs(e_opt), (e, e_opt)
