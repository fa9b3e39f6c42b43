"""Port parity for slice 4: TV deblurring (BASELINE config 2,
examples/example_deblurring.py) in prost_tpu_torch against prost_tpu.

* ``BlockConv2D`` against the JAX block in f64: apply, adjoint, the
  preconditioner sums, adjointness;
* both packages finalize the deblur model to the same K, proxes and
  preconditioners;
* the fused deblur chunk's plain version (what a CPU tensor runs) against
  the JAX kernel in Pallas interpret mode, whole plane and banded (row 19
  of the kernel table, closed by the port's one kernel), f32: planes
  within 2e-5 times max(1, |plane|max) (the blur dual scales with lmb),
  norms 1e-4 relative with a floor of 1e-4 of the largest norm (the dual
  variable norm is zero in exact arithmetic, prox_g being zero, so what is
  left of it is rounding noise);
* the route in FusedROFPDHG, the matcher, a warm start with mass on the
  dual coordinates outside K^T's reach, and the whole slice through
  ``ptt.solve`` against the JAX fused route and a scipy graph-ADMM
  optimum.

The CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.backend import BackendPDHG as JBackend
from prost_tpu.backend import PDHGOptions as JOptions
from prost_tpu.ops import FusedROFPDHG as JFused
from prost_tpu.ops import fused_deblur as jd
from prost_tpu_torch import interop
from prost_tpu_torch.backend import BackendPDHG as TBackend
from prost_tpu_torch.backend import PDHGOptions as TOptions
from prost_tpu_torch.ops import FusedROFPDHG as TFused
from prost_tpu_torch.ops import fused_deblur as td

PLANE_ATOL, NORM_RTOL = 2e-5, 1e-4
RUN_ATOL = 3e-5  # whole runs (tests/test_fused_deblur.py's bar)


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


def asym_kernel(k=5):
    """tests/test_fused_deblur.py's blur: a diagonal and one corner."""
    ker = np.zeros((k, k))
    for i in range(k):
        ker[i, i] = 1.0
    ker[0, k - 1] = 0.5
    return ker / ker.sum()


def motion_kernel(klen=9):
    """bench.py's 45-degree motion blur (BASELINE config 2): 7 taps."""
    kern = np.zeros((klen, klen))
    c = (klen - 1) / 2
    t = np.deg2rad(45.0)
    for i in np.linspace(-c, c, 4 * klen):
        kern[int(round(c + i * np.sin(t))), int(round(c + i * np.cos(t)))] = 1
    return kern / kern.sum()


def deblur_model(mod, nx, ny, kernel, lmb=40.0, seed=2, dataterm="square",
                 fb=None):
    """examples/example_deblurring.py's model in package ``mod`` on the
    blurred observation ``fb``, random from ``seed`` by default; returns
    (problem, u, fb)."""
    ky, kx = kernel.shape
    nx2, ny2 = nx + kx - 1, ny + ky - 1
    if fb is None:
        fb = np.random.RandomState(seed).rand(nx2 * ny2)
    u = mod.Variable(nx * ny)
    v = mod.Variable(nx2 * ny2)
    g = mod.Variable(2 * nx * ny)
    prob = mod.MinProblem([u], [v, g])
    prob.add_function(v, mod.function.sum_1d(dataterm, 1, fb, lmb))
    prob.add_function(g, mod.function.sum_norm2(2, False, "abs"))
    prob.add_constraint(u, v, mod.block.conv2d(nx, ny, 1, kernel))
    prob.add_constraint(u, g, mod.block.gradient2d(nx, ny, 1))
    return prob, u, fb


def _sopts(mod, t=0.0, **kw):
    return mod.SolverOptions(verbose=False, tol_rel_primal=t, tol_rel_dual=t,
                             tol_abs_primal=t, tol_abs_dual=t, **kw)


# ---------------------------------------------------------------------------
# the convolution block and the finalized model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,kernel", [(1, "asym"), (2, "rect")])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_conv_block_matches_jax_and_is_adjoint(x64, L, kernel, alpha):
    """Full convolution and valid correlation of a (ky, kx) kernel with
    negative entries, per channel, against the JAX block in f64."""
    from prost_tpu.linop import BlockConv2D as JConv

    rng = np.random.RandomState(3)
    ker = asym_kernel() if kernel == "asym" else rng.randn(3, 4)
    nx, ny = 9, 7
    jb = JConv.create(0, 0, nx, ny, L, ker)
    tb = ptt.linop.BlockConv2D.create(0, 0, nx, ny, L, ker)
    assert (tb.nrows, tb.ncols, tb.nx2, tb.ny2) == (jb.nrows, jb.ncols,
                                                    jb.nx2, jb.ny2)
    np.testing.assert_array_equal(tb.kernel.numpy(), np.asarray(jb.kernel))
    x = rng.randn(tb.ncols)
    y = rng.randn(tb.nrows)
    kx = tb.apply(torch.from_numpy(x)).numpy()
    kty = tb.apply_adjoint(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(kx, np.asarray(jb.apply(x)), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(kty, np.asarray(jb.apply_adjoint(y)),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(kx @ y, x @ kty, rtol=1e-12)
    for name in ("row_sum", "col_sum"):
        np.testing.assert_allclose(
            getattr(tb, name)(alpha).numpy(),
            np.asarray(getattr(jb, name)(alpha)), rtol=1e-12, err_msg=name)


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
        # the conv rows' Sigma: sums of the taps taken in another order
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=path)
    else:
        assert a == b, path


def test_problem_arrays_match_jax():
    """Both packages build the same K (the conv block with its kernel, the
    gradient block) and finalize the model alike: prox_f (the data term on
    the conv rows, the norm on the gradient rows), the zero prox_g filled
    in, Sigma = [1 / row sums of |B|; 1/2] and Tau = 1 / (sum |k| + 4)."""
    nx, ny = 10, 8
    ja = interop.problem_arrays(
        deblur_model(pt, nx, ny, asym_kernel())[0].finalize())
    ta = interop.problem_arrays(
        deblur_model(ptt, nx, ny, asym_kernel())[0].finalize())
    _compare(ta, ja, "problem")
    assert [b["type"] for b in ta["blocks"]] == ["BlockConv2D",
                                                 "BlockGradient2D"]
    np.testing.assert_array_equal(ta["blocks"][0]["kernel"],
                                  asym_kernel().T.astype(np.float32))
    np.testing.assert_allclose(ta["scaling_right"], 0.2, rtol=1e-6)


# ---------------------------------------------------------------------------
# the chunk: plain version against the JAX kernel
# ---------------------------------------------------------------------------

def _chunk_inputs(seed, nx, ny, kernel):
    """x, yv, q (with mass on the boundary coordinates), fb, sv and the
    taps of ``kernel`` (ky, kx), as numpy f32."""
    taps = td.kernel_taps(torch.as_tensor(kernel.T, dtype=torch.float32))
    nx2, ny2 = nx + kernel.shape[1] - 1, ny + kernel.shape[0] - 1
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(nx, ny), rng.randn(nx2, ny2), 0.3 * rng.randn(2, nx, ny),
            rng.rand(nx2, ny2), 0.5 + rng.rand(nx2, ny2))
    return [a.astype(np.float32) for a in arrs], taps


def _embed(a, nx2, ny2):
    out = np.zeros(a.shape[:-2] + (nx2, ny2), np.float32)
    out[..., :a.shape[-2], :a.shape[-1]] = a
    return out


def _close(t_out, j_out, nx, ny):
    """t_out in the port's layout, j_out embedded (JAX)."""
    for i, (a, b) in enumerate(zip(t_out[:6], j_out[:6])):
        b = np.asarray(b)
        if i in (0, 2, 3, 5):  # x, q planes: crop, and the padding is zero
            assert not np.any(b[..., nx:, :]) and not np.any(b[..., ny:])
            b = b[..., :nx, :ny]
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, atol=PLANE_ATOL * scale,
                                   rtol=0, err_msg=f"plane {i}")
    ref = np.asarray(j_out[6])
    np.testing.assert_allclose(t_out[6].numpy(), ref, rtol=NORM_RTOL,
                               atol=NORM_RTOL * np.abs(ref).max())


ARGS = (0.9, 1.1, 1.0, 40.0, 1.0)  # tau, sigma, theta, lmb, radius


@pytest.mark.parametrize("case", [("asym", 13, 9, 1), ("asym", 13, 9, 4),
                                  ("motion", 20, 17, 3)])
def test_deblur_chunk_matches_jax_kernel(case):
    """Ragged shapes, the asymmetric 5x5 blur and the 9x9 motion blur of
    config 2, ri 1 to 4."""
    name, nx, ny, ri = case
    kernel = asym_kernel() if name == "asym" else motion_kernel()
    (x, yv, q, fb, sv), taps = _chunk_inputs(ri, nx, ny, kernel)
    nx2, ny2 = yv.shape
    ref = jd.deblur_fused_chunk(
        jnp.asarray(_embed(x, nx2, ny2)), jnp.asarray(yv),
        jnp.asarray(_embed(q, nx2, ny2)), jnp.asarray(fb), jnp.asarray(sv),
        *ARGS, ri, nx, ny, taps, 0.5, 0.2, interpret=True)
    out = td.deblur_chunk(*map(torch.from_numpy, (x, yv, q, fb, sv)),
                          torch.tensor(ARGS), ri, taps, 0.5, 0.2)
    _close(out, ref, nx, ny)


@pytest.mark.parametrize("double_buffer", [False, True])
def test_deblur_chunk_matches_jax_banded(double_buffer):
    """Row 19: deblur_fused_chunk_banded (2 bands of 24 rows with the
    8-rounded conv-reach halo of 16; _deblur_banded_kernel, and
    _deblur_banded_db_kernel with the double buffer) against the port's
    chunk on the whole plane."""
    nx, ny, ri = 46, 12, 2
    kernel = asym_kernel(3)
    (x, yv, q, fb, sv), taps = _chunk_inputs(21, nx, ny, kernel)
    nx2, ny2 = yv.shape
    assert jd.deblur_banded_ok(nx2, 2)
    ref = jd.deblur_fused_chunk_banded(
        jnp.asarray(_embed(x, nx2, ny2)), jnp.asarray(yv),
        jnp.asarray(_embed(q, nx2, ny2)), jnp.asarray(fb), jnp.asarray(sv),
        *ARGS, ri, nx, ny, taps, 0.5, 0.2, 2, interpret=True,
        double_buffer=double_buffer)
    out = td.deblur_chunk(*map(torch.from_numpy, (x, yv, q, fb, sv)),
                          torch.tensor(ARGS), ri, taps, 0.5, 0.2)
    _close(out, ref, nx, ny)


def test_padding_stays_exactly_zero():
    """The plain version runs the JAX arithmetic on embedded planes: after
    a chunk the padding of x and q (new and previous) is exactly zero, so
    the port's kernel may read it as zero instead of storing it."""
    nx, ny = 11, 8
    (x, yv, q, fb, sv), taps = _chunk_inputs(5, nx, ny, asym_kernel())
    nx2, ny2 = yv.shape
    t = [torch.from_numpy(a) for a in (x, yv, q, fb, sv)]
    qe = td.embed(t[2], nx2, ny2)
    out = td.chunk_core(*torch.tensor(ARGS), td.embed(t[0], nx2, ny2), t[1],
                        qe[0], qe[1], t[3], t[4], 4, nx, ny, taps, 0.5, 0.2)
    for i in (0, 2, 3, 4, 6, 7):
        assert not torch.any(out[i][nx:, :]) and not torch.any(out[i][:, ny:])
        assert torch.any(out[i][:nx, :ny])


def test_converged_at_entry_returns_the_inputs():
    (x, yv, q, fb, sv), taps = _chunk_inputs(6, 12, 9, asym_kernel())
    t = [torch.from_numpy(a) for a in (x, yv, q, fb, sv)]
    c = td.deblur_chunk(*t, torch.tensor(ARGS + (1.0,)), 5, taps, 0.5, 0.2)
    for a, b in zip(c[:6], (t[0], t[1], t[2], t[0], t[1], t[2])):
        assert torch.equal(a, b)
    assert torch.equal(c[6], torch.zeros(4))


def test_wrapper_rejects_bad_input():
    (x, yv, q, fb, sv), taps = _chunk_inputs(7, 12, 9, asym_kernel())
    x, yv, q, fb, sv = map(torch.from_numpy, (x, yv, q, fb, sv))
    scal = torch.tensor(ARGS)
    with pytest.raises(ptt.ProstError, match="q must be"):
        td.deblur_chunk(x, yv, q[:1], fb, sv, scal, 3, taps, 0.5, 0.2)
    with pytest.raises(ptt.ProstError, match="sv must be"):
        td.deblur_chunk(x, yv, q, fb, sv[1:], scal, 3, taps, 0.5, 0.2)
    with pytest.raises(ptt.ProstError, match="outside"):
        td.deblur_chunk(x, yv, q, fb, sv, scal, 3, taps + ((9, 0, 1.0),),
                        0.5, 0.2)
    with pytest.raises(ptt.ProstError, match="taps"):
        td.deblur_chunk(x, yv, q, fb, sv, scal, 3, (), 0.5, 0.2)
    with pytest.raises(ptt.ProstError, match="count"):
        td.deblur_chunk(x, yv, q, fb, sv, scal, 0, taps, 0.5, 0.2)


# ---------------------------------------------------------------------------
# structure matching and the route
# ---------------------------------------------------------------------------

def _opts(mod):
    return (JOptions if mod is pt else TOptions)(scale_steps_operator=False)


def _match(mod, prob):
    if mod is pt:
        b = JBackend(prob, _opts(pt), _sopts(pt))
        return jd.match_deblur_structure(prob, b.prox_g, b.prox_fstar)
    b = TBackend(prob, _opts(ptt), _sopts(ptt))
    return td.match_deblur_structure(prob, b.prox_g, b.prox_fstar)


def test_match_deblur_structure_matches_jax():
    jm, tm = (_match(mod, deblur_model(mod, 12, 10, asym_kernel(),
                                       lmb=25.0)[0].finalize())
              for mod in (pt, ptt))
    for k in ("nx", "ny", "nx2", "ny2", "taps", "lmb", "radius", "sig_q",
              "tau_t"):
        assert tm[k] == jm[k], k
    np.testing.assert_array_equal(tm["fb"].numpy(), np.asarray(jm["fb"]))
    np.testing.assert_allclose(tm["sv"].numpy(), np.asarray(jm["sv"]),
                               rtol=1e-6)


def _rof_model(mod, nx, ny):
    """ROF: a lone gradient block, no conv block."""
    n = nx * ny
    u, q = mod.Variable(n), mod.Variable(2 * n)
    prob = mod.MinMaxProblem([u], [q])
    prob.add_function(u, mod.function.sum_1d("square", 1,
                                             np.ones(n) * 0.5, 8.0))
    prob.add_function(q, mod.function.conjugate(
        mod.function.sum_norm2(2, False, "abs")))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, 1))
    return prob


@pytest.mark.parametrize("case", ["rof", "l1_data", "float64"])
def test_match_rejections_match_jax(case):
    make = {"rof": lambda m: _rof_model(m, 8, 6),
            # an l1 data term: not the fused structure
            "l1_data": lambda m: deblur_model(m, 8, 6, asym_kernel(3),
                                              dataterm="abs")[0],
            "float64": lambda m: deblur_model(m, 8, 6, asym_kernel())[0]}
    if case == "float64":
        ptt.set_dtype(torch.float64)
        try:
            assert _match(ptt, make[case](ptt).finalize()) is None
        finally:
            ptt.set_dtype(torch.float32)
        return
    for mod in (pt, ptt):
        assert _match(mod, make[case](mod).finalize()) is None


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
NX, NY, LMB, SEED = 14, 12, 30.0, 3
POPTS = dict(stepsize="boyd", residual_iter=10, scale_steps_operator=False)


def _fused(mod, prob, sopts=None):
    if mod is pt:
        return JFused(prob, JOptions(**POPTS), sopts or _sopts(pt),
                      interpret=True)
    return TFused(prob, TOptions(**POPTS), sopts or _sopts(ptt))


def _model(mod):
    return deblur_model(mod, NX, NY, asym_kernel(), lmb=LMB, seed=SEED)


def test_fused_backend_matches_jax_fused():
    """The port's FusedROFPDHG (deblur route, plain version) against the JAX
    FusedROFPDHG (deblur route, interpret mode) over 60 iterations of boyd
    with ri 10: phases A, B, the epilogue and C."""
    jb, tb = (_fused(mod, _model(mod)[0].finalize()) for mod in (pt, ptt))
    assert jb.deblur is not None and tb.deblur is not None
    assert tb.rof is None and tb.ml is None
    js = jb.run(jb.initial_state(), 60)
    ts = tb.run(tb.initial_state(), 60, 0)
    assert int(ts.iteration) == 60
    _assert_runs_agree(ts, js)
    np.testing.assert_allclose(float(ts.primal_residual),
                               float(js.primal_residual), rtol=1e-3)


def test_dead_dual_warm_start_matches_jax():
    """Mass on q_x's last row and q_y's last column of a warm start: the
    route zeroes nothing (its gradient adjoint is masked), as the JAX
    route, and both go on alike; the mass shrinks under the ball
    projection but stays."""
    nx, ny = NX, NY
    m2 = (nx + 4) * (ny + 4)
    rng = np.random.RandomState(17)
    y0 = (0.1 * rng.randn(m2 + 2 * nx * ny)).astype(np.float32)
    q = y0[m2:].reshape(2, nx, ny)
    q[0, -1, :] = 0.5
    q[1, :, -1] = -0.5

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
    tq = ts.y.numpy()[m2:].reshape(2, nx, ny)
    assert np.all(tq[0, -1, :] != 0.0) and np.all(tq[1, :, -1] != 0.0)


def test_alg2_takes_the_generic_path():
    prob = deblur_model(ptt, 8, 6, asym_kernel())[0].finalize()
    assert TFused(prob, TOptions(stepsize="alg2"), _sopts(ptt)).deblur is None
    assert TFused(prob, TOptions(), _sopts(ptt)).deblur is not None


# ---------------------------------------------------------------------------
# the whole slice: modeling -> solve -> fused route
# ---------------------------------------------------------------------------

def _matrices(nx, ny, kernel):
    """B (the full convolution in the (nx, ny) view, y fastest) and the
    gradient K, as scipy sparse."""
    from scipy.signal import convolve2d

    n = nx * ny
    cols = []
    for j in range(n):
        e = np.zeros(n)
        e[j] = 1.0
        cols.append(convolve2d(e.reshape(nx, ny), kernel.T, mode="full")
                    .reshape(-1))
    B = sp.csr_matrix(np.stack(cols, axis=1))

    def d(k):
        m = sp.diags([-np.ones(k), np.ones(k - 1)], [0, 1],
                     shape=(k, k)).tolil()
        m[-1, -1] = 0.0
        return m

    K = sp.vstack([sp.kron(d(nx), sp.eye(ny)),
                   sp.kron(sp.eye(nx), d(ny))]).tocsr()
    return B, K


def test_modeling_solve_matches_jax_and_oracle():
    """The deblur model at 14x12 with the 5x5 blur through ptt.solve (the
    fused deblur route, plain version on the CPU) against the JAX package's
    fused route (interpret mode) and the f64 graph-ADMM optimum:
    lmb/2 |B u - f|^2 + TV(u) within 1e-4 of the optimum for both."""
    from oracles import (deblur_energy, graph_admm, prox_group_l2,
                         prox_weighted_square)

    nx, ny, lmb = NX, NY, LMB
    n = nx * ny
    kernel = asym_kernel()
    opts = dict(max_iters=6000, num_cback_calls=5, verbose=False,
                tol_rel_primal=1e-5, tol_rel_dual=1e-5, tol_abs_primal=1e-5,
                tol_abs_dual=1e-5)
    jprob, _, fb = _model(pt)
    jres = pt.Solver(jprob.finalize(), lambda p, o: _fused(pt, p, o),
                     pt.SolverOptions(**opts)).solve()
    tprob, tu, _ = _model(ptt)

    class Recorded(ptt.modeling.Backend):
        def create(self, problem, solver_opts):
            self.made = super().create(problem, solver_opts)
            return self.made

    tbackend = Recorded("pdhg", TOptions(**POPTS))
    tres = ptt.solve(tprob, tbackend, ptt.options(**opts))
    assert tbackend.made.deblur is not None  # the fused deblur route
    assert tres.result.value == jres.result.value == "converged"
    np.testing.assert_allclose(tu.val, tres.x)

    B, K = _matrices(nx, ny, kernel)
    m2 = B.shape[0]
    np.testing.assert_allclose(
        B @ tres.x.astype(np.float64),
        ptt.linop.BlockConv2D.create(0, 0, nx, ny, 1, kernel).apply(
            torch.from_numpy(tres.x.astype(np.float64))).numpy(),
        atol=1e-12)

    square, group = prox_weighted_square(fb, lmb), prox_group_l2((2, n))

    def prox_f(v, t):
        return np.concatenate([square(v[:m2], t), group(v[m2:], t)])

    u_star, _ = graph_admm(sp.vstack([B, K]).tocsr(), lambda v, t: v, prox_f,
                           iters=20000, tol=1e-11)
    e_opt = deblur_energy(B, K, u_star, fb, lmb, n)
    e_port = deblur_energy(B, K, tres.x.astype(np.float64), fb, lmb, n)
    e_jax = deblur_energy(B, K, np.asarray(jres.x, np.float64), fb, lmb, n)
    assert e_opt - 1e-6 * e_opt <= e_port <= e_opt + 1e-4 * e_opt
    np.testing.assert_allclose(e_port, e_jax, rtol=1e-5)
    np.testing.assert_allclose(tres.x, np.asarray(jres.x), atol=1e-3)
