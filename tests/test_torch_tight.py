"""Port parity for slice 5: the tight multilabel relaxation
(examples/example_multilabel_tight.py) in prost_tpu_torch against
prost_tpu.

* ``BlockDiags`` and its factories against the JAX block in f64: apply,
  adjoint, the preconditioner sums, adjointness;
* both packages finalize the tight model to the same K, proxes and
  preconditioners;
* the fused tight chunk's plain version (what a CPU tensor runs) against
  the JAX kernel in Pallas interpret mode, whole plane and banded (row 22
  of the kernel table, closed by the port's one kernel), f32 at L = 3 and
  4: planes within 2e-5 times max(1, |plane|max), norms 1e-4 relative
  with a floor of 1e-4 of the largest norm (norms of differences of
  nearby iterates);
* the route in FusedROFPDHG, the matcher, a warm start with mass on q's
  boundary coordinates, and the whole slice through ``ptt.solve`` against
  the JAX fused route and a scipy graph-ADMM optimum.

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
from prost_tpu.backend import PDHGOptions as JOptions
from prost_tpu.ops import FusedROFPDHG as JFused
from prost_tpu.ops import fused_tight as jt
from prost_tpu_torch import interop
from prost_tpu_torch.backend import PDHGOptions as TOptions
from prost_tpu_torch.ops import FusedROFPDHG as TFused
from prost_tpu_torch.ops import fused_tight as tt

PLANE_ATOL, NORM_RTOL = 2e-5, 1e-4
RUN_ATOL = 3e-5  # whole runs (tests/test_fused_tight.py's bar)


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


def pair_matrix(L):
    """P of the example: row m (and m + k) takes the difference of the
    labels of pair m in the x (and y) components."""
    k = L * (L - 1) // 2
    P = np.zeros((2 * k, 2 * L))
    idx = 0
    for i in range(L):
        for j in range(i + 1, L):
            P[idx, i], P[idx, j] = 1.0, -1.0
            P[idx + k, i + L], P[idx + k, j + L] = 1.0, -1.0
            idx += 1
    return P


def tight_model(mod, nx, ny, L=3, lmb=1.0, seed=0, scaling="alpha"):
    """examples/example_multilabel_tight.py's model in package ``mod`` on
    random unaries; returns (problem, u, f)."""
    n, k = nx * ny, L * (L - 1) // 2
    f = np.random.RandomState(seed).rand(n * L)
    u, v = mod.Variable(n * L), mod.Variable(2 * n * k)
    q, p, s = mod.Variable(2 * n * L), mod.Variable(2 * n * k), mod.Variable(n)
    prob = mod.MinMaxProblem([u, v], [q, p, s], scaling=scaling)
    prob.add_function(u, mod.function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(p, mod.function.sum_norm2(2, False, "ind_leq0",
                                                1 / lmb, 1, 1))
    prob.add_function(s, mod.function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, mod.block.sparse_kron_id(np.ones((1, L)), n))
    prob.add_dual_pair(v, p, mod.block.identity())
    prob.add_dual_pair(v, q, mod.block.sparse_kron_id(pair_matrix(L).T, n))
    return prob, u, f


def _sopts(mod, t=0.0, **kw):
    return mod.SolverOptions(verbose=False, tol_rel_primal=t, tol_rel_dual=t,
                             tol_abs_primal=t, tol_abs_dual=t, **kw)


# ---------------------------------------------------------------------------
# the diagonal block and the finalized model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,offsets", [((9, 9), (0,)),
                                           ((7, 10), (-2, 0, 3)),
                                           ((10, 6), (1, -4))])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_diags_block_matches_jax_and_is_adjoint(x64, shape, offsets, alpha):
    """A banded matrix of constant diagonals, square and not, negative
    factors: apply, adjoint and the preconditioner sums against the JAX
    block in f64, and against the dense matrix."""
    from prost_tpu.linop import BlockDiags as JDiags

    nrows, ncols = shape
    factors = np.random.RandomState(1).randn(len(offsets))
    jb = JDiags.create(0, 0, nrows, ncols, factors, offsets)
    tb = ptt.linop.BlockDiags.create(0, 0, nrows, ncols, factors, offsets)
    dense = sum(f * np.eye(nrows, ncols, o) for f, o in zip(factors, offsets))
    rng = np.random.RandomState(2)
    x, y = rng.randn(ncols), rng.randn(nrows)
    kx = tb.apply(torch.from_numpy(x)).numpy()
    kty = tb.apply_adjoint(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(kx, np.asarray(jb.apply(x)), rtol=1e-12)
    np.testing.assert_allclose(kty, np.asarray(jb.apply_adjoint(y)),
                               rtol=1e-12)
    np.testing.assert_allclose(kx, dense @ x, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(kx @ y, x @ kty, rtol=1e-12)
    for name in ("row_sum", "col_sum"):
        np.testing.assert_allclose(
            getattr(tb, name)(alpha).numpy(),
            np.asarray(getattr(jb, name)(alpha)), rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("factory", ["identity", "diags"])
def test_diag_factories_place_the_block(factory):
    """identity(scal) is sized by the variable pair; diags(nrows, ncols,
    factors, offsets) carries its own size: the block applied by both
    packages."""
    n = 12
    out = []
    for mod in (pt, ptt):
        a, b = mod.Variable(n), mod.Variable(n)
        prob = mod.MinMaxProblem([a], [b])
        prob.add_function(a, mod.function.sum_1d("square", 1, 0.5, 1.0))
        prob.add_function(b, mod.function.sum_1d("zero"))
        blk = (mod.block.identity(2.5) if factory == "identity"
               else mod.block.diags(n, n, [1.0, -0.5], [0, 1]))
        prob.add_dual_pair(a, b, blk)
        out.append(prob.finalize().linop)
    x = np.random.RandomState(1).rand(n).astype(np.float32)
    np.testing.assert_allclose(out[1].apply(torch.from_numpy(x)).numpy(),
                               np.asarray(out[0].apply(x)), rtol=1e-6)


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
    """Both packages build the same four-block K (gradient, kron(P^T, I),
    identity, kron(1^T, I)) and finalize the model alike: the constant
    preconditioner segments Sigma = [1/(L+1); 1; 1/L], Tau = [1/5; 1/3]."""
    nx, ny, L = 6, 5, 3
    n, k = nx * ny, 3
    ja = interop.problem_arrays(tight_model(pt, nx, ny, L)[0].finalize())
    ta = interop.problem_arrays(tight_model(ptt, nx, ny, L)[0].finalize())
    _compare(ta, ja, "problem")
    assert [b["type"] for b in ta["blocks"]] == [
        "BlockGradient2D", "BlockKronId", "BlockDiags", "BlockKronId"]
    np.testing.assert_array_equal(ta["blocks"][1]["data"], pair_matrix(L).T)
    sl, sr = ta["scaling_left"], ta["scaling_right"]
    np.testing.assert_allclose(sl[:2 * n * L], 1 / (L + 1), rtol=1e-6)
    np.testing.assert_allclose(sl[2 * n * L:2 * n * (L + k)], 1.0)
    np.testing.assert_allclose(sl[2 * n * (L + k):], 1 / L, rtol=1e-6)
    np.testing.assert_allclose(sr[:n * L], 0.2, rtol=1e-6)
    np.testing.assert_allclose(sr[n * L:], 1 / 3, rtol=1e-6)


# ---------------------------------------------------------------------------
# the chunk: plain version against the JAX kernel
# ---------------------------------------------------------------------------

def _chunk_inputs(seed, L, nx, ny):
    """u, v, q (with mass on its boundary coordinates), p, s as numpy
    f32."""
    k = L * (L - 1) // 2
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(L, nx, ny), 0.1 * rng.randn(2 * k, nx, ny),
            0.2 * rng.randn(2 * L, nx, ny), 0.1 * rng.randn(2 * k, nx, ny),
            0.1 * rng.randn(nx, ny))
    return [a.astype(np.float32) for a in arrs]


def _close(t_out, j_new, j_prev, j_norms):
    for i, (a, b) in enumerate(zip(t_out[:10], tuple(j_new) + tuple(j_prev))):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, atol=PLANE_ATOL * scale,
                                   rtol=0, err_msg=f"plane {i}")
    ref = np.asarray(j_norms)
    np.testing.assert_allclose(t_out[10].numpy(), ref, rtol=NORM_RTOL,
                               atol=NORM_RTOL * np.abs(ref).max())


def _matched(L, nx, ny, lmb=0.8, seed=4):
    """The port's match of the model (equal to the JAX package's, see
    test_match_tight_structure_matches_jax), f as numpy."""
    m = tt.match_tight_structure(tight_model(ptt, nx, ny, L, lmb=lmb,
                                             seed=seed)[0].finalize())
    assert m is not None
    return {**m, "f": m["f"].numpy()}


@pytest.mark.parametrize("L,nx,ny,ri", [(3, 13, 9, 1), (4, 10, 12, 3)])
def test_tight_chunk_matches_jax_kernel(L, nx, ny, ri):
    m = _matched(L, nx, ny)
    state = _chunk_inputs(ri, L, nx, ny)
    args = (0.9, 1.1, 1.0, m["radius"], m["d_s"])
    new, prev, norms = jt.tight_fused_chunk(
        *map(jnp.asarray, state), jnp.asarray(m["f"]), *args, ri,
        m["taps"], m["consts"], interpret=True)
    out = tt.tight_chunk(*map(torch.from_numpy, state),
                         torch.from_numpy(m["f"]),
                         torch.tensor(args), ri, m["taps"], m["consts"])
    _close(out, new, prev, norms)


@pytest.mark.parametrize("double_buffer", [False, True])
def test_tight_chunk_matches_jax_banded(double_buffer):
    """Row 22: tight_fused_chunk_banded (2 bands of 32 rows;
    _tight_banded_kernel, and _tight_banded_db_kernel with the double
    buffer) against the port's chunk on the whole plane."""
    L, nx, ny, ri = 3, 64, 16, 4
    m = _matched(L, nx, ny)
    state = _chunk_inputs(11, L, nx, ny)
    args = (0.9, 1.1, 1.0, m["radius"], m["d_s"])
    new, prev, norms = jt.tight_fused_chunk_banded(
        *map(jnp.asarray, state), jnp.asarray(m["f"]), *args, ri,
        m["taps"], m["consts"], 2, interpret=True,
        double_buffer=double_buffer)
    out = tt.tight_chunk(*map(torch.from_numpy, state),
                         torch.from_numpy(m["f"]),
                         torch.tensor(args), ri, m["taps"], m["consts"])
    _close(out, new, prev, norms)


def test_converged_at_entry_returns_the_inputs():
    m = _matched(3, 8, 7)
    state = [torch.from_numpy(a) for a in _chunk_inputs(3, 3, 8, 7)]
    f = torch.from_numpy(m["f"])
    c = tt.tight_chunk(*state, f, torch.tensor([0.9, 1.1, 1.0, 1.0, 1.0, 1.0]),
                       5, m["taps"], m["consts"])
    for a, b in zip(c[:10], state * 2):
        assert torch.equal(a, b)
    assert torch.equal(c[10], torch.zeros(4))


def test_wrapper_rejects_bad_input():
    m = _matched(3, 8, 7)
    u, v, q, p, s = map(torch.from_numpy, _chunk_inputs(4, 3, 8, 7))
    f = torch.from_numpy(m["f"])
    scal = torch.tensor([0.9, 1.1, 1.0, 1.0, 1.0])
    taps, consts = m["taps"], m["consts"]
    with pytest.raises(ptt.ProstError, match="p must be"):
        tt.tight_chunk(u, v, q, p[:2], s, f, scal, 3, taps, consts)
    with pytest.raises(ptt.ProstError, match="v must be"):
        tt.tight_chunk(u, v[:5], q, p, s, f, scal, 3, taps, consts)
    with pytest.raises(ptt.ProstError, match="outside"):
        tt.tight_chunk(u, v, q, p, s, f, scal, 3, taps + ((6, 0, 1.0),),
                       consts)
    with pytest.raises(ptt.ProstError, match="consts"):
        tt.tight_chunk(u, v, q, p, s, f, scal, 3, taps, consts[:4])
    with pytest.raises(ptt.ProstError, match="count"):
        tt.tight_chunk(u, v, q, p, s, f, scal, 0, taps, consts)


def test_kron_array_layout():
    """The kernel's tap array: by output row [row_ptr; col; w], then by
    output column [col_ptr; row; w], each run in the plain version's fold
    order (columns ascending within a row, rows ascending within a
    column)."""
    taps = ((0, 1, 2.0), (0, 3, -1.0), (2, 1, 0.5), (3, 0, 4.0))
    a = tt.kron_array(taps, 2, 2, torch.device("cpu")).tolist()
    assert a == [0, 2, 2, 3, 4, 1, 3, 1, 0, 2.0, -1.0, 0.5, 4.0,
                 0, 1, 3, 3, 4, 3, 0, 2, 0, 4.0, 2.0, 0.5, -1.0]


# ---------------------------------------------------------------------------
# structure matching and the route
# ---------------------------------------------------------------------------

def test_match_tight_structure_matches_jax():
    jm, tm = (mod_m(tight_model(mod, 8, 6, 4, lmb=0.7)[0].finalize())
              for mod, mod_m in ((pt, jt.match_tight_structure),
                                 (ptt, tt.match_tight_structure)))
    for key in ("nx", "ny", "L", "k", "taps", "radius", "d_s", "consts"):
        assert tm[key] == jm[key], key
    np.testing.assert_array_equal(tm["f"].numpy(), np.asarray(jm["f"]))
    assert len(tm["taps"]) == 4 * tm["k"] == 24


def _fast_model(mod, nx, ny, L):
    """The fast relaxation (no pairwise coupling): another structure."""
    n = nx * ny
    u, q, s = mod.Variable(n * L), mod.Variable(2 * n * L), mod.Variable(n)
    prob = mod.MinMaxProblem([u], [q, s])
    prob.add_function(u, mod.function.sum_1d("ind_geq0", 1, 0, 1, 0.5, 0))
    prob.add_function(q, mod.function.sum_norm2(2 * L, False, "ind_leq0",
                                                1, 1, 1))
    prob.add_function(s, mod.function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, mod.block.sparse_kron_id(np.ones((1, L)), n))
    return prob


@pytest.mark.parametrize("case", ["fast", "identity_scaling", "float64"])
def test_match_rejections_match_jax(case):
    """The fast relaxation; the tight model under the identity scaling
    (its segments stay constant, so it matches in both packages, as the
    JAX matcher reads only constancy); float64 (the route is f32 only)."""
    if case == "float64":
        ptt.set_dtype(torch.float64)
        try:
            assert tt.match_tight_structure(
                tight_model(ptt, 6, 5)[0].finalize()) is None
        finally:
            ptt.set_dtype(torch.float32)
        return
    if case == "fast":
        probs = [_fast_model(mod, 6, 5, 3).finalize() for mod in (pt, ptt)]
        assert jt.match_tight_structure(probs[0]) is None
        assert tt.match_tight_structure(probs[1]) is None
        return
    probs = [tight_model(mod, 6, 5, scaling="identity")[0].finalize()
             for mod in (pt, ptt)]
    assert (jt.match_tight_structure(probs[0])["consts"]
            == tt.match_tight_structure(probs[1])["consts"]
            == (1.0, 1.0, 1.0, 1.0, 1.0))


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
NX, NY, L3, LMB, SEED = 9, 8, 3, 0.4, 3
POPTS = dict(stepsize="boyd", residual_iter=10, scale_steps_operator=False)


def _fused(mod, prob, sopts=None):
    if mod is pt:
        return JFused(prob, JOptions(**POPTS), sopts or _sopts(pt),
                      interpret=True)
    return TFused(prob, TOptions(**POPTS), sopts or _sopts(ptt))


def _model(mod):
    return tight_model(mod, NX, NY, L3, lmb=LMB, seed=SEED)


def test_fused_backend_matches_jax_fused():
    """The port's FusedROFPDHG (tight route, plain version) against the JAX
    FusedROFPDHG (tight route, interpret mode) over 60 iterations of boyd
    with ri 10: phases A, B, the epilogue and C."""
    jb, tb = (_fused(mod, _model(mod)[0].finalize()) for mod in (pt, ptt))
    assert jb.tight is not None and tb.tight is not None
    assert tb.rof is None and tb.ml is None and tb.deblur is None
    js = jb.run(jb.initial_state(), 60)
    ts = tb.run(tb.initial_state(), 60, 0)
    assert int(ts.iteration) == 60
    _assert_runs_agree(ts, js)
    np.testing.assert_allclose(float(ts.primal_residual),
                               float(js.primal_residual), rtol=1e-3)


def test_boundary_dual_warm_start_matches_jax():
    """Mass on q_x's last row and q_y's last column of a warm start: the
    route zeroes nothing (q stays live there through the kron coupling),
    as the JAX route, and both go on alike."""
    nx, ny, L = NX, NY, L3
    n, k = nx * ny, 3
    rng = np.random.RandomState(17)
    y0 = (0.1 * rng.randn(2 * n * L + 2 * n * k + n)).astype(np.float32)
    q = y0[:2 * n * L].reshape(2 * L, nx, ny)
    q[:L, -1, :] = 0.5
    q[L:, :, -1] = -0.5

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
    tq = ts.y.numpy()[:2 * n * L].reshape(2 * L, nx, ny)
    assert np.all(tq[:L, -1, :] != 0.0) and np.all(tq[L:, :, -1] != 0.0)


# ---------------------------------------------------------------------------
# the whole slice: modeling -> solve -> fused route
# ---------------------------------------------------------------------------

def _grad_matrix(nx, ny, L):
    def d(k):
        m = sp.diags([-np.ones(k), np.ones(k - 1)], [0, 1],
                     shape=(k, k)).tolil()
        m[-1, -1] = 0.0
        return m

    eye_l = sp.eye(L)
    return sp.vstack([sp.kron(eye_l, sp.kron(d(nx), sp.eye(ny))),
                      sp.kron(eye_l, sp.kron(sp.eye(nx), d(ny)))]).tocsr()


def tight_energy(x, f, lmb, n, L, k):
    """<u, f> + lmb sum over pixels and pairs of |v_pair|_2."""
    u, v = x[:n * L], x[n * L:].reshape(2, k * n)
    return float(u @ f + lmb * np.sqrt((v ** 2).sum(axis=0)).sum())


def test_modeling_solve_matches_jax_and_oracle():
    """The tight model at 9x8 with 3 labels through ptt.solve (the fused
    tight route, plain version on the CPU) against the JAX package's fused
    route (interpret mode) and the f64 graph-ADMM optimum of
    min <u, f> + lmb sum |v_pair| s.t. grad u + kron(P^T, I) v = 0,
    sum_l u_l = 1, u >= 0: energies within 1e-3 of the optimum (the solve
    stops at 1e-5), constraint residual and partition of unity small."""
    from oracles import graph_admm, prox_group_l2

    nx, ny, L, lmb = NX, NY, L3, LMB
    n, k = nx * ny, 3
    opts = dict(max_iters=8000, num_cback_calls=5, verbose=False,
                tol_rel_primal=1e-5, tol_rel_dual=1e-5, tol_abs_primal=1e-5,
                tol_abs_dual=1e-5)
    jprob, _, f = _model(pt)
    jres = pt.Solver(jprob.finalize(), lambda p, o: _fused(pt, p, o),
                     pt.SolverOptions(**opts)).solve()
    tprob, tu, _ = _model(ptt)

    class Recorded(ptt.modeling.Backend):
        def create(self, problem, solver_opts):
            self.made = super().create(problem, solver_opts)
            return self.made

    tbackend = Recorded("pdhg", TOptions(**POPTS))
    tres = ptt.solve(tprob, tbackend, ptt.options(**opts))
    assert tbackend.made.tight is not None  # the fused tight route
    assert tres.result.value == jres.result.value == "converged"
    np.testing.assert_allclose(tu.val, tres.x[:n * L])

    G = _grad_matrix(nx, ny, L)
    kp = sp.kron(pair_matrix(L).T, sp.eye(n))
    ones = sp.kron(np.ones((1, L)), sp.eye(n))
    K = sp.bmat([[G, kp], [None, sp.eye(2 * n * k)],
                 [ones, None]]).tocsr()
    nq, np_ = 2 * n * L, 2 * n * k
    group = prox_group_l2((2, n * k), weight=lmb)

    def prox_g(x, t):  # u >= 0 with the linear unaries; v free
        return np.concatenate([np.maximum(x[:n * L] - t * f, 0.0),
                               x[n * L:]])

    def prox_f(z, t):  # q rows = 0, lmb |p_pair|, s rows = 1
        return np.concatenate([np.zeros(nq), group(z[nq:nq + np_], t),
                               np.ones(n)])

    x_star, _ = graph_admm(K, prox_g, prox_f, iters=30000, tol=1e-10)
    e_opt = tight_energy(x_star, f, lmb, n, L, k)
    for x in (tres.x, np.asarray(jres.x)):
        x = x.astype(np.float64)
        e = tight_energy(x, f, lmb, n, L, k)
        assert abs(e - e_opt) <= 1e-3 * (1.0 + abs(e_opt)), (e, e_opt)
        assert np.abs(G @ x[:n * L] + kp @ x[n * L:]).max() <= 5e-2
        assert np.abs(x[:n * L].reshape(L, n).sum(axis=0) - 1).max() <= 5e-2
    np.testing.assert_allclose(tight_energy(tres.x.astype(np.float64), f,
                                            lmb, n, L, k),
                               tight_energy(np.asarray(jres.x, np.float64),
                                            f, lmb, n, L, k), rtol=1e-4)
