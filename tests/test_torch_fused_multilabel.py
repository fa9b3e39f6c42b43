"""Port parity: the fused multilabel route of prost_tpu_torch against
prost_tpu.

On the CPU the kernel wrappers run their plain PyTorch versions; they are
held against the JAX kernels in Pallas interpret mode at L = 3 (f32, the
same operations in the same order: atol 1e-5 on the planes, rtol 1e-5 on
the norms, whose whole-plane sums run in another order).  The JAX
package's banded kernels for large planes (rows 14 and 16 of the kernel
table) are held against the port's one route, which serves every size.
The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda_kernels.py and by chip_smoke.py.
"""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.backend import PDHGOptions as JOptions
from prost_tpu.ops import FusedROFPDHG as JFused
from prost_tpu.ops import fused_multilabel as jml
from prost_tpu_torch.backend import BackendPDHG as TBackend
from prost_tpu_torch.backend import PDHGOptions as TOptions
from prost_tpu_torch.ops import FusedROFPDHG as TFused
from prost_tpu_torch.ops import cuda_build
from prost_tpu_torch.ops import fused_multilabel as tml

L, NX, NY = 3, 16, 12
PLANE_ATOL, NORM_RTOL = 1e-5, 1e-5
# whole fused runs over tens of iterations (as tests/test_fused_multilabel.py
# holds the JAX fused route against its generic path)
RUN_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _inputs(seed, L=L, nx=NX, ny=NY, start=False):
    """u, q (with mass on the dead coordinates, zeroed by both versions),
    s, f; ``start``: a solve's start, u = q = s = 0."""
    rng = np.random.RandomState(seed)
    u = rng.rand(L, nx, ny)
    q = 0.3 * rng.randn(2 * L, nx, ny)
    s = 0.1 * rng.randn(nx, ny)
    f = rng.rand(L, nx, ny)
    if start:
        u, q, s = 0 * u, 0 * q, 0 * s
    return [a.astype(np.float32) for a in (u, q, s, f)]


def _close(t_out, j_out, n_planes=6):
    for i, (a, b) in enumerate(zip(t_out[:n_planes], j_out[:n_planes])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PLANE_ATOL,
                                   err_msg=f"plane {i}")
    for a, b in zip(t_out[n_planes:], j_out[n_planes:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=NORM_RTOL,
                                   atol=1e-7)


ARGS = (0.9, 1.1, 1.0, 0.5, 1.0)  # tau, sigma, theta, radius, d_s


@pytest.mark.parametrize("ri", [1, 4])
def test_ml_chunk_matches_jax_kernel(ri):
    u, q, s, f = _inputs(ri)
    ref = jml.ml_fused_chunk(*map(jnp.asarray, (u, q, s, f)), *ARGS, ri,
                             interpret=True)
    out = tml.ml_chunk(*map(torch.from_numpy, (u, q, s, f)),
                       torch.tensor(ARGS), ri)
    _close(out, ref)


def _consts(L=L, nx=NX, ny=NY):
    n = nx * ny
    return (float(np.sqrt(2 * n * L + n)), float(np.sqrt(n * L)), 1.5, 0.95,
            1.05, 0.8)


def _scal13(tol):
    return np.array([1.0, 1.0, 1.0, 0.5, 1.0, 0.5, 0.0, 0.0, 1.0,
                     tol, tol, tol, tol], np.float32)


@pytest.mark.parametrize("stepsize", ["boyd", "goldstein"])
def test_ml_multichunk_matches_jax_kernel(stepsize):
    """A solve's start at tolerance 2e-2: both rules adapt, and the launch
    converges partway (boyd in chunk 5, goldstein in chunk 6 of 8)."""
    u, q, s, f = _inputs(7, start=True)
    scal = _scal13(2e-2)
    ref = jml.ml_fused_multichunk(*map(jnp.asarray, (u, q, s, f, scal)), 5,
                                  8, stepsize, _consts(), interpret=True)
    out = tml.ml_multichunk(*map(torch.from_numpy, (u, q, s, f, scal)), 5, 8,
                            stepsize, _consts())
    _close(out, ref)
    # converged flag and executed-chunk count exactly
    assert out[7][5].item() == float(ref[7][5]) == 1.0
    assert out[7][6].item() == float(ref[7][6]) < 8


def test_ml_multichunk_stops_partway():
    """After convergence inside a launch the outputs are those of the last
    executed chunk: a launch of exactly that many chunks gives them too."""
    u, q, s, f = map(torch.from_numpy, _inputs(7, start=True))
    scal = torch.from_numpy(_scal13(2e-2))
    out = tml.ml_multichunk(u, q, s, f, scal, 5, 8, "boyd", _consts())
    done = int(out[7][6])
    assert out[7][5].item() == 1.0 and 1 <= done < 8
    again = tml.ml_multichunk(u, q, s, f, scal, 5, done, "boyd", _consts())
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_converged_at_entry_returns_the_inputs():
    u, q, s, f = map(torch.from_numpy, _inputs(3))
    c = tml.ml_chunk(u, q, s, f, torch.tensor(ARGS + (1.0,)), 5)
    for a, b in zip(c[:6], (u, q, s, u, q, s)):
        assert torch.equal(a, b)
    assert torch.equal(c[6], torch.zeros(4))
    scal = torch.tensor([0.9, 1.1, 1.0, 0.5, 1.0, 0.5, 2.0, 3.0, 11.0,
                         1e-3, 1e-3, 1e-3, 1e-3, 1.0])
    m = tml.ml_multichunk(u, q, s, f, scal, 5, 8, "boyd", _consts())
    for a, b in zip(m[:6], (u, q, s, u, q, s)):
        assert torch.equal(a, b)
    assert m[7].tolist() == pytest.approx([0.9, 1.1, 0.5, 2.0, 3.0, 1.0, 0.0])


def test_wrappers_reject_bad_input():
    u, q, s, f = map(torch.from_numpy, _inputs(1))
    scal = torch.tensor(ARGS)
    with pytest.raises(ptt.ProstError, match="q must be"):
        tml.ml_chunk(u, q[:L], s, f, scal, 3)
    with pytest.raises(ptt.ProstError, match="u must be"):
        tml.ml_chunk(u[0], q, s, f, scal, 3)
    with pytest.raises(ptt.ProstError, match="scal"):
        tml.ml_chunk(u, q, s, f, scal[:4], 3)
    with pytest.raises(ptt.ProstError, match="count"):
        tml.ml_chunk(u, q, s, f, scal, 0)
    with pytest.raises(ptt.ProstError, match="stepsize"):
        tml.ml_multichunk(u, q, s, f, torch.from_numpy(_scal13(0.0)), 3, 8,
                          "alg2", _consts())


# ---------------------------------------------------------------------------
# rows 14 and 16: the JAX package's banded kernels for planes beyond a TPU
# core's VMEM, against the port's one route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("double_buffer", [False, True])
def test_ml_chunk_matches_jax_banded(double_buffer):
    """ml_fused_chunk_banded (2 bands of 32 rows; _ml_banded_kernel, and
    _ml_banded_db_kernel with the double buffer) against the port's
    ml_chunk on the whole plane.  The banded kernels take clean dead dual
    coordinates (their run zeroes them once), as do the JAX tests."""
    u, q, s, f = _inputs(19, nx=64, ny=24)
    q[:L, -1, :] = 0.0
    q[L:, :, -1] = 0.0
    ref = jml.ml_fused_chunk_banded(*map(jnp.asarray, (u, q, s, f)), *ARGS,
                                    4, 2, interpret=True,
                                    double_buffer=double_buffer)
    out = tml.ml_chunk(*map(torch.from_numpy, (u, q, s, f)),
                       torch.tensor(ARGS), 4)
    _close(out, ref)


def ml_problem(mod, nx, ny, L, lmb=0.5, seed=0, scaling="alpha"):
    """The fast multilabel relaxation of examples/example_multilabel_fast.py
    on random unaries, finalized by package ``mod``."""
    n = nx * ny
    f = np.random.RandomState(seed).rand(n * L).astype(np.float32)
    u = mod.Variable(n * L)
    q = mod.Variable(2 * n * L)
    s = mod.Variable(n)
    prob = mod.MinMaxProblem([u], [q, s], scaling=scaling)
    prob.add_function(u, mod.function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(q, mod.function.sum_norm2(2 * L, False, "ind_leq0",
                                                1 / lmb, 1, 1))
    prob.add_function(s, mod.function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, mod.block.sparse_kron_id(np.ones((1, L)), n))
    return prob.finalize(), f


def _sopts(mod, t):
    return mod.SolverOptions(verbose=False, tol_rel_primal=t, tol_rel_dual=t,
                             tol_abs_primal=t, tol_abs_dual=t)


def _assert_runs_agree(ts, js, atol=RUN_ATOL):
    assert int(ts.iteration) == int(js.iteration)
    assert bool(ts.converged) == bool(js.converged)
    for name in ("x", "y", "x_prev", "y_prev", "kx", "kty"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=atol,
                                   err_msg=name)
    np.testing.assert_allclose(float(ts.tau), float(js.tau), rtol=1e-6)


def test_fused_backend_matches_jax_banded_multichunk():
    """JAX FusedROFPDHG forced onto its banded multilabel route (4 bands,
    double buffer: ml_fused_multichunk_banded in phase B0, the
    double-buffered banded chunk in phase B) against the port's whole-plane
    route over 75 iterations of boyd with ri 3 (phases A, B0, B and C)."""
    popts = dict(stepsize="boyd", residual_iter=3, scale_steps_operator=False)
    jb = JFused(ml_problem(pt, 64, 16, L, seed=22)[0], JOptions(**popts),
                _sopts(pt, 1e-5), interpret=True)
    jb.ml["n_bands"] = 4
    jb.ml["double_buffer"] = True
    tb = TFused(ml_problem(ptt, 64, 16, L, seed=22)[0], TOptions(**popts),
                _sopts(ptt, 1e-5))
    js = jb.run(jb.initial_state(), 75)
    ts = tb.run(tb.initial_state(), 75, 0)
    assert int(ts.iteration) == 75
    _assert_runs_agree(ts, js)


# ---------------------------------------------------------------------------
# structure matching and the backend
# ---------------------------------------------------------------------------

def test_match_multilabel_structure_matches_jax():
    jm = jml.match_multilabel_structure(ml_problem(pt, 8, 6, 4, lmb=0.7)[0])
    tm = tml.match_multilabel_structure(ml_problem(ptt, 8, 6, 4, lmb=0.7)[0])
    for k in ("nx", "ny", "L", "radius", "d_s"):
        assert tm[k] == jm[k], k
    np.testing.assert_array_equal(tm["f"].numpy(), np.asarray(jm["f"]))


def _simplex_model(mod, nx, ny, L):
    """Multilabel TV without the kron block (the simplex relaxation's
    linop): not the fast structure."""
    n = nx * ny
    u, q = mod.Variable(n * L), mod.Variable(2 * n * L)
    prob = mod.MinMaxProblem([u], [q])
    prob.add_function(u, mod.function.sum_1d("ind_geq0", 1, 0, 1,
                                             np.ones(n * L), 0))
    prob.add_function(q, mod.function.sum_norm2(2 * L, False, "ind_leq0",
                                                2.0, 1, 1))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, L))
    return prob.finalize()


@pytest.mark.parametrize("case", ["no_kron", "identity_scaling"])
def test_match_rejections_match_jax(case):
    if case == "no_kron":
        probs = [_simplex_model(mod, 6, 5, 3) for mod in (pt, ptt)]
    else:
        probs = [ml_problem(mod, 6, 5, 3, scaling="identity")[0]
                 for mod in (pt, ptt)]
    assert jml.match_multilabel_structure(probs[0]) is None
    assert tml.match_multilabel_structure(probs[1]) is None


def test_match_rejects_float64():
    ptt.set_dtype(torch.float64)
    try:
        assert tml.match_multilabel_structure(
            ml_problem(ptt, 4, 4, 2)[0]) is None
    finally:
        ptt.set_dtype(torch.float32)


@pytest.mark.parametrize("stepsize,ri,t", [("boyd", 5, 1e-5),
                                           ("goldstein", 7, 1e-5)])
def test_fused_backend_matches_jax_fused(stepsize, ri, t):
    """The port's FusedROFPDHG (ml route, plain versions) against the JAX
    FusedROFPDHG (ml route, interpret mode) over 100 iterations: every
    phase of the run (align, multichunk, chunk, epilogue, tail)."""
    popts = dict(stepsize=stepsize, residual_iter=ri,
                 scale_steps_operator=False)
    jb = JFused(ml_problem(pt, NX, NY, L, seed=3)[0], JOptions(**popts),
                _sopts(pt, t), interpret=True)
    tb = TFused(ml_problem(ptt, NX, NY, L, seed=3)[0], TOptions(**popts),
                _sopts(ptt, t))
    assert jb.ml is not None and tb.ml is not None and tb.rof is None
    js = jb.run(jb.initial_state(), 100)
    ts = tb.run(tb.initial_state(), 100, 0)
    _assert_runs_agree(ts, js)
    np.testing.assert_allclose(float(ts.primal_residual),
                               float(js.primal_residual), rtol=1e-3)


def test_fused_backend_matches_generic_to_convergence():
    """Fused (plain versions) vs the port's own generic path on the same
    problem: the same stopping iteration and current solution."""
    prob = ml_problem(ptt, 12, 10, L, lmb=0.4, seed=5)[0]
    opts = TOptions(stepsize="boyd", residual_iter=5,
                    scale_steps_operator=False)
    gb = TBackend(prob, opts, _sopts(ptt, 1e-3))
    fb = TFused(prob, opts, _sopts(ptt, 1e-3))
    gs = gb.run(gb.initial_state(), 2000, 0)
    fs = fb.run(fb.initial_state(), 2000, 0)
    assert bool(fs.converged) and bool(gs.converged)
    assert int(fs.iteration) == int(gs.iteration) < 2000
    for a, b in zip(fb.current_solution(fs), gb.current_solution(gs)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5)


def test_alg2_and_reference_residuals_take_the_generic_path():
    prob = ml_problem(ptt, 6, 5, L)[0]
    assert TFused(prob, TOptions(stepsize="alg2"), _sopts(ptt, 0)).ml is None
    assert TFused(prob, TOptions(reference_residuals=True),
                  _sopts(ptt, 0)).ml is None
    b = TFused(prob, TOptions(), _sopts(ptt, 0))
    assert b.ml is not None and b.rof is None


def test_dirty_dual_warm_start_is_canonicalized():
    """As on the ROF route: mass on the dead dual coordinates of a warm
    start is projected off once per run, and the port agrees with the JAX
    fused route on it."""
    nx, ny = 12, 10
    rng = np.random.RandomState(17)
    y0 = (0.1 * rng.randn(2 * L * nx * ny + nx * ny)).astype(np.float32)
    q = y0[:2 * L * nx * ny].reshape(2 * L, nx, ny)
    q[:L, -1, :] = 1.0
    q[L:, :, -1] = -1.0
    popts = dict(stepsize="boyd", residual_iter=5, scale_steps_operator=False)

    def run(mod, cls, opts, **kw):
        b = cls(ml_problem(mod, nx, ny, L, seed=8)[0], opts, _sopts(mod, 0),
                **kw)
        s = b.initial_state()
        if mod is ptt:
            s = type(s)(**{**vars(s), "y": torch.from_numpy(y0)})
            return b.run(s, 26, 0)
        return b.run(type(s)(**{**vars(s), "y": jnp.asarray(y0)}), 26)

    ts = run(ptt, TFused, TOptions(**popts))
    js = run(pt, JFused, JOptions(**popts), interpret=True)
    np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), atol=RUN_ATOL)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=RUN_ATOL)
    tq = ts.y.numpy()[:2 * L * nx * ny].reshape(2 * L, nx, ny)
    assert np.all(tq[:L, -1, :] == 0.0) and np.all(tq[L:, :, -1] == 0.0)


# ---------------------------------------------------------------------------
# the build: the digest covers the headers a source includes
# ---------------------------------------------------------------------------

def test_source_digest_follows_included_headers(tmp_path):
    """A library is named by the hash of its source and of the csrc
    headers it includes, so an edit of pdhg_chunk.cuh rebuilds both PDHG
    libraries and leaves the ADMM one (which includes cp_async.cuh only)
    alone."""
    for fname in ("fused_rof.cu", "fused_multilabel.cu", "fused_admm.cu",
                  "pdhg_chunk.cuh", "cp_async.cuh"):
        shutil.copy(f"{cuda_build.CSRC}/{fname}", tmp_path / fname)
    names = ("fused_rof", "fused_multilabel", "fused_admm")
    before = {n: cuda_build.source_digest(n, str(tmp_path)) for n in names}
    assert before == {n: cuda_build.source_digest(n) for n in names}
    with open(tmp_path / "pdhg_chunk.cuh", "a") as fh:
        fh.write("// edited\n")
    after = {n: cuda_build.source_digest(n, str(tmp_path)) for n in names}
    assert after["fused_rof"] != before["fused_rof"]
    assert after["fused_multilabel"] != before["fused_multilabel"]
    assert after["fused_admm"] == before["fused_admm"]
