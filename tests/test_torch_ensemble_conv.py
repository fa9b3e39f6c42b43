"""Port parity for slice 7b: deblur and tight ensembles in prost_tpu_torch
against prost_tpu (``BatchedPDHG``'s last two fused routes).

* the batched deblur and tight chunks' plain versions (what a CPU tensor
  runs) against the JAX batched kernels in Pallas interpret mode, f32, per
  instance with the tolerances of the single-instance parity tests
  (tests/test_torch_deblur.py, tests/test_torch_tight.py): planes within
  2e-5 times max(1, |plane|max), the blur dual scaling with lmb; norms
  within 1e-4 relative with a floor of 1e-4 of the instance's largest
  norm, the deblur dual variable norm being zero in exact arithmetic.  The
  JAX deblur kernel works on planes embedded in the (nx2, ny2) geometry:
  its x and q outputs are cropped, and their padding is asserted zero
  first, so that the crop hides no difference;
* ``BatchedPDHG``'s fused deblur and tight routes against the JAX
  ``BatchedPDHG(interpret=True)`` on tests/test_parallel.py's setups: the
  route each takes, x and y within 2e-5 and ``current_solution`` within
  5e-5 (the ROF, ml and vol routes' bars in tests/test_torch_ensemble.py)
  times max(1, |vector|max), since the blur dual scales with lmb (up to 50
  here, |y| about 20), tau 1e-6 relative; and the state hand-over between
  two runs (tests/test_parallel.py's 5e-6, scaled the same way).

The matching of mismatched ensembles and each instance of a batched chunk
against the single-instance chunk are in tests/test_torch_ensemble.py; the
CUDA kernels are held against the plain versions, and each instance
against the single-instance kernel, on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.ops import fused_deblur as jd
from prost_tpu.ops import fused_tight as jt
from prost_tpu_torch.ops import fused_deblur as td
from prost_tpu_torch.ops import fused_tight as tt
from prost_tpu_torch.parallel.ensemble import ROUTE_NAMES
from test_torch_deblur import _close as deblur_close
from test_torch_deblur import asym_kernel, deblur_model
from test_torch_ensemble import (RUN_ATOL, SOL_ATOL, _assert_states,
                                 _batched, _run)
from test_torch_tight import _close as tight_close
from test_torch_tight import tight_model

# tests/test_parallel.py::test_batched_fused_deblur_repeated_run's bar,
# scaled as the route's
HANDOVER_ATOL = 5e-6


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _instance(out, b, n_planes):
    """Instance b of a batched chunk's outputs, as a single chunk's."""
    return [o[b] for o in out[:n_planes]] + [out[n_planes][:, b]]


def _scal(rng, B, a, b):
    """(5, B) rows: per-instance tau, sigma, theta 1, and the family's two
    scalars around ``a`` and ``b``."""
    return np.stack([0.8 + 0.2 * rng.rand(B), 0.9 + 0.3 * rng.rand(B),
                     np.ones(B), a * (0.5 + rng.rand(B)),
                     b * (0.5 + rng.rand(B))]).astype(np.float32)


# ---------------------------------------------------------------------------
# the batched chunks' plain versions against the JAX batched kernels
# ---------------------------------------------------------------------------

def test_deblur_chunk_batched_matches_jax_kernel():
    """Row 18: deblur_fused_chunk_batched on three ragged 10x9 frames with
    the asymmetric 5x5 blur (nx2 - nx = ny2 - ny = 4, the taps reaching
    rows and columns unevenly), each frame with its own steps, lmb and
    radius; the JAX kernel on embedded planes, the port's on its own
    layout."""
    B, nx, ny, ri = 3, 10, 9, 4
    kernel = asym_kernel()
    taps = td.kernel_taps(torch.as_tensor(kernel.T, dtype=torch.float32))
    nx2, ny2 = nx + kernel.shape[1] - 1, ny + kernel.shape[0] - 1
    rng = np.random.RandomState(21)
    arrs = [a.astype(np.float32) for a in (
        rng.rand(B, nx, ny), rng.randn(B, nx2, ny2),
        0.3 * rng.randn(B, 2, nx, ny), rng.rand(B, nx2, ny2),
        0.5 + rng.rand(B, nx2, ny2))]
    x, yv, q, fb, sv = arrs
    scal = _scal(rng, B, 40.0, 1.0)
    pad = ((0, 0), (0, nx2 - nx), (0, ny2 - ny))
    ref = jd.deblur_fused_chunk_batched(
        jnp.asarray(np.pad(x, pad)), jnp.asarray(yv),
        jnp.asarray(np.pad(q, ((0, 0),) + pad)), jnp.asarray(fb),
        jnp.asarray(sv), jnp.asarray(scal), ri, nx, ny, taps, 0.5, 0.2,
        interpret=True)
    out = td.deblur_chunk_batched(*map(torch.from_numpy, arrs),
                                  torch.from_numpy(scal), ri, taps, 0.5, 0.2)
    assert out[6].shape == (4, B)
    for b in range(B):  # deblur_close crops x and q, asserting zero padding
        deblur_close(_instance(out, b, 6), _instance(ref, b, 6), nx, ny)


def test_tight_chunk_batched_matches_jax_kernel():
    """Row 21: tight_fused_chunk_batched at (B, L, nx, ny) = (3, 3, 7, 6),
    the taps and preconditioner constants of the example's model, each
    instance with its own unaries, steps, radius and d_s."""
    B, L, nx, ny, ri = 3, 3, 7, 6, 4
    k = L * (L - 1) // 2
    m = tt.match_tight_structure(tight_model(ptt, nx, ny, L)[0].finalize())
    assert m is not None and m["k"] == k
    rng = np.random.RandomState(22)
    arrs = [a.astype(np.float32) for a in (
        rng.rand(B, L, nx, ny), 0.1 * rng.randn(B, 2 * k, nx, ny),
        0.2 * rng.randn(B, 2 * L, nx, ny), 0.1 * rng.randn(B, 2 * k, nx, ny),
        0.1 * rng.randn(B, nx, ny), rng.rand(B, L, nx, ny))]
    scal = _scal(rng, B, m["radius"], 1.0)
    new, prev, norms = jt.tight_fused_chunk_batched(
        *map(jnp.asarray, arrs), jnp.asarray(scal), ri, m["taps"],
        m["consts"], interpret=True)
    out = tt.tight_chunk_batched(*map(torch.from_numpy, arrs),
                                 torch.from_numpy(scal), ri, m["taps"],
                                 m["consts"])
    assert out[10].shape == (4, B)
    for b in range(B):
        tight_close(_instance(out, b, 10), [a[b] for a in new],
                    [a[b] for a in prev], np.asarray(norms)[:, b])


# ---------------------------------------------------------------------------
# BatchedPDHG's fused deblur and tight routes against the JAX package's
# ---------------------------------------------------------------------------

def parallel_deblur_probs(mod):
    """tests/test_parallel.py's deblur ensemble: three 12x12 frames of one
    5x5 blur, each its own observation, lmb 20, 35, 50."""
    nx = ny = 12
    probs = []
    for seed, lmb in enumerate((20.0, 35.0, 50.0)):
        rng = np.random.RandomState(seed)
        rng.rand(nx * ny)  # the clean image it draws first
        fb = rng.rand((nx + 4) * (ny + 4))
        probs.append(deblur_model(mod, nx, ny, asym_kernel(), lmb=lmb,
                                  fb=fb)[0].finalize())
    return probs


def parallel_tight_probs(mod):
    """tests/test_parallel.py's tight ensemble: three 12x12 instances with
    3 labels, each its own unaries."""
    return [tight_model(mod, 12, 12, L=3, seed=i)[0].finalize()
            for i in range(3)]


# (problems, residual_iter, iterations) of tests/test_parallel.py
CONV = {"deblur": (parallel_deblur_probs, 5, 31),
        "tight": (parallel_tight_probs, 5, 31)}


@pytest.mark.parametrize("family", ["deblur", "tight"])
def test_deblur_tight_route_matches_jax_fused(family):
    """The port's fused batched deblur or tight route (the plain versions
    on the CPU) against the JAX BatchedPDHG in interpret mode: the route
    each takes, iterates, steps and current_solution."""
    build, ri, until = CONV[family]
    tb, jb = _batched(ptt, build(ptt), ri), _batched(pt, build(pt), ri)
    for name in ROUTE_NAMES:
        assert (getattr(tb, name) is not None) == (name == family)
        assert (getattr(jb, name) is not None) == (name == family)
    ts, js = _run(tb, until), _run(jb, until)
    np.testing.assert_array_equal(ts.iteration.numpy(), until)
    _assert_states(ts, js, RUN_ATOL, fields=())
    pairs = [(getattr(ts, k), getattr(js, k), RUN_ATOL) for k in ("x", "y")]
    pairs += [(a, b, SOL_ATOL) for a, b in zip(tb.current_solution(ts),
                                               jb.current_solution(js))]
    for i, (a, b, atol) in enumerate(pairs):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, err_msg=str(i),
                                   atol=atol * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("family", ["deblur", "tight"])
def test_state_hand_over_between_runs(family):
    """tests/test_parallel.py::test_batched_fused_deblur_repeated_run in the
    port, for both routes: 15 then 15 more iterations in a second call
    (which starts with a generic step to realign its chunks) end where one
    run of 30 does."""
    build, ri, _ = CONV[family]
    once = _batched(ptt, build(ptt), ri)
    s30 = _run(once, 30)
    two = _batched(ptt, build(ptt), ri)
    s = two.run(_run(two, 15), 30, 15)
    assert getattr(once, family) is not None
    assert s.iteration.tolist() == s30.iteration.tolist() == [30] * 3
    for name in ("x", "y", "x_prev", "y_prev"):
        ref = getattr(s30, name).numpy()
        np.testing.assert_allclose(
            getattr(s, name).numpy(), ref, rtol=0, err_msg=name,
            atol=HANDOVER_ATOL * max(1.0, np.abs(ref).max()))
