"""Port parity: the deblurring, multilabel, volumetric and ensemble
examples of prost_tpu_torch.examples against the JAX package's
examples/, at the sizes tests/test_examples.py runs them, and the
examples' image helpers against PIL.

As in test_torch_examples.py: the JAX example's ``run()`` beside the
port's with the same arguments, the port's route, its energies or
measures within ENERGY_RTOL of the JAX example's and its iterates within
U_ATOL, and the invariant tests/test_examples.py holds the JAX example to
(the same oracles and bounds)."""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import prost_tpu_torch as ptt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))

ENERGY_RTOL = 2e-6
U_ATOL = 5e-4


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def both(name, **kw):
    """(JAX example's output, port example's output) of ``run(**kw)``."""
    import importlib

    jax_ex = importlib.import_module(name)
    port_ex = importlib.import_module(f"prost_tpu_torch.examples.{name}")
    return jax_ex.run(verbose=False, **kw), port_ex.run(verbose=False, **kw)


def _grad(n_side, L=1):
    from prost_tpu_torch.examples.example_rof_dual import spmat_gradient2d

    return sp.csr_matrix(spmat_gradient2d(n_side, n_side, L))


def test_deblurring_energy_matches_oracle():
    from prost_tpu_torch.examples.example_deblurring import convmtx2
    from oracles import deblur_energy, graph_admm

    size = 16
    n = size * size
    jo, to = both("example_deblurring", size=size, max_iters=25000)
    assert to["route"] == "FusedROFPDHG:deblur"
    assert abs(to["energy"] - jo["energy"]) <= ENERGY_RTOL * jo["energy"]
    np.testing.assert_allclose(to["u"], jo["u"], atol=U_ATOL)
    u, fb, lmb = (np.asarray(to["u"], np.float64), to["f_blurred"],
                  to["lmb"])
    assert np.all(np.isfinite(u))
    B, ny2, nx2 = convmtx2(to["kernel"], size, size)
    B = sp.csr_matrix(B)
    K = _grad(size)
    KK = sp.vstack([B, K]).tocsr()
    m2 = ny2 * nx2

    def prox_f(v, t):
        o = v.copy()
        c = t * lmb
        o[:m2] = (v[:m2] + c * fb) / (1.0 + c)
        blk = v[m2:].reshape(2, n)
        nrm = np.sqrt((blk ** 2).sum(axis=0))
        s_ = np.maximum(1.0 - t / np.maximum(nrm, 1e-300), 0.0)
        o[m2:] = (blk * s_[None, :]).reshape(-1)
        return o

    u_star, _ = graph_admm(KK, lambda v, t: v, prox_f,
                           iters=20000, tol=1e-11)
    e_opt = deblur_energy(B, K, u_star, fb, lmb, n)
    e_our = deblur_energy(B, K, u, fb, lmb, n)
    assert e_our - e_opt <= 2e-3 * (1.0 + e_opt)
    assert e_our >= e_opt - 1e-4 * e_opt


def test_multilabel_fast_energy_matches_oracle():
    from oracles import (graph_admm, multilabel_energy, prox_group_l2,
                         prox_simplex_linear)

    size, L = 12, 4
    n = size * size
    jo, to = both("example_multilabel_fast", size=size, L=L,
                  max_iters=20000)
    assert to["route"] == "FusedROFPDHG:ml"
    np.testing.assert_allclose(to["u"], jo["u"], atol=U_ATOL)
    np.testing.assert_allclose(to["labels"].sum(axis=0), 1.0, atol=5e-2)
    assert to["labels"].min() > -1e-2

    u = np.asarray(to["u"], np.float64)
    f, lmb = to["f"], to["lmb"]
    K = _grad(size, L)
    u1, _ = graph_admm(K, prox_simplex_linear(f, L, n),
                       prox_group_l2((2 * L, n), weight=lmb))
    e1 = multilabel_energy(K, u1, f, lmb, L, n)
    e_our = multilabel_energy(K, u, f, lmb, L, n)
    e_jax = multilabel_energy(K, np.asarray(jo["u"], np.float64), f, lmb,
                              L, n)
    assert abs(e_our - e_jax) <= ENERGY_RTOL * (1.0 + abs(e_jax))
    assert e_our - e1 <= 1e-3 * (1.0 + abs(e1))
    assert e_our >= e1 - 1e-4 * (1.0 + abs(e1))


def test_multilabel_tight_partition_and_energy():
    """The tight relaxation's partition of unity, its constraint rows and
    its energy against the f64 graph-ADMM oracle (tests/test_examples.py's
    min form)."""
    from oracles import graph_admm

    size, L = 12, 3
    n = size * size
    k = L * (L - 1) // 2
    nk = n * k
    jo, to = both("example_multilabel_tight", size=size, L=L,
                  max_iters=20000)
    assert to["route"] == "FusedROFPDHG:tight"
    np.testing.assert_allclose(to["u"], jo["u"], atol=U_ATOL)
    np.testing.assert_allclose(to["labels"].sum(axis=0), 1.0, atol=5e-2)
    np.testing.assert_array_equal(to["P"], jo["P"])

    u, v, f, lmb, P = (np.asarray(to["u"], np.float64),
                       np.asarray(to["v"], np.float64),
                       np.asarray(to["f"], np.float64), to["lmb"], to["P"])
    G = _grad(size, L)
    KPI = sp.kron(sp.csr_matrix(P.T), sp.eye(n))
    KK = sp.vstack([sp.hstack([G, KPI]),
                    sp.hstack([sp.csr_matrix((2 * nk, n * L)),
                               sp.eye(2 * nk)]),
                    sp.hstack([sp.kron(np.ones((1, L)), sp.eye(n)),
                               sp.csr_matrix((n, 2 * nk))])]).tocsr()
    m_q = 2 * n * L

    def prox_g(z, t):
        o = z.copy()
        o[:n * L] = np.maximum(z[:n * L] - t * f, 0.0)
        return o

    def prox_f(z, t):
        o = np.empty_like(z)
        o[:m_q] = 0.0
        blk = z[m_q:m_q + 2 * nk].reshape(2, nk)
        nrm = np.sqrt((blk ** 2).sum(axis=0))
        sc = np.maximum(1.0 - t * lmb / np.maximum(nrm, 1e-300), 0.0)
        o[m_q:m_q + 2 * nk] = (blk * sc[None, :]).reshape(-1)
        o[m_q + 2 * nk:] = 1.0
        return o

    def energy(uu, vv):
        blk = vv.reshape(2, nk)
        return uu @ f + lmb * np.sqrt((blk ** 2).sum(axis=0)).sum()

    x1, _ = graph_admm(KK, prox_g, prox_f, iters=20000, tol=1e-11)
    e1 = energy(x1[:n * L], x1[n * L:])
    assert np.abs(G @ u + KPI @ v).max() <= 5e-3
    e_our = energy(u, v)
    assert e_our - e1 <= 2e-3 * (1.0 + abs(e1))
    assert e_our >= e1 - 1e-3 * (1.0 + abs(e1))


def test_vol_tv_example_denoises():
    jo, to = both("example_vol_tv", size=32, L=4, max_iters=3000)
    assert to["route"] == "FusedROFPDHG:vol"
    assert to["noise_out"] < 0.75 * to["noise_in"]
    assert to["noise_in"] == jo["noise_in"]
    assert abs(to["noise_out"] - jo["noise_out"]) <= 1e-5 * jo["noise_out"]
    np.testing.assert_allclose(to["u"], jo["u"], atol=U_ATOL)
    assert to["result"] is not None


def test_ensemble_matches_jax():
    jo, to = both("example_ensemble", size=16, batch=8, iters=50)
    assert to["route"] == "BatchedPDHG:rof"
    assert to["throughput"] > 0 and to["devices"] == 1
    assert to["x"].shape == (8, 256) and np.isfinite(to["x"]).all()
    np.testing.assert_allclose(to["x"], jo["x"], atol=1e-5)


def test_multilabel_callback_panels(tmp_path):
    """The callback's epochs, violations and panels are the JAX example's;
    the port writes the panels as PNGs that read back bit for bit."""
    from PIL import Image

    from prost_tpu_torch.examples._common import read_png_rgb

    kw = dict(size=16, L=4, max_iters=400, image="cow",
              stop_at_violation=1e-3)
    jo, to = both("example_multilabel_callback", **kw)
    assert to["route"] == "FusedROFPDHG:ml"
    assert to["iterations"] == jo["iterations"]
    assert [it for it, _ in to["panels"]] == [it for it, _ in jo["panels"]]
    for (_, tp), (_, jp) in zip(to["panels"], jo["panels"]):
        np.testing.assert_array_equal(tp[:, :16], jp[:, :16])  # the input
    from prost_tpu_torch.examples.example_multilabel_callback import run

    out_dir = tmp_path / "panels"
    out = run(verbose=False, out_dir=str(out_dir), **kw)
    names = sorted(os.listdir(out_dir))
    assert names == [f"iter_{it:06d}.png" for it, _ in out["panels"]]
    for name, (_, panel) in zip(names, out["panels"]):
        want = (np.clip(panel, 0, 1) * 255 + 0.5).astype(np.uint8)
        path = str(out_dir / name)
        np.testing.assert_array_equal(read_png_rgb(path)[..., 0], want)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want)


@pytest.mark.parametrize("name,size,gray", [
    ("lion", 128, True), ("cow", 64, True), ("junction_gray", 48, True),
    ("maske2", (24, 31), True), ("flowers", 16, True), ("dog", 40, False),
    ("junction_gray", 20, False), ("house", None, True)])
def test_fixture_images_match_the_jax_examples(name, size, gray):
    """The port's numpy reader and resize give the JAX examples' PIL
    images bit for bit, gray and RGB."""
    from _common import load_fixture_image as jax_load

    from prost_tpu_torch.examples._common import load_fixture_image

    want = jax_load(name, size=size, gray=gray)
    got = load_fixture_image(name, size=size, gray=gray)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_write_png_round_trips(tmp_path):
    from PIL import Image

    from prost_tpu_torch.examples._common import read_png_rgb, write_png

    rng = np.random.RandomState(0)
    for shape in ((7, 5), (6, 9, 3)):
        img = rng.randint(0, 256, size=shape).astype(np.uint8)
        path = str(tmp_path / f"img{len(shape)}.png")
        write_png(path, img)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
        back = read_png_rgb(path)
        np.testing.assert_array_equal(back.reshape(img.shape), img)
