"""Port parity: prost_tpu_torch.entry (``entry``, ``dryrun_multichip``)
against the JAX package's ``__graft_entry__.py``, and the API pages of
prost_tpu_torch.docs.

``entry()``'s step is the JAX ``pdhg_step`` on the same state (f64,
within 1e-12); ``dryrun_multichip`` runs every step on two gloo ranks."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu_torch import interop
from prost_tpu_torch.config import ProstError


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


def test_entry_step_matches_jax_pdhg_step(x64):
    import __graft_entry__ as graft

    from prost_tpu_torch.entry import entry

    jfn, (jstate,) = graft.entry()
    tfn, (tstate,) = entry()
    assert tstate.x.shape == (128 * 128,)
    for _ in range(3):  # three steps from the same initial state
        jstate, tstate = jfn(jstate), tfn(tstate)
        got = interop.pdhg_state_to_numpy(tstate)
        for k, v in got.items():
            np.testing.assert_allclose(v, np.asarray(getattr(jstate, k)),
                                       rtol=1e-12, atol=1e-12, err_msg=k)
    assert int(tstate.iteration) == 3


def test_entry_step_is_one_generic_step():
    from prost_tpu_torch.entry import _build_rof, entry

    fn, (state,) = entry()
    backend = _build_rof(128, 128)
    out, ref = fn(state), backend.generic_step(backend.initial_state(), 0)
    for k in vars(out):
        assert torch.equal(getattr(out, k), getattr(ref, k)), k


def test_dryrun_multichip_on_two_gloo_ranks():
    from prost_tpu_torch.entry import dryrun_multichip

    steps = {"dp generic": 2, "dp fused rof": 5, "sp generic": 2,
             "sp halo rof": 5, "fused admm": 4, "sp halo admm": 4,
             "sp halo vol": 5, "dp fused tight": 5, "dp fused vol": 5}
    assert dryrun_multichip(2, device="cpu") == [steps, steps]


def test_dryrun_multichip_needs_its_cards():
    from prost_tpu_torch.entry import dryrun_multichip

    if torch.cuda.device_count() >= 1:
        pytest.skip("this host has a card")
    with pytest.raises(ProstError, match="CUDA cards"):
        dryrun_multichip(1)


def test_write_api_writes_a_page_per_public_module(tmp_path):
    from prost_tpu_torch.docs import public_modules, write_api

    pages = write_api(str(tmp_path))
    mods = public_modules()
    assert pages == [m.replace(".", "_") + ".md" for m in mods]
    assert sorted(os.listdir(tmp_path)) == sorted(pages + ["index.md"])
    for m in ("prost_tpu_torch.modeling.wire", "prost_tpu_torch.util",
              "prost_tpu_torch.util.checkpoint", "prost_tpu_torch.entry",
              "prost_tpu_torch.docs", "prost_tpu_torch.ops.fused_rof",
              "prost_tpu_torch.examples.example_rof_primaldual"):
        assert m in mods
    assert not any("._" in m for m in mods)
    wire = (tmp_path / "prost_tpu_torch_modeling_wire.md").read_text()
    assert "### `to_spec(problem" in wire and "## Functions" in wire
    index = (tmp_path / "index.md").read_text()
    assert all(f"({p})" in index for p in pages)
