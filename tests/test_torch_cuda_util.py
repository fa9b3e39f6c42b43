"""The wire format, checkpoints, profiling helpers, entry point and an
example on the card.

Every test here is marked ``cuda`` and skips without a CUDA card.  The
file imports torch and the port only, so it also runs where JAX is not
installed (without the suite's conftest):

    python -m pytest --noconftest tests/test_torch_cuda_util.py -q
"""

import json
import os

import numpy as np
import pytest
import torch

import prost_tpu_torch as ptt
from prost_tpu_torch.modeling import wire

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ptt.set_device("cuda:0")  # the default on a host with a card
    return torch.device("cuda", 0)


def _rof(nx, ny, lmb=16.0):
    from prost_tpu_torch import block, function

    n = nx * ny
    f = np.random.RandomState(0).rand(n)
    u, q = ptt.Variable(n), ptt.Variable(2 * n)
    prob = ptt.MinMaxProblem([u], [q])
    prob.add_function(u, function.sum_1d("square", 1, f, lmb))
    prob.add_function(q, function.conjugate(function.sum_norm2(2, False,
                                                               "abs")))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, 1))
    return prob.finalize()


def test_wire_round_trip_keeps_the_fused_route(dev):
    """Config 1's model through JSON and back on the card: the rebuilt
    problem lies on the card, takes the ROF route and runs it bit for bit
    as the original does."""
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.ops import FusedROFPDHG

    prob = _rof(128, 128)
    rebuilt = wire.from_spec(json.loads(json.dumps(wire.to_spec(prob))))
    assert rebuilt.scaling_left.device.type == "cuda"
    assert torch.equal(rebuilt.scaling_left, prob.scaling_left)
    opts = PDHGOptions(stepsize="boyd", residual_iter=10)
    states = []
    for p in (prob, rebuilt):
        b = FusedROFPDHG(p, opts, ptt.SolverOptions(verbose=False))
        assert b.rof is not None
        states.append(b.run(b.initial_state(), 205, 0))
    for k in vars(states[0]):
        assert torch.equal(getattr(states[0], k), getattr(states[1], k)), k


def test_checkpoint_crosses_card_and_cpu(dev, tmp_path):
    """A state saved on the card loads on the CPU and back, bit for bit,
    and the resumed run on the card equals the straight run."""
    from prost_tpu_torch.backend import BackendPDHG, PDHGOptions
    from prost_tpu_torch.common import tree_to
    from prost_tpu_torch.util import load_state, save_state

    b = BackendPDHG(_rof(32, 32), PDHGOptions(scale_steps_operator=False),
                    ptt.SolverOptions(verbose=False))
    state = b.run(b.initial_state(), 50, 0)
    path = str(tmp_path / "card.npz")
    save_state(path, state)
    like_cpu = tree_to(b.initial_state(), torch.device("cpu"))
    on_cpu = load_state(path, like_cpu)
    for k in vars(state):
        assert getattr(on_cpu, k).device.type == "cpu"
        assert torch.equal(getattr(on_cpu, k), getattr(state, k).cpu()), k
    save_state(str(tmp_path / "cpu.npz"), on_cpu)
    back = load_state(str(tmp_path / "cpu.npz"), b.initial_state())
    resumed = b.run(back, 100, int(back.iteration))
    straight = b.run(b.initial_state(), 100, 0)
    for k in vars(resumed):
        assert getattr(resumed, k).device.type == "cuda"
        assert torch.equal(getattr(resumed, k), getattr(straight, k)), k


def test_profiling_helpers_on_the_card(dev, tmp_path):
    from prost_tpu_torch.util import (compiled_memory_analysis,
                                      memory_stats, timed, trace)

    x = torch.ones(1 << 20, device=dev)
    out, ms = timed(lambda v: v * 2.0, x, repeats=10)
    assert out.device.type == "cuda" and ms > 0
    stats = memory_stats()
    assert stats["bytes_in_use"] >= x.numel() * 4
    assert stats["bytes_limit"] >= stats["bytes_reserved"] > 0
    mem = compiled_memory_analysis(lambda v: (v * 2.0).sum(), x)
    assert mem["argument_size_in_bytes"] == x.numel() * 4
    assert mem["output_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] >= x.numel() * 4  # the product
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"]
    assert mem["generated_code_size_in_bytes"] == 0
    with trace(str(tmp_path)):
        (x * 3.0).sum().item()
    with open(os.path.join(tmp_path, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


def test_entry_step_on_the_card(dev):
    from prost_tpu_torch.entry import _build_rof, entry

    fn, (state,) = entry()
    assert state.x.device.type == "cuda"
    backend = _build_rof(128, 128)
    out, ref = fn(state), backend.generic_step(backend.initial_state(), 0)
    for k in vars(out):
        assert torch.equal(getattr(out, k), getattr(ref, k)), k


def test_example_takes_the_rof_route_on_the_card(dev):
    from prost_tpu_torch.examples.example_rof_primaldual import run

    out = run(size=64, max_iters=10000, gap_tol=1e-5, verbose=False)
    assert out["route"] == "FusedROFPDHG:rof"
    assert out["gap_per_px"] < 1e-5
