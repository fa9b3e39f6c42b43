#!/usr/bin/env python3
"""Drive prost_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure ends the run with a traceback and a non-zero exit):

1. build the fused ROF kernels from prost_tpu_torch/csrc with nvcc (sm_90a);
2. check each kernel against its plain PyTorch version on the card, on the
   same inputs: ``rof_chunk`` at 512x512 and 2048x1536 for the square,
   wsquare and abs data terms (ri = 10), ``rof_multichunk`` with alg1 and
   boyd (k = 8, ri = 10), and time both versions at 512x512;
3. solve ROF denoising at 512x512 through the modeling API with the fused
   route (boyd, residual_iter = 10), count the kernels' launches in that
   run, and hold its energy against the generic PDHG path on the same card
   and against its own primal-dual gap.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists each kernel with its launches, error and times.
Without a CUDA card the script exits non-zero before printing a result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

# Tolerances of kernel vs plain version on the card.  Both run in f32 with
# the same operations in the same order (the kernels are built with
# -fmad=false); they differ in the ball projection's rsqrt (rsqrtf is
# within 2 ulp, torch.rsqrt may round otherwise), which shifts iterates by
# a few ulp per iteration, and in the order of the norm sums (block tree
# vs torch.sum).
PLANE_ATOL = 2e-5   # iterates and duals are O(1)
NORM_RTOL = 1e-4    # sums of ~3e6 squares in f32
# Fused vs generic PDHG on the same problem: same iteration schedule and
# stopping rule, f32 rounding differs; energies relative.
ENERGY_RTOL = 1e-4
GAP_PER_PX = 1e-4   # primal-dual gap per pixel at the stopping tolerance


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def test_image(nx, ny, seed=42):
    """The procedural ROF test image of bench.py (seed 42, noise 0.05),
    recomputed with numpy: the script reads no image file and needs no
    image library."""
    rng = np.random.RandomState(seed)
    x = np.linspace(0, 1, nx)
    xx, yy = np.meshgrid(x, np.linspace(0, 1, ny), indexing="ij")
    im = 0.4 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.09) + 0.3 * (xx > 0.7)
    return (im + 0.05 * rng.randn(nx, ny)).astype(np.float32)


def kernel_inputs(nx, ny, seed, dev):
    import torch

    rng = np.random.RandomState(seed)
    x = rng.rand(nx, ny).astype(np.float32)
    q = (0.3 * rng.randn(2, nx, ny)).astype(np.float32)
    f = rng.rand(nx, ny).astype(np.float32)
    w = (rng.rand(nx, ny) > 0.3).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, q, f, w)]


def max_errs(out, ref, n_planes=4):
    """Largest abs error over the planes, largest rel error over the rest."""
    import torch

    plane = max(float(torch.max(torch.abs(a - b)))
                for a, b in zip(out[:n_planes], ref[:n_planes]))
    rel = 0.0
    for a, b in zip(out[n_planes:], ref[n_planes:]):
        d = torch.abs(a.double() - b.double())
        rel = max(rel, float(torch.max(d / torch.clamp(torch.abs(b.double()),
                                                        min=1e-30))))
    return plane, rel


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from prost_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.load("fused_rof")
    wall = time.perf_counter() - t0
    print(f"build: fused_rof.cu nvcc {built.seconds:.2f} s, load {wall:.2f} s"
          f" ({built.path}; compiler report beside it)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def phase_kernels(dev):
    import torch

    from prost_tpu_torch.ops import fused_rof as fr

    rows = {"rof_chunk": {"err": 0.0, "ms": None, "plain_ms": None},
            "rof_multichunk": {"err": 0.0, "ms": None, "plain_ms": None}}
    seed = 0
    for nx, ny in ((512, 512), (2048, 1536)):
        for dataterm in ("square", "wsquare", "abs"):
            x, q, f, w = kernel_inputs(nx, ny, seed, dev)
            seed += 1
            q[0, -1, :] = 0.0
            q[1, :, -1] = 0.0
            scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0], device=dev)
            out = fr.rof_chunk(x, q, f, w, scal, 10, dataterm)
            ref = fr.rof_chunk_plain(x, q, f, w, scal, 10, dataterm)
            torch.cuda.synchronize()
            plane, rel = max_errs(out, ref)
            print(f"rof_chunk {nx}x{ny} {dataterm}: max abs err planes "
                  f"{plane:.3e} (tol {PLANE_ATOL:g}), max rel err norms "
                  f"{rel:.3e} (tol {NORM_RTOL:g})")
            check(plane <= PLANE_ATOL and rel <= NORM_RTOL,
                  f"rof_chunk {nx}x{ny} {dataterm} disagrees with its "
                  "plain version")
            check(all(bool(torch.isfinite(t).all()) for t in out),
                  "rof_chunk produced non-finite values")
            rows["rof_chunk"]["err"] = max(rows["rof_chunk"]["err"], plane)
            if (nx, ny) == (512, 512) and dataterm == "square":
                rows["rof_chunk"]["ms"] = time_ms(
                    lambda: fr.rof_chunk(x, q, f, w, scal, 10, dataterm), 50)
                rows["rof_chunk"]["plain_ms"] = time_ms(
                    lambda: fr.rof_chunk_plain(x, q, f, w, scal, 10,
                                               dataterm), 10)

    consts = (np.sqrt(2 * 512 * 512), np.sqrt(512 * 512), 1.5, 0.95, 1.05,
              0.8)
    # a solve's start: x = f = the test image, q = 0; with tolerance 2e-3
    # boyd adapts four times and converges in chunk 7 of 8
    x = torch.from_numpy(test_image(512, 512)).to(dev)
    q = torch.zeros((2, 512, 512), device=dev)
    w = torch.ones_like(x)
    for stepsize, tol in (("alg1", 0.0), ("boyd", 2e-3)):
        scal = torch.tensor([1.0, 1.0, 1.0, 16.0, 1.0, 0.5, 0.0, 0.0, 1.0,
                             tol, tol, tol, tol], device=dev)
        out = fr.rof_multichunk(x, q, x, w, scal, 10, 8, "square", stepsize,
                                consts)
        ref = fr.rof_multichunk_plain(x, q, x, w, scal, 10, 8, "square",
                                      stepsize, consts)
        torch.cuda.synchronize()
        plane, rel = max_errs(out, ref)
        print(f"rof_multichunk 512x512 {stepsize}: max abs err planes "
              f"{plane:.3e} (tol {PLANE_ATOL:g}), max rel err norms+scalars "
              f"{rel:.3e} (tol {NORM_RTOL:g}); sout kernel "
              f"{out[5].tolist()} plain {ref[5].tolist()}")
        check(plane <= PLANE_ATOL and rel <= NORM_RTOL,
              f"rof_multichunk {stepsize} disagrees with its plain version")
        rows["rof_multichunk"]["err"] = max(rows["rof_multichunk"]["err"],
                                            plane)
        if stepsize == "alg1":  # all 8 chunks run
            rows["rof_multichunk"]["ms"] = time_ms(
                lambda: fr.rof_multichunk(x, q, x, w, scal, 10, 8, "square",
                                          stepsize, consts), 20)
            rows["rof_multichunk"]["plain_ms"] = time_ms(
                lambda: fr.rof_multichunk_plain(x, q, x, w, scal, 10, 8,
                                                "square", stepsize, consts),
                3)
    for name, r in rows.items():
        print(f"{name} 512x512: kernel {r['ms']:.4f} ms/call, plain "
              f"{r['plain_ms']:.4f} ms/call")
    return rows


def rof_energy(u, f, lmb, nx, ny):
    """Primal ROF energy lmb/2 ||u - f||^2 + TV(u) in float64."""
    u = u.reshape(nx, ny).astype(np.float64)
    gx = np.zeros_like(u)
    gy = np.zeros_like(u)
    gx[:-1] = u[1:] - u[:-1]
    gy[:, :-1] = u[:, 1:] - u[:, :-1]
    return 0.5 * lmb * np.sum((u - f.reshape(nx, ny)) ** 2) + np.sum(
        np.sqrt(gx ** 2 + gy ** 2))


def rof_dual_energy(y, f, lmb, nx, ny):
    """Dual ROF energy <f, K^T p> - ||K^T p||^2 / (2 lmb) at p = y clipped
    to the unit ball, in float64 (the gap certificate of
    example_rof_pdgap)."""
    p = y.reshape(2, nx, ny).astype(np.float64)
    p = p / np.maximum(np.sqrt(p[0] ** 2 + p[1] ** 2), 1.0)[None]
    ktp = np.zeros((nx, ny))
    ktp[1:] += p[0, :-1]
    ktp[:-1] -= p[0, :-1]
    ktp[:, 1:] += p[1, :, :-1]
    ktp[:, :-1] -= p[1, :, :-1]
    return float(np.sum(f.reshape(nx, ny) * ktp)
                 - np.sum(ktp ** 2) / (2.0 * lmb))


def phase_solve(card):
    import torch

    import prost_tpu_torch as ptt
    from prost_tpu_torch.backend import BackendPDHG, PDHGOptions
    from prost_tpu_torch.modeling import Backend
    from prost_tpu_torch.ops import fused_rof as fr

    nx = ny = 512
    n = nx * ny
    lmb = 16.0
    f = test_image(nx, ny).reshape(-1)

    def model():
        u = ptt.Variable(n)
        q = ptt.Variable(2 * n)
        prob = ptt.MinMaxProblem([u], [q])
        prob.add_function(u, ptt.function.sum_1d("square", 1, f, lmb))
        prob.add_function(q, ptt.function.conjugate(
            ptt.function.sum_norm2(2, False, "abs")))
        prob.add_dual_pair(u, q, ptt.block.gradient2d(nx, ny, 1))
        return prob

    tol = 1e-5

    def opts(max_iters):
        return ptt.options(max_iters=max_iters, num_cback_calls=10,
                           verbose=False, tol_rel_primal=tol,
                           tol_rel_dual=tol, tol_abs_primal=tol,
                           tol_abs_dual=tol)

    @dataclasses.dataclass
    class Recorded(Backend):
        """``backend_pdhg`` as a user gets it (or, with ``generic``, the
        plain BackendPDHG), recording after every callback epoch the
        devices of the solver state and the time spent iterating."""

        generic: bool = False

        def create(self, problem, solver_opts):
            if self.generic:
                b = BackendPDHG(problem, self.opts, solver_opts)
            else:
                b = super().create(problem, solver_opts)
            self.made, self.devices, self.loop_s = b, set(), 0.0
            run = b.run

            def run_and_record(state, until, start):
                t0 = time.perf_counter()
                state = run(state, until, start)
                torch.cuda.synchronize()
                self.loop_s += time.perf_counter() - t0
                self.devices |= {getattr(state, k).device.type
                                 for k in ("x", "y", "x_prev", "y_prev")}
                return state

            b.run = run_and_record
            return b

    def run(generic, max_iters):
        backend = Recorded("pdhg", PDHGOptions(stepsize="boyd",
                                                residual_iter=10), generic)
        prob = model()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ptt.solve(prob, backend, opts(max_iters))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(backend.devices == {"cuda"},
              f"the solver state left the card: {backend.devices}")
        return res, backend, dt

    run(False, 200)  # warm-up of both routes
    run(True, 20)

    fr.reset_launch_counts()
    res, backend, dt = run(False, 2000)
    launches = dict(fr.launch_counts)
    check(backend.made.rof is not None, "the fused route was not taken")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was not launched: {launches}")
    check(res.x.shape == (n,) and np.all(np.isfinite(res.x))
          and np.all(np.isfinite(res.y)), "non-finite or misshapen result")
    e_fused = rof_energy(res.x, f, lmb, nx, ny)
    gap = (e_fused - rof_dual_energy(res.y, f, lmb, nx, ny)) / n
    loop = backend.loop_s
    print(f"fused solve 512x512: {res.result.value} after {res.iterations} "
          f"iterations; solve() {dt:.4f} s with set-up, iterating "
          f"{loop:.4f} s = {res.iterations / loop:.1f} it/s; energy "
          f"{e_fused:.8f}, gap/px {gap:.3e} (tol {GAP_PER_PX:g}), launches "
          f"{launches} [{card}]")

    gres, gbackend, gdt = run(True, 2000)
    e_gen = rof_energy(gres.x, f, lmb, nx, ny)
    rel = abs(e_fused - e_gen) / abs(e_gen)
    gloop = gbackend.loop_s
    print(f"generic solve 512x512: {gres.result.value} after "
          f"{gres.iterations} iterations; solve() {gdt:.4f} s with set-up, "
          f"iterating {gloop:.4f} s = {gres.iterations / gloop:.1f} it/s; "
          f"energy {e_gen:.8f} [{card}]")
    print(f"energy fused vs generic: rel diff {rel:.3e} "
          f"(tol {ENERGY_RTOL:g})")
    check(rel <= ENERGY_RTOL, "fused and generic energies disagree")
    check(0.0 <= gap <= GAP_PER_PX, "primal-dual gap too large")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import prost_tpu_torch as ptt

    check("jax" not in sys.modules, "jax was imported")
    ptt.set_device("cuda:0")
    dev = ptt.device()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase_build()
    rows = phase_kernels(dev)
    torch.cuda.synchronize()
    launches = phase_solve(card)
    check("jax" not in sys.modules, "jax was imported")

    replaces = {"rof_chunk": "prost_tpu/ops/fused_rof.py:459",
                "rof_multichunk": "prost_tpu/ops/fused_rof.py:338"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "prost_tpu_torch/csrc/fused_rof.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": rows[name]["err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"]}
        for name in ("rof_chunk", "rof_multichunk")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
