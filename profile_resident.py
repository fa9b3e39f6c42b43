#!/usr/bin/env python3
"""Where the time of the grid-resident ADMM multichunk goes, on one card.

    python3 profile_resident.py [name=path/to/fused_admm.cu ...]

Builds ``csrc/fused_admm.cu`` (and any other source of the same interface
named on the command line) with the package's nvcc flags into
``prost_tpu_torch/_build/profile_resident/``, and from the same source
variants that leave parts of the resident iteration out (``band_iterations``,
which ``admm_multichunk_resident`` runs),
for timing only (their results differ): the stages' grid barriers
(``no_barrier``), the neighbour rows' exchange (``no_exchange``), both
(``compute``), and on top of both one kind of stage's pixel work
(``compute_no_update``, ``_steps``, ``_rhs``, ``_init``).  Each runs the
multichunk at config 4's shape (512x512, Chebyshev degree 10, ri 10, 8
chunks, every chunk run) from the same random state, timed with CUDA
events over 20 launches at count 10 and at count 1, every library twice
in turns (a, b, ..., b, a); an iteration's time is the difference over
the 72 iterations between them.  The committed source and every other
full source are checked bit for bit against the launch sequence
(``admm_multichunk_`` with ``path="streaming"``).  The last line of
standard output is one JSON object of the times; the line before it the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
NX = NY = 512
DEGREE, RI, CHUNKS, REPS = 10, 10, 8, 20

# the iteration loop of the resident kernels (band_iterations), whose
# barriers and exchanges the variants compile out, and the end of its body
_LOOP = ("  for (int it = 0; it < count; ++it) {", "\n}\n")
_SWITCHES = """
#ifdef NO_BARRIER
#define STAGE_SYNC() __syncthreads()
#else
#define STAGE_SYNC() grid.sync()
#endif
#ifdef NO_EXCHANGE
#define XCOPY_SET(...) ((void)0)
#else
#define XCOPY_SET(...) copy_row_set(__VA_ARGS__)
#endif
"""
# one kind of stage's pixel work, and the statement that does it
_STAGES = {
    "update": "FOR_ROWS(lo, hi, ny, i, j) update_at(",
    "steps": "for_groups(lo, hi, ny,\n                   [&](int i, int j) {\n"
             "                     return cheby_step_val(",
    "rhs": "FOR_ROWS(lo, hi, ny, i, j) rhs_at(",
    "init": "for_groups(lo, hi, ny,\n               [&](int i, int j) { "
            "return cheby_init_val(",
}


def variant_source(text: str, defines=(), skip=None) -> str:
    """``text`` (csrc/fused_admm.cu) with its iteration loop's stage
    barriers and exchanges behind the switches, ``defines`` set, and with
    ``skip`` one of _STAGES' statements not run."""
    k = text.index("void band_iterations(")
    a = text.index(_LOOP[0], k)
    b = text.index(_LOOP[1], a)
    loop = text[a:b].replace("grid.sync();", "STAGE_SYNC();")
    loop = loop.replace("copy_row_set(", "XCOPY_SET(")
    if skip is not None:
        if _STAGES[skip] not in loop:
            raise SystemExit(f"profile_resident: no {skip} stage in the loop")
        loop = loop.replace(_STAGES[skip], "if (0) " + _STAGES[skip], 1)
    head = text.rindex("__device__", 0, k)
    return ("".join(f"#define {d}\n" for d in defines) + text[:head]
            + _SWITCHES + text[head:a] + loop + text[b:])


def build(name: str, source: str, out_dir: str):
    """``source`` compiled to ``out_dir``/``name``.so, loaded and typed."""
    from prost_tpu_torch.ops.cuda_build import CSRC, NVCC_FLAGS, _nvcc

    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as fh:
        fh.write(source)
    lib_path = os.path.join(out_dir, f"{name}.so")
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o",
                             lib_path, path], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), lib_path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_resident: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import admm_kernel_inputs, card_line
    from prost_tpu_torch.ops import fused_admm as fa
    from prost_tpu_torch.ops.pdhg_chunk import scalar_buffer

    dev = torch.device("cuda", 0)
    out_dir = os.path.join(ROOT, "prost_tpu_torch", "_build",
                           "profile_resident")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(ROOT, "prost_tpu_torch", "csrc",
                           "fused_admm.cu")) as fh:
        text = fh.read()
    sources = {"kernel": text,
               "no_barrier": variant_source(text, ["NO_BARRIER"]),
               "no_exchange": variant_source(text, ["NO_EXCHANGE"]),
               "compute": variant_source(text, ["NO_BARRIER",
                                                "NO_EXCHANGE"])}
    for stage in _STAGES:
        sources[f"compute_no_{stage}"] = variant_source(
            text, ["NO_BARRIER", "NO_EXCHANGE"], stage)
    full = {"kernel"}
    for arg in sys.argv[1:]:
        name, path = arg.split("=", 1)
        with open(path) as fh:
            sources[name] = fh.read()
        full.add(name)
    jobs = {n: build(re.sub(r"\W", "_", n), src, out_dir)
            for n, src in sources.items()}  # one nvcc each, at once
    libs = {}
    VP, CI, CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (proc, lib_path) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"profile_resident: nvcc failed on {name}:\n"
                             f"{err}")
        lib = ctypes.CDLL(lib_path)
        lib.prost_admm_multichunk_resident.argtypes = (
            [VP] * 12 + [CI] * 6 + [VP] + [CF] * 6 + [VP])
        lib.prost_admm_multichunk_resident.restype = CI
        libs[name] = lib

    *planes, f, w = admm_kernel_inputs(NX, NY, 5, dev)
    consts = (np.sqrt(2 * NX * NY), np.sqrt(NX * NY), 0.8, 1.01)
    scal = torch.tensor([1.3, 8.0, 1.0, 1.05, 0.0, 0.0, 0.0] + [0.0] * 4,
                        device=dev)
    coeffs = fa._coeff_tensor(DEGREE, dev)
    scratch = torch.empty(12 * NX * NY, device=dev)
    partial = torch.empty(4 * fa._lib().prost_admm_num_blocks(NX, NY),
                          device=dev)

    def call(lib, bufs, sc, count):
        ptrs = [ctypes.c_void_p(t.data_ptr())
                for t in bufs + [f, w, scratch, sc, partial]]
        rc = lib.prost_admm_multichunk_resident(
            *ptrs, NX, NY, count, CHUNKS, 0, DEGREE,
            ctypes.c_void_p(coeffs.data_ptr()), 1.7, 1.0 - 1.7,
            *[float(c) for c in consts],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise SystemExit(f"profile_resident: launch failed ({rc})")

    ref = [t.clone() for t in planes]
    norms, sout = fa.admm_multichunk_(*ref, f, w, scal, RI, CHUNKS, 1.7,
                                      DEGREE, consts, path="streaming")
    for name in sorted(full):
        bufs = [t.clone() for t in planes]
        sc = scalar_buffer(scal, 11, 11, 24)
        call(libs[name], bufs, sc, RI)
        torch.cuda.synchronize()
        equal = (all(torch.equal(a, b) for a, b in zip(bufs, ref))
                 and torch.equal(sc[13:17], norms))
        print(f"{name}: bit-equal to the launch sequence: {equal}")
        if not equal:
            return 1

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    names = list(libs)
    times = {n: [] for n in names}
    for name in names + names[::-1]:
        bufs = [t.clone() for t in planes]
        sc = scalar_buffer(scal, 11, 11, 24)
        times[name].append(tuple(
            time_ms(lambda: call(libs[name], bufs, sc, count))
            for count in (RI, 1)))
    iters = CHUNKS * (RI - 1)
    out = {}
    for name in names:
        full_ms = [a for a, _ in times[name]]
        one_ms = [b for _, b in times[name]]
        per_it = (np.mean(full_ms) - np.mean(one_ms)) / iters * 1e3
        out[name] = {"count_ri_ms": full_ms, "count_1_ms": one_ms,
                     "us_per_iteration": per_it}
        print(f"{name}: count {RI} " + ", ".join(f"{t:.4f}" for t in full_ms)
              + f" ms; count 1 " + ", ".join(f"{t:.4f}" for t in one_ms)
              + f" ms; {per_it:.2f} us an iteration")
    print(card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
