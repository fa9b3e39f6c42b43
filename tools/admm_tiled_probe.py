#!/usr/bin/env python3
"""Where the tiled Chebyshev-ADMM chunk's time goes on the card, and what
the parts of its design are worth.

    python3 tools/admm_tiled_probe.py [--pr22 CSRC_DIR] [--ptxas]

At 2048x2048 (square data term, ri 10, Chebyshev degree 10 unless varied)
the tiled chunk (``prost_admm_chunk_tiled``: the cooperative launch, the
finish and, after an odd count, the copy back) is timed with CUDA events,
10 calls after a warm-up, in place on buffers made once:

* by tile: the shape rule's tile and others the launch takes;
* by count at the rule's tile (1, 2, 10): the cost of an iteration and of
  a call's fixed part (the norm pass and the finish);
* by Chebyshev degree (1, 4, 10) at counts 1, 2 and 10 at the rule's tile:
  the cost of a Chebyshev step, and of an iteration's other parts (the
  loads, the head and the update: an iteration at degree 1);
* the streaming launch sequence beside it;
* variants of ``csrc/fused_admm.cu`` built beside it (``VARIANTS``: the
  source with a substitution, compiled with the package's nvcc flags into
  ``prost_tpu_torch/_build/exp/``), each first checked bit-equal to the
  package's kernel from the same inputs, then timed in turns with it
  (package, variant, variant, package), at degree 10 and at degree 1 (no
  Chebyshev step: the loads, the head and the update); a variant that
  need not be bit-equal is timed only.  ``--pr22`` names a ``csrc``
  directory holding the previous design's ``fused_admm.cu`` (PR 22's:
  five shared planes walked by rows of 32 threads, e.g. ``git archive`` of
  an earlier commit unpacked into a git-ignored directory); the variants
  on it (``base`` "pr22") run only then.

Prints the card line and one JSON object last.  Needs a CUDA card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N, RI, ALPHA = 2048, 10, 1.7

# name: (base ("package" or "pr22"), substitutions (file of the base's
# csrc, old, new) on fused_admm.cu and the headers it includes, its tile
# (None: the shape rule's), whether it must be bit-equal to the package's
# kernel; one that need not is timed only, and its outputs are not
# compared)
VARIANTS = {
    # every window's stencils test each neighbour (the edge windows' form)
    "every window tested": ("package", [
        ("fused_admm.cu", "  s.edge = !(r0 >= 1 && c0 >= 1",
         "  s.edge = true || !(r0 >= 1 && c0 >= 1"),
    ], None, True),
    # 32 warps of 12-row strips: a 96-row map, 64 registers a thread
    "1024 threads, 12-row strips": ("package", [
        ("fused_admm.cu", "constexpr int AT_THREADS = 768;",
         "constexpr int AT_THREADS = 1024;"),
        ("fused_admm.cu", "constexpr int AT_K = 16;",
         "constexpr int AT_K = 12;"),
    ], (72, 96), True),
    # two blocks of 384 threads on each SM, each with half the shared
    # memory: one block's loads and update under the other's steps
    "2 blocks a SM of 384 threads, 40x64": ("package", [
        ("fused_admm.cu",
         "constexpr int AT_THREADS = 768;", "constexpr int AT_THREADS = 384;"),
        ("fused_admm.cu", "constexpr int AT_BLOCKS = 1;",
         "constexpr int AT_BLOCKS = 2;"),
    ], (40, 64), True),
    "2 blocks a SM of 384 threads, 24x96": ("package", [
        ("fused_admm.cu",
         "constexpr int AT_THREADS = 768;", "constexpr int AT_THREADS = 384;"),
        ("fused_admm.cu", "constexpr int AT_BLOCKS = 1;",
         "constexpr int AT_BLOCKS = 2;"),
    ], (24, 96), True),
    # the update's columns two at a time (their loads in flight together)
    "update columns by 2": ("package", [
        ("fused_admm.cu",
         "#pragma unroll 1\n    for (int jj = C0",
         "#pragma unroll 2\n    for (int jj = C0"),
    ], None, True),
    # the whole map loaded (the rows and columns beyond the window too)
    "map-wide loads": ("package", [
        ("fused_admm.cu",
         "    const int k1 = s.j >= 0 && s.j < s.jlim ? "
         "min(s.ilim - s.i0, AT_K) : 0;",
         "    const int k1 = s.j >= 0 && s.j < ny ? min(nx - s.i0, AT_K) : "
         "0;"),
    ], None, True),
    # PR 22's kernel as it was (its own tile rule's 104x64)
    "pr22": ("pr22", [], (104, 64), True),
    # step 0, on PR 22's kernel: the Chebyshev steps' stencil with none of
    # m_win's four neighbour tests (wrong at the window's and the plane's
    # edges: timed only)
    "pr22 no m_win tests": ("pr22", [
        ("fused_admm.cu",
         "wi > 0 && above(b, i) && below(b, i - 1) ? c - v[p - ww] : 0.f;",
         "c - v[p - ww];"),
        ("fused_admm.cu",
         "wi < a.wh - 1 && below(b, i) ? v[p + ww] - c : 0.f;",
         "v[p + ww] - c;"),
        ("fused_admm.cu", "wj > 0 && j > 0 ? c - v[p - 1] : 0.f;",
         "c - v[p - 1];"),
        ("fused_admm.cu", "wj < ww - 1 && j < b.ny - 1 ? v[p + 1] - c : 0.f;",
         "v[p + 1] - c;"),
    ], (104, 64), False),
    # step 0: m_win's row context as two ints of the window (the whole
    # plane's last row and column) in place of the parameter struct's
    # fields, and the coefficients through the read-only cache
    "pr22 row context in registers": ("pr22", [
        ("fused_admm.cu", "  int oi0, oi1, oj0, oj1;\n};",
         "  int oi0, oi1, oj0, oj1;\n  int nxm1, nym1;\n};"),
        ("fused_admm.cu", "  a.oj1 = C1 - a.c0;\n",
         "  a.oj1 = C1 - a.c0;\n  a.nxm1 = nx - 1;\n  a.nym1 = ny - 1;\n"),
        ("fused_admm.cu",
         "wi > 0 && above(b, i) && below(b, i - 1) ? c - v[p - ww] : 0.f;",
         "wi > 0 && i > 0 ? c - v[p - ww] : 0.f;"),
        ("fused_admm.cu",
         "wi < a.wh - 1 && below(b, i) ? v[p + ww] - c : 0.f;",
         "wi < a.wh - 1 && i < a.nxm1 ? v[p + ww] - c : 0.f;"),
        ("fused_admm.cu", "wj < ww - 1 && j < b.ny - 1 ? v[p + 1] - c : 0.f;",
         "wj < ww - 1 && j < a.nym1 ? v[p + 1] - c : 0.f;"),
        ("fused_admm.cu",
         "const float cp = coeffs[2 * s], cr = coeffs[2 * s + 1];",
         "const float cp = __ldg(coeffs + 2 * s), "
         "cr = __ldg(coeffs + 2 * s + 1);"),
    ], (104, 64), True),
    # step 0: the two slots' States copied by value once an iteration (their
    # pointers and ints then in registers) in place of references chosen
    # at run time between the kernel's two parameter structs
    "pr22 slots by value": ("pr22", [
        ("fused_admm.cu",
         "    const State& src = b_in ? sb : sa;\n"
         "    const State& dst = b_in ? sa : sb;",
         "    const State src = b_in ? sb : sa;\n"
         "    const State dst = b_in ? sa : sb;"),
    ], (104, 64), True),
}

# tiles the package's launch takes at degree 10, beside the rule's
TILES = ((72, 96), (40, 160), (168, 32), (40, 128), (72, 64), (56, 96),
         (104, 32), (88, 64))


def build_variant(name, csrc, subs):
    """``fused_admm.cu`` of the directory ``csrc`` with ``subs`` applied
    (a changed header beside the copy, which its quoted include finds
    first), built into a directory of its own under ``_build/exp/``: the
    loaded library and its ptxas lines of admm_tiled."""
    from prost_tpu_torch.ops import cuda_build

    out = os.path.join(cuda_build.BUILD_DIR, "exp", "admm_" + "".join(
        c if c.isalnum() else "_" for c in name))
    os.makedirs(out, exist_ok=True)
    texts = {}
    for fname, old, new in subs:
        if fname not in texts:
            with open(os.path.join(csrc, fname)) as fh:
                texts[fname] = fh.read()
        if texts[fname].count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} not found once "
                               f"in {fname}")
        texts[fname] = texts[fname].replace(old, new)
    if "fused_admm.cu" not in texts:
        with open(os.path.join(csrc, "fused_admm.cu")) as fh:
            texts["fused_admm.cu"] = fh.read()
    for fname, text in texts.items():
        with open(os.path.join(out, fname), "w") as fh:
            fh.write(text)
    stem = os.path.join(out, "fused_admm")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                           "-I", csrc, "-o", stem + ".so", stem + ".cu"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name!r}: nvcc failed:\n{proc.stderr}")
    return ctypes.CDLL(stem + ".so"), tiled_report(proc.stderr)


def tiled_report(log):
    """ptxas's register and spill lines of admm_tiled (each instantiation,
    by its column blocks) in a build log."""
    out, mine = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mine = None
            if "10admm_tiledILi" in ln:  # admm_tiled<CB>
                mine = "CB " + ln.split("10admm_tiledILi")[1].split("E")[0]
            elif "10admm_tiledE" in ln:
                mine = "admm_tiled"
        elif mine and ("registers" in ln or "spill" in ln):
            out.append(f"{mine}: {ln.strip()}")
    return out


def typed(lib):
    from prost_tpu_torch.ops.pdhg_chunk import CF, CI, VP

    lib.prost_admm_chunk_tiled.argtypes = ([VP] * 12 + [CI] * 5
                                           + [VP, CF, CF, CI, CI, VP])
    lib.prost_admm_chunk_tiled.restype = CI
    lib.prost_admm_tiled_smem.argtypes = []
    lib.prost_admm_tiled_smem.restype = CI
    return lib


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--pr22", help="a csrc directory holding PR 22's "
                    "fused_admm.cu, for the variants on it")
    ap.add_argument("--ptxas", action="store_true", help="build the package "
                    "and the variants, print ptxas's lines of admm_tiled, "
                    "time nothing")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("admm_tiled_probe: no CUDA device", file=sys.stderr)
        return 2
    import prost_tpu_torch as ptt
    from prost_tpu_torch.ops import cuda_build
    from prost_tpu_torch.ops import fused_admm as fa

    ptt.set_device("cuda:0")
    dev = ptt.device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    bases = {"package": cuda_build.CSRC, "pr22": opts.pr22}
    chosen = {name: v for name, v in VARIANTS.items() if bases[v[0]]}
    with ThreadPoolExecutor(len(chosen) + 1) as pool:
        base = pool.submit(fa._lib)
        built = {name: pool.submit(build_variant, name, bases[v[0]], v[1])
                 for name, v in chosen.items()}
        base.result()
        built = {name: fut.result() for name, fut in built.items()}
    if opts.ptxas:
        report = {name: rep for name, (_, rep) in built.items()}
        report["package"] = tiled_report(cuda_build.load("fused_admm").log)
        print(json.dumps(report))
        return 0

    rng = np.random.RandomState(5)
    arrs = [rng.rand(N, N) for _ in range(3)]
    arrs += [0.3 * rng.randn(2, N, N) for _ in range(3)]
    arrs += [0.1 * rng.randn(N, N), rng.rand(N, N)]
    init = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]
    state = [t.clone() for t in init[:7]]
    f = init[7]
    sc = torch.zeros(fa._S_LEN, device=dev)
    sc[:3] = torch.tensor([1.3, 8.0, 1.0], device=dev)
    partial = torch.empty(4 * fa._lib().prost_admm_num_blocks(N, N),
                          device=dev)
    scratch = fa._scratch("tiled", N, N, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def caller(lib, tile, count=RI, degree=10):
        coeffs = fa._coeff_tensor(degree, dev)
        ptrs = [t.data_ptr() for t in (*state, f, f, scratch, sc, partial)]

        def call():
            rc = lib.prost_admm_chunk_tiled(
                *ptrs, N, N, count, 0, degree, coeffs.data_ptr(), ALPHA,
                1.0 - ALPHA, *tile, stream)
            if rc:
                raise RuntimeError(f"prost_admm_chunk_tiled: CUDA error {rc}")
        return call

    def ms(call, reps=10):
        call()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            call()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def outputs(call):
        for t, v in zip(state, init[:7]):
            t.copy_(v)
        call()
        torch.cuda.synchronize()
        return [t.clone() for t in state] + [sc[13:17].clone()]

    lib = fa._lib()
    sms, tsmem = fa.admm_card_limits(dev)[0], fa.admm_tiled_limit(dev)
    out = {"card": card}
    rule = fa.admm_tiled_tile(N, N, 10, sms, tsmem)
    out["rule_tile"] = rule
    out["map"] = fa.admm_tiled_map(*rule, 10)
    out["ptxas"] = tiled_report(cuda_build.load("fused_admm").log)
    tiles = {}
    for tile in (rule, *TILES):
        if fa.admm_tiled_fits(*tile, 10, tsmem) and str(tile) not in tiles:
            tiles[str(tile)] = ms(caller(lib, tile))
    out["by_tile_ms"] = tiles
    grid = {(c, d): ms(caller(lib, rule, count=c, degree=d))
            for c in (1, 2, RI) for d in (1, 4, 10)}
    out["by_count_degree_ms"] = {f"count {c} degree {d}": v
                                 for (c, d), v in grid.items()}

    def streaming():
        fa._chunk_card(state, f, f, sc, partial, scratch,
                       ("streaming", None), None, RI, 0, ALPHA, 10, "square")
    out["streaming_ms"] = ms(streaming, reps=5)
    it10 = (grid[(RI, 10)] - grid[(1, 10)]) / (RI - 1)
    it1 = (grid[(RI, 1)] - grid[(1, 1)]) / (RI - 1)
    out["iteration_ms"] = it10
    out["fixed_ms"] = grid[(1, 10)] - it10
    # an iteration at degree 1: loads, head, u and x_proj, update
    out["iteration_degree1_ms"] = it1
    out["cheby_step_ms"] = (it10 - it1) / 9

    want = outputs(caller(lib, rule))
    out["variants"] = {}
    for name, (vlib, report) in built.items():
        vlib = typed(vlib)
        vsmem = vlib.prost_admm_tiled_smem()
        _, _, vtile, exact = VARIANTS[name]
        vrule = vtile or rule
        res = {"tile": vrule, "smem_limit": vsmem, "ptxas": report}
        try:
            got = outputs(caller(vlib, vrule))
        except RuntimeError as e:  # the variant refuses the tile
            res["refused"] = str(e)
            out["variants"][name] = res
            continue
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        res["bit_equal"] = equal
        if equal or not exact:
            for key, deg in (("turns_ms", 10), ("turns_degree1_ms", 1)):
                t = [ms(caller(x, tl, degree=deg))
                     for x, tl in ((lib, rule), (vlib, vrule), (vlib, vrule),
                                   (lib, rule))]
                res[key] = {"package": (t[0], t[3]), "variant": (t[1], t[2])}
        out["variants"][name] = res
        print(name, json.dumps(res))
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
