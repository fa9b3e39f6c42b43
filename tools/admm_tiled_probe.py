#!/usr/bin/env python3
"""Where the tiled Chebyshev-ADMM chunk's time goes on the card, and what
its thread count and its asynchronous window loads are worth.

    python3 tools/admm_tiled_probe.py

At 2048x2048 (square data term, ri 10, Chebyshev degree 10 unless varied)
the tiled chunk (``prost_admm_chunk_tiled``: the cooperative launch, the
finish and, after an odd count, the copy back) is timed with CUDA events,
10 calls after a warm-up, in place on buffers made once:

* by tile: the shape rule's tile and others of the search;
* by count at the rule's tile (1, 2, 10): the cost of an iteration and of
  a call's fixed part (the norm pass and the finish);
* by Chebyshev degree at count 10 (1, 4, 10) at the rule's tile: the cost
  of a Chebyshev step;
* the streaming launch sequence beside it;
* variants of ``csrc/fused_admm.cu`` built beside it (``VARIANTS``: the
  source with a substitution, compiled with the package's nvcc flags into
  ``prost_tpu_torch/_build/exp/``), each first checked bit-equal to the
  package's kernel from the same inputs, then timed in turns with it
  (package, variant, variant, package).

Prints the card line and one JSON object last.  Needs a CUDA card.
"""

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N, RI, ALPHA = 2048, 10, 1.7

# name: (substitutions (file of csrc, old, new) on csrc/fused_admm.cu
# and the headers it includes, its tile; None: the shape rule's)
VARIANTS = {
    # 16 rows of 32 threads: half the warps, 128 registers a thread
    "512 threads": ([
        ("fused_admm.cu", "constexpr int AT_THREADS = 1024;",
         "constexpr int AT_THREADS = 512;"),
    ], None),
    # the window's loads as plain loads and shared-memory stores, each
    # thread's in a loop, in place of cp.async (csrc/cp_async.cuh's
    # cp_async4)
    "plain loads": ([
        ("cp_async.cuh",
         "#ifdef __CUDA_ARCH__\n  asm volatile(\"cp.async.ca",
         "#if 0\n  asm volatile(\"cp.async.ca"),
    ], None),
}


def build_variant(name, subs):
    """``csrc/fused_admm.cu`` with ``subs`` applied (a changed header
    beside the copy, which its quoted include finds first), built into a
    directory of its own under ``_build/exp/``: the loaded library."""
    from prost_tpu_torch.ops import cuda_build

    out = os.path.join(cuda_build.BUILD_DIR, "exp", "admm_" + "".join(
        c if c.isalnum() else "_" for c in name))
    os.makedirs(out, exist_ok=True)
    texts = {}
    for fname, old, new in subs:
        if fname not in texts:
            with open(os.path.join(cuda_build.CSRC, fname)) as fh:
                texts[fname] = fh.read()
        if texts[fname].count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} not found once "
                               f"in {fname}")
        texts[fname] = texts[fname].replace(old, new)
    if "fused_admm.cu" not in texts:
        with open(os.path.join(cuda_build.CSRC, "fused_admm.cu")) as fh:
            texts["fused_admm.cu"] = fh.read()
    for fname, text in texts.items():
        with open(os.path.join(out, fname), "w") as fh:
            fh.write(text)
    stem = os.path.join(out, "fused_admm")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                           "-I", cuda_build.CSRC, "-o", stem + ".so",
                           stem + ".cu"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name!r}: nvcc failed:\n{proc.stderr}")
    return ctypes.CDLL(stem + ".so"), tiled_report(proc.stderr)


def tiled_report(log):
    """ptxas's register and spill lines of admm_tiled in a build log."""
    out, mine = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mine = "10admm_tiledE" in ln
        elif mine and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
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
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        base = pool.submit(fa._lib)
        built = {name: pool.submit(build_variant, name, subs)
                 for name, (subs, _) in VARIANTS.items()}
        base.result()
        built = {name: fut.result() for name, fut in built.items()}

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
    out["ptxas"] = tiled_report(cuda_build.load("fused_admm").log)
    tiles = {}
    for tile in (rule, (72, 96), (48, 128), (112, 64), (192, 32), (64, 64),
                 (40, 160), (32, 96), (24, 224)):
        if fa.admm_tiled_bytes(*tile, 10) <= tsmem and str(tile) not in tiles:
            tiles[str(tile)] = ms(caller(lib, tile))
    out["by_tile_ms"] = tiles
    out["by_count_ms"] = {c: ms(caller(lib, rule, count=c))
                          for c in (1, 2, RI)}
    out["by_degree_ms"] = {d: ms(caller(lib, rule, degree=d))
                           for d in (1, 4, 10)}

    def streaming():
        fa._chunk_card(state, f, f, sc, partial, scratch,
                       ("streaming", None), None, RI, 0, ALPHA, 10, "square")
    out["streaming_ms"] = ms(streaming, reps=5)
    c1, c10 = out["by_count_ms"][1], out["by_count_ms"][RI]
    out["iteration_ms"] = (c10 - c1) / (RI - 1)
    out["fixed_ms"] = c1 - out["iteration_ms"]
    d1, d10 = out["by_degree_ms"][1], out["by_degree_ms"][10]
    out["cheby_step_ms"] = (d10 - d1) / (9 * RI)

    want = outputs(caller(lib, rule))
    out["variants"] = {}
    for name, (vlib, report) in built.items():
        vlib = typed(vlib)
        vsmem = vlib.prost_admm_tiled_smem()
        vrule = VARIANTS[name][1] or rule
        got = outputs(caller(vlib, vrule))
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        res = {"tile": vrule, "smem_limit": vsmem, "bit_equal": equal,
               "ptxas": report}
        if equal:
            t = [ms(caller(x, tl)) for x, tl in ((lib, rule), (vlib, vrule),
                                                 (vlib, vrule), (lib, rule))]
            res["turns_ms"] = {"package": (t[0], t[3]),
                               "variant": (t[1], t[2])}
        out["variants"][name] = res
        print(name, json.dumps(res))
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
