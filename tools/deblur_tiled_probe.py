#!/usr/bin/env python3
"""The tiled deblur chunk on the card: bit-equality with the streaming
launch sequence, where its time goes, and what its thread count, its
register-held taps and its asynchronous window loads are worth.

    python3 tools/deblur_tiled_probe.py

BASELINE config 2's 9x9 45-degree motion blur (7 taps) at 2048x2048 (ri
10, the tiled chunk ``prost_deblur_chunk_tiled``: the cooperative launch
and the finish) from random planes, in place on buffers made once:

* the tiled chunk against the streaming sequence from the same inputs,
  counts 10 and 3: planes and squared norms bit-equal;
* timed with CUDA events (10 calls after a warm-up): by tile (the shape
  rule's and others of the search), by count at the rule's tile (1, 2,
  10: the cost of an iteration and of a call's fixed part, the norm pass
  and the finish), and the streaming sequence beside it;
* variants of ``csrc/fused_deblur.cu`` built beside it (``VARIANTS``: the
  source or a header it includes with a substitution, compiled with the
  package's nvcc flags into a directory of its own under
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

N, RI, LMB = 2048, 10, 100.0

# name: (substitutions (file of csrc, old, new) on csrc/fused_deblur.cu and
# the headers it includes, its tile; None: the shape rule's)
VARIANTS = {
    # 16 rows of 32 threads: half the warps, 128 registers a thread
    "512 threads": ([
        ("fused_deblur.cu", "constexpr int DT_THREADS = 1024;",
         "constexpr int DT_THREADS = 512;"),
    ], None),
    # config 2's taps read from shared memory (the kernel for more than 8)
    "taps in shared memory": ([
        ("fused_deblur.cu", "    case 7: return deblur_tiled<7>;\n", ""),
    ], None),
    # the window's loads as plain loads and shared-memory stores
    "plain loads": ([
        ("cp_async.cuh",
         "#ifdef __CUDA_ARCH__\n  asm volatile(\"cp.async.ca",
         "#if 0\n  asm volatile(\"cp.async.ca"),
    ], None),
}


def build_variant(name, subs):
    """``csrc/fused_deblur.cu`` with ``subs`` applied (a changed header
    beside the copy, which its quoted include finds first), built into a
    directory of its own under ``_build/exp/``: (the loaded library, its
    ptxas lines)."""
    from prost_tpu_torch.ops import cuda_build

    out = os.path.join(cuda_build.BUILD_DIR, "exp", "deblur_" + "".join(
        c if c.isalnum() else "_" for c in name))
    os.makedirs(out, exist_ok=True)
    texts = {}
    for fname, old, new in subs + [("fused_deblur.cu", "", "")]:
        if fname not in texts:
            with open(os.path.join(cuda_build.CSRC, fname)) as fh:
                texts[fname] = fh.read()
        if old:
            if texts[fname].count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found "
                                   f"once in {fname}")
            texts[fname] = texts[fname].replace(old, new)
    for fname, text in texts.items():
        with open(os.path.join(out, fname), "w") as fh:
            fh.write(text)
    stem = os.path.join(out, "fused_deblur")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                           "-I", cuda_build.CSRC, "-o", stem + ".so",
                           stem + ".cu"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name!r}: nvcc failed:\n{proc.stderr}")
    return ctypes.CDLL(stem + ".so"), tiled_report(proc.stderr)


def tiled_report(log):
    """ptxas's register and spill lines of deblur_tiled in a build log."""
    out, mine = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mine = "deblur_tiled" in ln
            if mine:
                out.append(ln.strip().split("'")[1])
        elif mine and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def typed(lib):
    from prost_tpu_torch.ops.pdhg_chunk import CF, CI, VP

    lib.prost_deblur_chunk_tiled.argtypes = ([VP] * 12 + [CI] * 6 + [CF] * 4
                                             + [CI] * 4 + [VP])
    lib.prost_deblur_chunk_tiled.restype = CI
    return lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("deblur_tiled_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import prost_tpu_torch as ptt
    from prost_tpu_torch.ops import cuda_build
    from prost_tpu_torch.ops import fused_deblur as fd
    from prost_tpu_torch.ops.pdhg_chunk import S_CONV, S_LEN, S_NORM

    ptt.set_device("cuda:0")
    dev = ptt.device()
    card = cs.card_line()
    print(card)
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        base = pool.submit(fd._lib)
        built = {name: pool.submit(build_variant, name, subs)
                 for name, (subs, _) in VARIANTS.items()}
        base.result()
        built = {name: fut.result() for name, fut in built.items()}

    kern = cs.motion_kernel()
    taps = fd.kernel_taps(torch.as_tensor(kern.T, dtype=torch.float32))
    nx2, ny2 = N + kern.shape[1] - 1, N + kern.shape[0] - 1
    rng = np.random.RandomState(7)
    arrs = (rng.rand(N, N), rng.randn(nx2, ny2), 0.3 * rng.randn(2, N, N),
            rng.rand(nx2, ny2), 0.5 + rng.rand(nx2, ny2))
    init = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]
    state = [t.clone() for t in init[:3]]
    prev = [t.clone() for t in init[:3]]
    fb, sv = init[3], init[4]
    taps_t = fd.taps_array(taps, dev)
    sc = torch.zeros(S_LEN, device=dev)
    sc[:5] = torch.tensor([0.9, 1.1, 1.0, LMB, 1.0], device=dev)
    partial = torch.empty(4 * fd._lib().prost_deblur_num_blocks(nx2, ny2),
                          device=dev)
    scratch = fd._scratch("tiled", N, N, nx2, ny2, dev)[0]
    roots = (0.5, 0.2, 0.5 ** 0.5, 0.2 ** 0.5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    h = fd.deblur_tiled_halo(taps)

    def caller(lib, tile, count=RI):
        ptrs = [t.data_ptr() for t in (*state, *prev, fb, sv, taps_t, sc,
                                       partial, scratch)]

        def call():
            rc = lib.prost_deblur_chunk_tiled(
                *ptrs, N, N, nx2, ny2, len(taps), h, *roots, 0, count,
                *tile, stream)
            if rc:
                raise RuntimeError(f"prost_deblur_chunk_tiled: CUDA error "
                                   f"{rc}")
        return call

    def streaming(count=RI):
        def call():
            fd._launch_chunk("deblur_chunk", state, prev, fb, sv, taps_t, sc,
                             partial, carried, ("streaming", None), count,
                             taps, *roots[:2])
        return call

    carried = fd._scratch("streaming", N, N, nx2, ny2, dev)

    def outputs(call):
        for t, v in zip(state, init[:3]):
            t.copy_(v)
        sc[S_CONV] = 0.0
        sc[S_NORM:S_NORM + 4] = 0.0
        call()
        torch.cuda.synchronize()
        return ([t.clone() for t in state] + [t.clone() for t in prev]
                + [sc[S_NORM:S_NORM + 4].clone()])

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

    lib = fd._lib()
    sms, tsmem = fd.card_limits(dev)[0], fd.deblur_tiled_limit(dev)
    rule = fd.deblur_tiled_tile(nx2, ny2, taps, sms, tsmem)
    out = {"card": card, "rule_tile": rule, "halo": h, "smem_limit": tsmem,
           "ptxas": tiled_report(cuda_build.load("fused_deblur").log)}
    print("ptxas", out["ptxas"])
    equal = {}
    for count in (RI, 3):
        want = outputs(streaming(count))
        got = outputs(caller(lib, rule, count))
        equal[count] = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        print(f"count {count}: tiled against streaming, bit-equal "
              f"{equal[count]}; norms {got[-1].tolist()}")
    out["bit_equal"] = equal
    if not all(all(v) for v in equal.values()):
        print(card)
        print(json.dumps(out))
        return 1
    tiles = {}
    for tile in (rule, (104, 64), (72, 96), (56, 128), (40, 160), (64, 64),
                 (120, 64), (32, 192), (24, 224)):
        if (fd.deblur_tiled_bytes(*tile, taps) <= tsmem
                and str(tile) not in tiles):
            tiles[str(tile)] = ms(caller(lib, tile))
    out["by_tile_ms"] = tiles
    out["by_count_ms"] = {c: ms(caller(lib, rule, count=c))
                          for c in (1, 2, RI)}
    out["streaming_ms"] = ms(streaming(), reps=10)
    out["streaming_by_count_ms"] = {c: ms(streaming(c)) for c in (1, 2)}
    c1, c10 = out["by_count_ms"][1], out["by_count_ms"][RI]
    out["iteration_ms"] = (c10 - c1) / (RI - 1)
    out["fixed_ms"] = c1 - out["iteration_ms"]
    print(json.dumps(out))

    want = outputs(caller(lib, rule))
    out["variants"] = {}
    for name, (vlib, report) in built.items():
        vlib = typed(vlib)
        vrule = VARIANTS[name][1] or rule
        got = outputs(caller(vlib, vrule))
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        res = {"tile": vrule, "bit_equal": same, "ptxas": report}
        if same:
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
