#!/usr/bin/env python3
"""The tiled multilabel chunk on the card: bit-equality with the streaming
launch sequence, where its time goes, and what its norm pass and its
asynchronous window loads are worth.

    python3 tools/ml_tiled_probe.py

512x512x8 (the JAX package's banded size, ri 10, the tiled chunk
``prost_ml_chunk_tiled``: the cooperative launch and the finish) from
random planes, in place on buffers made once:

* the tiled chunk against the streaming sequence from the same inputs,
  counts 10 and 3: planes, previous iterates and squared norms bit-equal;
* timed with CUDA events (10 calls after a warm-up): by tile (the shape
  rule's and others that fit), by count at the rule's tile (1, 2, 10: the
  cost of an iteration and of a call's fixed part, the norm pass and the
  finish), the streaming sequence beside it, and the multichunk of 8
  chunks both ways;
* variants of ``csrc/fused_multilabel.cu`` built beside it
  (``VARIANTS``: the source or a header it includes with a substitution,
  compiled with the package's nvcc flags into a directory of its own under
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

N, L, RI, LMB = 512, 8, 10, 0.5

# The norm pass as a pixel walk: each thread a pixel's terms into 4 term
# planes after slot B's in the scratch, then after a second grid barrier
# coop_tile_partials' trees over them (pdhg_chunk.cuh).
_PIXEL_NORMS = """  const ML& fin = ((start + count) & 1) != 0 ? b : a;
  const size_t n = (size_t)nx * ny;
  for (size_t p = (size_t)blockIdx.x * MT_THREADS + threadIdx.x; p < n;
       p += (size_t)gridDim.x * MT_THREADS) {
    const int i = (int)(p / ny), j = (int)(p % ny);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (owned_row(r, i)) ml_norm_terms<false>(fin, r, i, j, v);
    for (int c = 0; c < 4; ++c) a.terms[c * n + p] = v[c];
  }
  grid.sync();
  coop_tile_partials(a.terms, nx, ny, a.partial, smem);
}

"""

_TILE_NORMS_START = "  const ML& fin = ((start + count) & 1) != 0 ? b : a;\n"
_TILE_NORMS_END = "// After a tiled chunk (multi 0)"

_SLOT_B = """ML slot_b(const ML& a, void* scratch) {
  const size_t nl = (size_t)a.nx * a.ny * a.L;
  ML b = a;"""
_SLOT_B_TERMS = """ML slot_b(ML& a, void* scratch) {
  const size_t nl = (size_t)a.nx * a.ny * a.L;
  a.terms = (float*)scratch + 3 * nl + (size_t)a.nx * a.ny;
  ML b = a;"""

# name: (substitutions (file of csrc, old, new) on csrc/fused_multilabel.cu
# and the headers it includes; a (start, end) pair for old replaces the
# text from start up to end)
VARIANTS = {
    # the norm pass a pixel a thread into 4 term planes (4 more planes of
    # scratch), then the tiles' trees after a second grid barrier
    "pixel-walk norm pass": [
        ("fused_multilabel.cu", (_TILE_NORMS_START, _TILE_NORMS_END),
         _PIXEL_NORMS + _TILE_NORMS_END),
        ("fused_multilabel.cu", _SLOT_B, _SLOT_B_TERMS),
    ],
    # the window's loads as plain loads and shared-memory stores
    "plain loads": [
        ("cp_async.cuh",
         "#ifdef __CUDA_ARCH__\n  asm volatile(\"cp.async.ca",
         "#if 0\n  asm volatile(\"cp.async.ca"),
    ],
}


def substitute(name, text, fname, old, new):
    if isinstance(old, tuple):
        start, end = old
        i = text.find(start)
        j = text.find(end, i)
        if i < 0 or j < 0 or text.count(start) != 1:
            raise RuntimeError(f"variant {name!r}: span not found once in "
                               f"{fname}")
        return text[:i] + new + text[j + len(end):]
    if text.count(old) != 1:
        raise RuntimeError(f"variant {name!r}: {old!r} not found once in "
                           f"{fname}")
    return text.replace(old, new)


def build_variant(name, subs):
    """``csrc/fused_multilabel.cu`` with ``subs`` applied (a changed header
    beside the copy, which its quoted include finds first), built into a
    directory of its own under ``_build/exp/``: (the loaded library, its
    ptxas lines)."""
    from prost_tpu_torch.ops import cuda_build

    out = os.path.join(cuda_build.BUILD_DIR, "exp", "ml_" + "".join(
        c if c.isalnum() else "_" for c in name))
    os.makedirs(out, exist_ok=True)
    texts = {}
    for fname, old, new in subs + [("fused_multilabel.cu", "", "")]:
        if fname not in texts:
            with open(os.path.join(cuda_build.CSRC, fname)) as fh:
                texts[fname] = fh.read()
        if old:
            texts[fname] = substitute(name, texts[fname], fname, old, new)
    for fname, text in texts.items():
        with open(os.path.join(out, fname), "w") as fh:
            fh.write(text)
    stem = os.path.join(out, "fused_multilabel")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                           "-I", cuda_build.CSRC, "-o", stem + ".so",
                           stem + ".cu"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name!r}: nvcc failed:\n{proc.stderr}")
    return ctypes.CDLL(stem + ".so"), tiled_report(proc.stderr)


def tiled_report(log):
    """ptxas's register and spill lines of ml_tiled<8> in a build log."""
    out, mine = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mine = "ml_tiledILi8E" in ln
            if mine:
                out.append(ln.strip().split("'")[1])
        elif mine and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def typed(lib):
    from prost_tpu_torch.ops.pdhg_chunk import CF, CI, VP

    lib.prost_ml_chunk_tiled.argtypes = ([VP] * 10 + [CI] * 3 + [CF] * 2
                                         + [CI] * 3 + [VP])
    lib.prost_ml_chunk_tiled.restype = CI
    return lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ml_tiled_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import prost_tpu_torch as ptt
    from prost_tpu_torch.ops import cuda_build
    from prost_tpu_torch.ops import fused_multilabel as fm
    from prost_tpu_torch.ops.pdhg_chunk import S_CONV, S_LEN, S_NORM

    ptt.set_device("cuda:0")
    dev = ptt.device()
    card = cs.card_line()
    print(card)
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        base = pool.submit(fm._lib)
        built = {name: pool.submit(build_variant, name, subs)
                 for name, subs in VARIANTS.items()}
        base.result()
        built = {name: fut.result() for name, fut in built.items()}

    init = cs.ml_kernel_inputs(L, N, N, 7, dev)
    state = [t.clone() for t in init[:3]]
    prev = [t.clone() for t in init[:3]]
    f = init[3]
    sc = torch.zeros(S_LEN, device=dev)
    sc[:5] = torch.tensor([0.9, 1.1, 1.0, LMB, 1.0], device=dev)
    partial = torch.empty(4 * fm._lib().prost_ml_num_blocks(N, N),
                          device=dev)
    # slot B and 4 planes more, which the pixel-walk variant takes
    scratch = torch.empty((3 * L + 5) * N * N, device=dev)
    carried = fm._scratch("streaming", L, N, N, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def caller(lib, tile, count=RI):
        ptrs = [t.data_ptr() for t in (*state, *prev, f, sc, partial,
                                       scratch)]

        def call():
            rc = lib.prost_ml_chunk_tiled(*ptrs, L, N, N, 1.0 / L,
                                          (1.0 / L) ** 0.5, count, *tile,
                                          stream)
            if rc:
                raise RuntimeError(f"prost_ml_chunk_tiled: CUDA error {rc}")
        return call

    def streaming(count=RI):
        def call():
            fm._launch_chunk("ml_chunk", state, prev, f, sc, partial,
                             carried, ("streaming", None), count)
        return call

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

    lib = fm._lib()
    sms, tsmem = fm.card_sms(dev), fm.ml_tiled_limit(dev)
    rule = fm.ml_tiled_tile(N, N, L, sms, tsmem)
    out = {"card": card, "rule_tile": rule, "smem_limit": tsmem,
           "ptxas": tiled_report(cuda_build.load("fused_multilabel").log)}
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
    for tile in (rule, (16, 32), (24, 32), (40, 32), (48, 32), (8, 64),
                 (16, 64), (8, 128), (8, 160)):
        if (fm.ml_tiled_bytes(*tile, L) <= tsmem
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
    mscal = torch.tensor([1.0, 1.0, 1.0, LMB, 1.0, 0.5, 0.0, 0.0, 1.0, 0.0,
                          0.0, 0.0, 0.0], device=dev)
    consts = (np.sqrt(2 * N * N * L + N * N), np.sqrt(N * N * L), 1.5,
              0.95, 1.05, 0.8)
    t = [ms(lambda p=p: fm.ml_multichunk_(*state, *prev, f, mscal, RI, 8,
                                          "boyd", consts, path=p), reps=5)
         for p in ("streaming", "tiled", "tiled", "streaming")]
    out["multichunk_turns_ms"] = {"streaming": (t[0], t[3]),
                                  "tiled": (t[1], t[2])}
    print(json.dumps(out))

    want = outputs(caller(lib, rule))
    out["variants"] = {}
    for name, (vlib, report) in built.items():
        vlib = typed(vlib)
        got = outputs(caller(vlib, rule))
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        res = {"bit_equal": same, "ptxas": report}
        if same:
            t = [ms(caller(x, rule)) for x in (lib, vlib, vlib, lib)]
            res["turns_ms"] = {"package": (t[0], t[3]),
                               "variant": (t[1], t[2])}
            t1 = [ms(caller(x, rule, 1)) for x in (lib, vlib, vlib, lib)]
            res["count1_turns_ms"] = {"package": (t1[0], t1[3]),
                                      "variant": (t1[1], t1[2])}
        out["variants"][name] = res
        print(name, json.dumps(res))
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
