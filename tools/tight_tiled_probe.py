#!/usr/bin/env python3
"""The tiled tight chunk on the card: its registers, bit-equality with the
streaming launch sequence, and where its time goes.

    python3 tools/tight_tiled_probe.py

512x512x4 (the JAX package's banded size: k = 6 pairs, 24 taps, ri 10;
the tiled chunk ``prost_tight_chunk_tiled``: the cooperative launch, the
finish and after an odd count the copy back) from random planes, in
place on buffers made once:

* ptxas's register and spill lines of every ``tight_tiled<L>`` instance;
* the tiled chunk against the streaming sequence from the same inputs,
  counts 10, 3 and 1, the rule's tile and others, and the 556-row halo
  band of one shard: planes, previous iterates and squared norms
  bit-equal;
* timed with CUDA events (10 calls after a warm-up): by tile (the shape
  rule's and others that fit), by count at the rule's tile (1, 2, 10: the
  cost of an iteration and of a call's fixed part, the norm pass and the
  finish), the streaming sequence beside it, and the band both ways;
* variants of ``csrc/fused_tight.cu`` built beside it (``VARIANTS``: the
  source or a header it includes with a substitution, compiled with the
  package's nvcc flags into a directory of its own under
  ``prost_tpu_torch/_build/exp/``), each first checked bit-equal to the
  package's kernel from the same inputs, then timed in turns with it
  (package, variant, variant, package) at counts 10 and 1.

Prints the card line and one JSON object last.  Needs a CUDA card.
"""

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N, L, RI, LMB = 512, 4, 10, 1.0

# name: substitutions (file of csrc, old, new) on csrc/fused_tight.cu and
# the headers it includes
VARIANTS = {
    # a pixel's v and p loaded in the pair loop, between its stores
    "loads in the pair loop": [
        ("fused_tight.cu", """    float pn[2 * K], vl[2 * K];
#pragma unroll
    for (int mm = 0; mm < 2 * K; ++mm) {
      pn[mm] = a.p[mm * n + g];
      vl[mm] = a.v[mm * n + g];
    }
#pragma unroll
    for (int mm = 0; mm < 2 * K; ++mm) {
      const size_t gm = mm * n + g;
      const float pv = pn[mm], vv = vl[mm];""", """    float pn[2 * K];
#pragma unroll
    for (int mm = 0; mm < 2 * K; ++mm) {
      const size_t gm = mm * n + g;
      const float pv = a.p[gm], vv = a.v[gm];"""),
    ],
    # the window's loads as plain loads and shared-memory stores
    "plain loads": [
        ("cp_async.cuh",
         "#ifdef __CUDA_ARCH__\n  asm volatile(\"cp.async.ca",
         "#if 0\n  asm volatile(\"cp.async.ca"),
    ],
}


def build_variant(name, subs):
    """``csrc/fused_tight.cu`` with ``subs`` applied (a changed header
    beside the copy, which its quoted include finds first), built into a
    directory of its own under ``_build/exp/``: (the loaded library, its
    ptxas lines)."""
    from prost_tpu_torch.ops import cuda_build

    out = os.path.join(cuda_build.BUILD_DIR, "exp", "tight_" + "".join(
        c if c.isalnum() else "_" for c in name))
    os.makedirs(out, exist_ok=True)
    texts = {}
    for fname, old, new in subs + [("fused_tight.cu", "", "")]:
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
    stem = os.path.join(out, "fused_tight")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                           "-I", cuda_build.CSRC, "-o", stem + ".so",
                           stem + ".cu"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name!r}: nvcc failed:\n{proc.stderr}")
    return ctypes.CDLL(stem + ".so"), tiled_report(proc.stderr)


def typed(lib):
    """The tiled entry point of a variant's library with the package's
    argument types."""
    from prost_tpu_torch.ops.pdhg_chunk import CF, CI, VP

    lib.prost_tight_chunk_tiled.argtypes = ([VP] * 15 + [CI] * 5 + [CF] * 10
                                            + [CI] * 3 + [VP])
    lib.prost_tight_chunk_tiled.restype = CI
    return lib


def tiled_report(log):
    """ptxas's register and spill lines of the tight_tiled<L> instances in
    a build log."""
    out, mine = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mine = "tight_tiled" in ln and "settle" not in ln
            if mine:
                out.append(ln.strip().split("'")[1])
        elif mine and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tight_tiled_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import prost_tpu_torch as ptt
    from prost_tpu_torch.ops import cuda_build
    from prost_tpu_torch.ops import fused_tight as ft
    from prost_tpu_torch.ops.pdhg_chunk import S_CONV, S_LEN, S_NORM
    from prost_tpu_torch.parallel.spatial_fused import window

    ptt.set_device("cuda:0")
    dev = ptt.device()
    card = cs.card_line()
    print(card)
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        base = pool.submit(ft._lib)
        built = {name: pool.submit(build_variant, name, subs)
                 for name, subs in VARIANTS.items()}
        base.result()
        built = {name: fut.result() for name, fut in built.items()}
    lib = ft._lib()
    out = {"card": card,
           "ptxas": tiled_report(cuda_build.load("fused_tight").log)}
    print("ptxas", out["ptxas"])
    sms, tsmem = ft.card_sms(dev), ft.tight_tiled_limit(dev)
    k = L * (L - 1) // 2
    init, taps, consts = cs.tight_kernel_inputs(L, N, N, 7, dev)
    T = len(taps)
    rule = ft.tight_tiled_tile(N, N, L, k, T, sms, tsmem)
    out.update({"rule_tile": rule, "smem_limit": tsmem})
    kron = ft.kron_array(taps, L, k, dev)
    consts10 = ft._consts10(consts)

    def buffers(planes, nx, band):
        state = [t.clone() for t in planes[:5]]
        prev = [t.clone() for t in state]
        sc = torch.zeros(S_LEN, device=dev)
        head = [0.9, 1.1, 1.0, LMB, 1.0]
        sc[:len(head) + len(band)] = torch.tensor(head + list(band),
                                                  device=dev)
        partial = torch.empty(4 * lib.prost_tight_num_blocks(nx, N),
                              device=dev)
        return state, prev, sc, partial

    def caller(bufs, planes, nx, route, count=RI, nxg=None):
        state, prev, sc, partial = bufs
        scratch = ft._route_scratch(route[0], L, nx, N, dev)
        what = "tight_chunk" if nxg is None else "tight_chunk_halo"

        def call():
            ft._launch_chunk(what, state, prev, planes[5], kron, sc,
                             partial, scratch, route, count, T, consts10, nxg)
        return call

    def outputs(bufs, planes, call):
        state, prev, sc, _ = bufs
        for t, v in zip(state, planes[:5]):
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

    bufs = buffers(init, N, ())
    streaming = ("streaming", None)
    equal = {}
    for count in (RI, 3, 1):
        want = outputs(bufs, init, caller(bufs, init, N, streaming, count))
        for tile in (rule, (32, 32), (8, 32), (16, 64)):
            got = outputs(bufs, init, caller(bufs, init, N, ("tiled", tile),
                                             count))
            equal[f"count {count} tile {tile}"] = all(
                torch.equal(a, b) for a, b in zip(got, want))
    H = 2 * RI + 2
    band = [window(a, -H, N + H) for a in init]
    nb = N + 2 * H
    bbufs = buffers(band, nb, (-H, H, H + N))
    brule = ft.tight_tiled_tile(nb, N, L, k, T, sms, tsmem)
    want = outputs(bbufs, band, caller(bbufs, band, nb, streaming, nxg=N))
    got = outputs(bbufs, band, caller(bbufs, band, nb, ("tiled", brule),
                                      nxg=N))
    equal[f"band {nb} tile {brule}"] = all(
        torch.equal(a, b) for a, b in zip(got, want))
    out["bit_equal"] = equal
    print("bit-equal", json.dumps(equal))
    if not all(equal.values()):
        print(card)
        print(json.dumps(out))
        return 1
    tiles = {}
    for tile in (rule, (32, 32), (16, 64), (32, 64), (8, 128), (16, 128),
                 (48, 32), (72, 32), (24, 64)):
        if (ft.tight_tiled_bytes(*tile, L, k, T) <= tsmem
                and str(tile) not in tiles):
            tiles[str(tile)] = ms(caller(bufs, init, N, ("tiled", tile)))
    out["by_tile_ms"] = tiles
    out["by_count_ms"] = {c: ms(caller(bufs, init, N, ("tiled", rule), c))
                          for c in (1, 2, RI)}
    out["streaming_ms"] = ms(caller(bufs, init, N, streaming))
    out["streaming_by_count_ms"] = {
        c: ms(caller(bufs, init, N, streaming, c)) for c in (1, 2)}
    c1, c10 = out["by_count_ms"][1], out["by_count_ms"][RI]
    out["iteration_ms"] = (c10 - c1) / (RI - 1)
    out["fixed_ms"] = c1 - out["iteration_ms"]
    out["band"] = {"rule_tile": brule, "tiled_ms": ms(caller(
        bbufs, band, nb, ("tiled", brule), nxg=N)), "streaming_ms": ms(
        caller(bbufs, band, nb, streaming, nxg=N))}
    print(json.dumps(out))

    def direct(vlib, count=RI):
        """The tiled chunk through library ``vlib``'s entry point."""
        state, prev, sc, partial = bufs
        scratch = ft._route_scratch("tiled", L, N, N, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (*state, *prev, init[5], kron, sc,
                                       partial, *scratch)]

        def call():
            rc = vlib.prost_tight_chunk_tiled(*ptrs, L, k, N, N, T,
                                              *consts10, count, *rule,
                                              stream)
            if rc:
                raise RuntimeError(f"prost_tight_chunk_tiled: CUDA error "
                                   f"{rc}")
        return call

    want = outputs(bufs, init, direct(lib))
    out["variants"] = {}
    for name, (vlib, report) in built.items():
        vlib = typed(vlib)
        got = outputs(bufs, init, direct(vlib))
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        res = {"bit_equal": same, "ptxas": report}
        if same:
            for count in (RI, 1):
                t = [ms(direct(x, count)) for x in (lib, vlib, vlib, lib)]
                res[f"count{count}_turns_ms"] = {"package": (t[0], t[3]),
                                                 "variant": (t[1], t[2])}
        out["variants"][name] = res
        print(name, json.dumps(res))
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
