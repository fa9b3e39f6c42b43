#!/usr/bin/env python3
"""The tiled volumetric chunk on the card: its registers, bit-equality
with the streaming launch sequence, and where its time goes.

    python3 tools/vol_tiled_probe.py

512x512x8 (the JAX package's banded size, ri 10; the tiled chunk
``prost_vol_chunk_tiled``: the cooperative launch, the finish and after an
odd count the copy back) from random volumes, in place on buffers made
once:

* ptxas's register and spill lines of every ``vol_tiled<L>`` instance;
* the tiled chunk against the streaming sequence from the same inputs,
  counts 10, 3 and 1, the rule's tile and others, the three data terms
  and the 556-row halo band of one shard: volumes, previous iterates and
  squared norms bit-equal;
* timed with CUDA events (10 calls after a warm-up) and traced
  (``chip_smoke.traced_call``: the hand-written kernels' device ms): by
  tile (the shape rule's and others that fit), by count at the rule's
  tile (1, 2, 4, 10: the cost of an iteration and of a call's fixed part,
  the last iteration's norm terms, the norm pass and the finish), the
  streaming sequence beside it, and the band both ways;
* the traced device ms of each kernel of the call at count 2
  (``vol_tiled``, ``pdhg_finish``);
* variants of ``csrc/fused_vol.cu`` built beside it (``VARIANTS``: the
  source or a header it includes with a substitution, compiled with the
  package's nvcc flags into a directory of its own under
  ``prost_tpu_torch/_build/exp/``), each first checked bit-equal to the
  package's kernel from the same inputs, then timed in turns with it
  (package, variant, variant, package) at counts 10 and 2; the
  ``DIAGNOSTIC`` ones, which leave out part of the work and so cannot be
  bit-equal, are timed all the same, to apportion the call's fixed
  cost.

Prints the card line and one JSON object last.  Needs a CUDA card.
"""

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N, L, RI, LMB = 512, 8, 10, 6.0

# name: substitutions (file of csrc, old, new) on csrc/fused_vol.cu and
# the headers it includes
VARIANTS = {
    # the window's loads as plain loads and shared-memory stores
    "plain loads": [
        ("cp_async.cuh",
         "#ifdef __CUDA_ARCH__\n  asm volatile(\"cp.async.ca",
         "#if 0\n  asm volatile(\"cp.async.ca"),
    ],
    # the last iteration's w_hat through u_prev's plane in device memory
    # (written by the primal step, read back after the block's barrier)
    "w_hat through u_prev's plane": [
        ("fused_vol.cu", "        WH[l * tn + (i - R0) * ty + (j - C0)] =\n",
         "        up[l * n + g] =\n"),
        ("fused_vol.cu",
         "      const float wh = WH[l * tn + (i - R0) * ty + (j - C0)];",
         "      const float wh = up[gl];"),
    ],
    # diagnostic: no iteration is the last (no widened window, previous
    # iterate or norm terms)
    "no last iteration's norm work": [
        ("fused_vol.cu", "                             it == count - 1, "
         "smem);", "                             false, smem);"),
    ],
    # diagnostic: no norm pass after the last barrier
    "no norm pass": [
        ("fused_vol.cu", "  tiled_tile_partials<VT_THREADS>(nx, ny, "
         "a.partial, smem,", "  if (nx < 0) tiled_tile_partials<VT_THREADS>"
         "(nx, ny, a.partial, smem,"),
    ],
    # diagnostic: the last iteration's window not widened
    "no widened window": [
        ("fused_vol.cu", "  const int e = last ? 1 : 0;", "  const int e = 0;"),
    ],
    # diagnostic: no previous dual written
    "no previous q": [
        ("fused_vol.cu", """          qp[gv] = qx;
          qp[nl + gv] = qy;
          qp[2 * nl + gv] = ql;
""", ""),
    ],
}
DIAGNOSTIC = ("no last iteration's norm work", "no norm pass",
              "no widened window", "no previous q")


def build_variant(name, subs):
    """``csrc/fused_vol.cu`` with ``subs`` applied (a changed header beside
    the copy, which its quoted include finds first), built into a
    directory of its own under ``_build/exp/``: (the loaded library, its
    ptxas lines)."""
    from prost_tpu_torch.ops import cuda_build

    out = os.path.join(cuda_build.BUILD_DIR, "exp", "vol_" + "".join(
        c if c.isalnum() else "_" for c in name))
    os.makedirs(out, exist_ok=True)
    texts = {}
    for fname, old, new in subs + [("fused_vol.cu", "", "")]:
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
    stem = os.path.join(out, "fused_vol")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                           "-I", cuda_build.CSRC, "-o", stem + ".so",
                           stem + ".cu"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name!r}: nvcc failed:\n{proc.stderr}")
    return ctypes.CDLL(stem + ".so"), tiled_report(proc.stderr)


def typed(lib):
    """The tiled entry point of a variant's library with the package's
    argument types."""
    from prost_tpu_torch.ops.pdhg_chunk import CI, VP

    lib.prost_vol_chunk_tiled.argtypes = [VP] * 9 + [CI] * 7 + [VP]
    lib.prost_vol_chunk_tiled.restype = CI
    return lib


def tiled_report(log):
    """ptxas's register and spill lines of the vol_tiled<L> instances in a
    build log."""
    out, mine = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mine = "vol_tiled" in ln and "settle" not in ln
            if mine:
                out.append(ln.strip().split("'")[1])
        elif mine and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("vol_tiled_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import prost_tpu_torch as ptt
    from prost_tpu_torch.ops import cuda_build
    from prost_tpu_torch.ops import fused_vol as fv
    from prost_tpu_torch.ops.pdhg_chunk import S_CONV, S_LEN, S_NORM
    from prost_tpu_torch.parallel.spatial_fused import window

    ptt.set_device("cuda:0")
    dev = ptt.device()
    card = cs.card_line()
    print(card)
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        base = pool.submit(fv._lib)
        built = {name: pool.submit(build_variant, name, subs)
                 for name, subs in VARIANTS.items()}
        base.result()
        built = {name: fut.result() for name, fut in built.items()}
    lib = fv._lib()
    out = {"card": card,
           "ptxas": tiled_report(cuda_build.load("fused_vol").log)}
    print("ptxas", out["ptxas"])
    sms, tsmem = fv.card_sms(dev), fv.vol_tiled_limit(dev)
    init = cs.vol_kernel_inputs(L, N, N, 7, dev)
    rule = fv.vol_tiled_tile(N, N, L, sms, tsmem)
    out.update({"rule_tile": rule, "smem_limit": tsmem})

    def buffers(planes, nx, band):
        state = [t.clone() for t in planes[:2]]
        prev = [t.clone() for t in state]
        sc = torch.zeros(S_LEN, device=dev)
        head = [0.9, 1.1, 1.0, LMB, 1.0]
        sc[:len(head) + len(band)] = torch.tensor(head + list(band),
                                                  device=dev)
        partial = torch.empty(4 * lib.prost_vol_num_blocks(nx, N),
                              device=dev)
        return state, prev, sc, partial

    def caller(bufs, planes, nx, route, count=RI, nxg=None, dt="square"):
        state, prev, sc, partial = bufs
        scratch = fv._scratch(route[0], 0, L, nx, N, dev)
        what = "vol_chunk" if nxg is None else "vol_chunk_halo"

        def call():
            fv._launch_chunk(what, state, prev, planes[2], planes[3], sc,
                             partial, scratch, route, count, dt, nxg)
        return call

    def outputs(bufs, planes, call):
        state, prev, sc, _ = bufs
        for t, v in zip(state, planes[:2]):
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

    def device_ms(call):
        return cs.traced_call(call)["csrc_ms"]

    def per_kernel_ms(call):
        """The device ms of each kernel one call of ``call`` runs, by
        name (torch.profiler)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        got = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                k = cs.kernel_name(e.name)
                got[k] = got.get(k, 0.0) + e.time_range.elapsed_us() * 1e-3
        return got

    bufs = buffers(init, N, ())
    streaming = ("streaming", None)
    equal = {}
    for count, dt in ((RI, "square"), (3, "square"), (1, "square"),
                      (RI, "wsquare"), (3, "abs")):
        want = outputs(bufs, init, caller(bufs, init, N, streaming, count,
                                          dt=dt))
        for tile in (rule, (24, 32), (8, 32), (8, 64)):
            got = outputs(bufs, init, caller(bufs, init, N, ("tiled", tile),
                                             count, dt=dt))
            equal[f"{dt} count {count} tile {tile}"] = all(
                torch.equal(a, b) for a, b in zip(got, want))
    H = 2 * RI + 2
    band = [window(a, -H, N + H) for a in init]
    nb = N + 2 * H
    bbufs = buffers(band, nb, (-H, H, H + N))
    brule = fv.vol_tiled_tile(nb, N, L, sms, tsmem)
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
    for tile in (rule, (24, 32), (16, 64), (8, 128), (16, 32), (8, 64)):
        if fv.vol_tiled_bytes(*tile, L) <= tsmem and str(tile) not in tiles:
            tiles[str(tile)] = ms(caller(bufs, init, N, ("tiled", tile)))
    out["by_tile_ms"] = tiles
    counts = (1, 2, 4, RI)
    out["by_count_ms"] = {c: ms(caller(bufs, init, N, ("tiled", rule), c))
                          for c in counts}
    out["by_count_device_ms"] = {
        c: device_ms(caller(bufs, init, N, ("tiled", rule), c))
        for c in counts}
    out["kernel_device_ms"] = {
        c: per_kernel_ms(caller(bufs, init, N, ("tiled", rule), c))
        for c in (2, RI)}
    out["streaming_ms"] = ms(caller(bufs, init, N, streaming))
    out["streaming_device_ms"] = device_ms(caller(bufs, init, N, streaming))
    for key, by in (("", out["by_count_ms"]),
                    ("device_", out["by_count_device_ms"])):
        it = (by[RI] - by[2]) / (RI - 2)
        out[f"{key}iteration_ms"] = it
        out[f"{key}fixed_ms"] = by[2] - 2 * it
    out["band"] = {"rule_tile": brule, "tiled_ms": ms(caller(
        bbufs, band, nb, ("tiled", brule), nxg=N)), "streaming_ms": ms(
        caller(bbufs, band, nb, streaming, nxg=N))}
    print(json.dumps(out))

    def direct(vlib, count=RI):
        """The tiled chunk through library ``vlib``'s entry point."""
        state, prev, sc, partial = bufs
        scratch = fv._scratch("tiled", 0, L, N, N, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (*state, *prev, init[2], init[3], sc,
                                       partial, *scratch)]

        def call():
            rc = vlib.prost_vol_chunk_tiled(*ptrs, L, N, N, count, 0, *rule,
                                            stream)
            if rc:
                raise RuntimeError(f"prost_vol_chunk_tiled: CUDA error {rc}")
        return call

    want = outputs(bufs, init, direct(lib))
    out["variants"] = {}
    for name, (vlib, report) in built.items():
        vlib = typed(vlib)
        got = outputs(bufs, init, direct(vlib))
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        res = {"bit_equal": same, "ptxas": report}
        if same or name in DIAGNOSTIC:
            for count in (RI, 2):
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
