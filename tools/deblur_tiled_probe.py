#!/usr/bin/env python3
"""Where the tiled deblur chunk's time goes on the card, and what the parts
of its design are worth.

    python3 tools/deblur_tiled_probe.py [--pr23 CSRC_DIR] [--ptxas]
                                        [--step0]

BASELINE config 2's 9x9 45-degree motion blur (7 taps) at 2048x2048 (ri
10, the tiled chunk ``prost_deblur_chunk_tiled``: the cooperative launch
and the finish) from random planes, in place on buffers made once:

* the tiled chunk against the streaming sequence from the same inputs,
  counts 10, 3 and 1: planes and squared norms bit-equal;
* timed with CUDA events (10 calls after a warm-up): by tile (the shape
  rule's and others the launch takes), by count at the rule's tile (1, 2,
  10: the cost of an iteration and of a call's fixed part, the norm pass
  and the finish), and the streaming sequence beside it;
* by tap count at 1024x1024 (config 2's 7 taps and full 3x3, 5x5, 7x7
  and 9x9 blurs of 9, 25, 49 and 81), the tiled chunk at its rule's tile
  (and PR 23's kernel, with ``--pr23``) against
  the streaming sequence in turns, each checked bit-equal first, and the
  route ``deblur_route_of`` picks there;
* variants (``VARIANTS``: ``fused_deblur.cu`` of the package or of the
  ``--pr23`` directory, PR 23's design, with substitutions, compiled with
  the package's nvcc flags into a directory of its own under
  ``prost_tpu_torch/_build/exp/``), each first checked bit-equal to the
  streaming sequence from the same inputs, then timed in turns with its
  base (base, variant, variant, base); a variant that need not be
  bit-equal (a stencil without its masks, a step left out: the parts of
  an iteration and of the fixed part) is timed only, at counts 1, 2 and
  10.  ``--pr23`` names a ``csrc`` directory holding PR 23's
  ``fused_deblur.cu`` and its headers (``git archive`` of an earlier
  commit unpacked into a git-ignored directory); the variants on it, PR
  23's kernel as it was among them, run only then.  ``--step0`` runs the
  variants on PR 23's kernel and its by-count breakdown only.
  ``--ptxas`` builds the package and the variants and prints ptxas's
  registers, stack frames and spills of deblur_tiled, timing nothing.

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

N, RI, LMB = 2048, 10, 100.0

# PR 23's tiled iteration: the calls its step 0 variants replace
_PR23_PRIMAL = ("        xn = xv - k.tau_s * kty_at(YV, QX, QY, a, r, i, j, "
                "t);")
_PR23_DUAL = ("      const float bx2 = conv_fwd(XN, a, r, i, j, t);\n"
              "      const float bxv = conv_fwd(X, a, r, i, j, t);  "
              "// the carried B x")
_PR23_ANCHOR = "// The scalars of a launch as the streaming kernels form them."
# the stencils of PR 23's window with no per-tap test (step 0, timed only)
_NOMASK = """template <typename T>
__device__ __forceinline__ float conv_nomask(const TWin& u, int i, int j,
                                             const T& t) {
  TreeSum s;
#pragma unroll
  for (int k = 0; k < t.n; ++k) s.add(t.w[k] * u.at(i - t.dx[k], j - t.dy[k]));
  return s.total();
}

template <typename T>
__device__ __forceinline__ float kty_nomask(const TWin& yv, const TWin& qx,
                                            const TWin& qy, int i, int j,
                                            const T& t) {
  TreeSum s;
#pragma unroll
  for (int k = 0; k < t.n; ++k)
    s.add(t.w[k] * yv.at(i + t.dx[k], j + t.dy[k]));
  float dxt = qx.at(i - 1, j) - qx.at(i, j);
  float dyt = qy.at(i, j - 1) - qy.at(i, j);
  return (s.total() + dxt) + dyt;
}

"""

def _THREADS(threads):
    """The substitution of a tiled launch of blocks of ``threads`` for a
    tap count known when compiling."""
    return [("fused_deblur.cu", "  return n > 0 ? 768 : 640;",
             f"  return n > 0 ? {threads} : 640;")]


# name: (base ("package" or "pr23"), substitutions (file of the base's
# csrc, old, new) on fused_deblur.cu and the headers it includes, its tile
# (None: the shape rule's), whether it must be bit-equal to the streaming
# sequence; one that need not is timed only, at counts 1, 2 and 10)
VARIANTS = {
    # every window's stencils tested (the edge windows' form)
    "every window tested": ("package", [
        ("fused_deblur.cu", "  return g.r0 >= 0 && g.r0 + r.off >= 0",
         "  return false && g.r0 >= 0 && g.r0 + r.off >= 0"),
    ], None, True),
    # the window's loads as plain loads and shared-memory stores
    "plain loads": ("package", [
        ("cp_async.cuh",
         "#ifdef __CUDA_ARCH__\n  asm volatile(\"cp.async.ca",
         "#if 0\n  asm volatile(\"cp.async.ca"),
    ], None, True),
    # where an iteration's time goes (timed only): a window that returns
    # after its loads, after its primal step; the dual step with f_b and
    # Sigma_v not read from device memory; no norm pass
    "loads only": ("package", [
        ("fused_deblur.cu",
         "  // 2. deblur_primal on rows [R0 - reach, R1], columns "
         "[C0 - reach, C1]\n", "  if (h > 0) return;\n"),
    ], None, False),
    "loads and primal": ("package", [
        ("fused_deblur.cu",
         "  // 3. deblur_dual at the owned pixels, into slot (ox, oyv, oq); a\n",
         "  if (h > 0) return;\n"),
    ], None, False),
    "no f_b, Sigma_v reads": ("package", [
        ("fused_deblur.cu",
         "    const float svv = svn, fbv = fbn;",
         "    const float svv = 1.5f, fbv = 0.5f;"),
    ], None, False),
    "no norm pass": ("package", [
        ("fused_deblur.cu",
         "  const int warps = (int)blockDim.x / BX;\n",
         "  if (count > 0) return;\n  const int warps = (int)blockDim.x / BX;\n"),
    ], None, False),
    # 32 warps of 64 registers a thread; 16 warps of 128
    "1024 threads": ("package", _THREADS(1024), None, True),
    "512 threads": ("package", _THREADS(512), None, True),
    # one set of the window's planes at the rule's tile: no loads under the
    # stencils
    "one set": ("package", [
        ("fused_deblur.cu",
         "  int two = smem == deblur_tiled_smem(tx, ty, h, true);",
         "  int two = 0;"),
    ], None, True),
    # PR 23's kernel as it was (its own tile rule's 104x64)
    "pr23": ("pr23", [], (104, 64), True),
    # another version of the package's kernel (--other), at 104x64
    "other": ("other", [], (104, 64), True),
    # step 0: PR 23's window stencils with no per-tap mask (wrong at the
    # edges of the planes: timed only)
    "pr23 no masks": ("pr23", [
        ("fused_deblur.cu", _PR23_ANCHOR, _NOMASK + _PR23_ANCHOR),
        ("fused_deblur.cu", _PR23_PRIMAL,
         "        xn = xv - k.tau_s * kty_nomask(YV, QX, QY, i, j, t);"),
        ("fused_deblur.cu", _PR23_DUAL,
         "      const float bx2 = conv_nomask(XN, i, j, t);\n"
         "      const float bxv = conv_nomask(X, i, j, t);"),
    ], (104, 64), False),
    # step 0: the two slots copied by value once an iteration (their
    # pointers and ints then in registers) in place of references chosen
    # at run time between the kernel's two parameter structs
    "pr23 slots by value": ("pr23", [
        ("fused_deblur.cu",
         "    const DB& src = (it & 1) ? b : a;\n"
         "    const DB& dst = (it & 1) ? a : b;",
         "    const DB src = (it & 1) ? b : a;\n"
         "    const DB dst = (it & 1) ? a : b;"),
    ], (104, 64), True),
    # step 0: the old B x carried in a plane of each slot (written by the
    # dual step, read by the next one) in place of its second convolution
    "pr23 carried B x": ("pr23", [
        ("fused_deblur.cu",
         "    const TiledScal& k, int tile, int tx, int ty, int h, bool last,",
         "    const TiledScal& k, int tile, int tx, int ty, int h, bool last,"
         " bool first,"),
        ("fused_deblur.cu",
         "      const float bxv = conv_fwd(X, a, r, i, j, t);  "
         "// the carried B x",
         "      const float bxv = first ? conv_fwd(X, a, r, i, j, t) "
         ": src.bx[p2];\n      dst.bx[p2] = bx2;"),
        ("fused_deblur.cu",
         "      tiled_iteration(src, dst, a, r, k, tile, tx, ty, h, "
         "it == count - 1,",
         "      tiled_iteration(src, dst, a, r, k, tile, tx, ty, h, "
         "it == count - 1, it == 0,"),
        ("fused_deblur.cu", "  b.q = b.yv + m2;\n",
         "  b.q = b.yv + m2;\n  a.bx = b.q + 2 * n;\n  b.bx = a.bx + m2;\n"),
    ], (104, 64), True),
    # step 0's breakdown of PR 23's iteration and fixed part (timed only):
    # a window that returns before its loads (the walk, the block and
    # grid barriers), after its loads, after its primal step
    "pr23 barriers only": ("pr23", [
        ("fused_deblur.cu",
         "  // 1. the window of the state, zero outside the planes\n",
         "  if (tx > 0) return;\n"),
    ], (104, 64), False),
    "pr23 loads only": ("pr23", [
        ("fused_deblur.cu",
         "  // 2. deblur_primal on rows [R0 - reach, R1], columns "
         "[C0 - reach, C1]\n",
         "  if (tx > 0) return;\n"),
    ], (104, 64), False),
    "pr23 loads and primal": ("pr23", [
        ("fused_deblur.cu",
         "  // 3. deblur_dual at the owned pixels, into slot dst\n",
         "  if (tx > 0) return;\n"),
    ], (104, 64), False),
    # ... and a launch with no norm pass, with the norm pass but no copy
    # back, with no finish
    "pr23 no norm pass": ("pr23", [
        ("fused_deblur.cu",
         "  tiled_tile_partials<DT_THREADS>(nx2, ny2, a.partial, smem,",
         "  if (count > 0) return;\n"
         "  tiled_tile_partials<DT_THREADS>(nx2, ny2, a.partial, smem,"),
    ], (104, 64), False),
    "pr23 no copy back": ("pr23", [
        ("fused_deblur.cu", "    if (back) {\n      const size_t p2",
         "    if (back && count < 0) {\n      const size_t p2"),
    ], (104, 64), False),
    "pr23 no finish": ("pr23", [
        ("fused_deblur.cu",
         "  pdhg_finish<<<1, FIN, 0, st>>>(a.sc, a.partial, "
         "(int)(g.x * g.y), count,",
         "  if (count < 0) pdhg_finish<<<1, FIN, 0, st>>>(a.sc, a.partial, "
         "(int)(g.x * g.y), count,"),
    ], (104, 64), False),
}
STEP0 = [name for name in VARIANTS if name.startswith("pr23")]

# tiles the launch takes at config 2's halo of 8, beside the rule's: for
# each column count the most rows whose window fits and fewer
TILES = tuple((tx, ty) for ty in (32, 64, 96, 128, 160, 192, 224, 256)
              for tx in (8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104,
                         120, 136, 152, 168)
              if 20 * (tx + 16) * (ty + 16) <= 232448)

# tiles beside the rule's whose iteration and fixed part are split too
TILES_BY_COUNT = ((40, 96), (24, 128))

# the tap-count sweep at 1024x1024: kernels (ky, kx), and tiles beside
# the rule's
SWEEP_N = 1024
SWEEP_TILES = ((88, 32), (48, 64), (72, 64), (40, 96), (32, 96), (24, 128),
               (104, 64))


def sweep_kernels():
    import numpy as np

    import chip_smoke as cs

    def full(k):
        ker = np.arange(1.0, k * k + 1.0).reshape(k, k)
        return ker / ker.sum()

    return {"7 taps (config 2)": cs.motion_kernel(), "9 taps (full 3x3)":
            full(3), "25 taps (full 5x5)": full(5), "49 taps (full 7x7)":
            full(7), "81 taps (full 9x9)": np.full((9, 9), 1.0 / 81)}


def build_variant(name, csrc, subs):
    """``fused_deblur.cu`` of the directory ``csrc`` with ``subs`` applied
    (a changed header beside the copy, which its quoted include finds
    first), built into a directory of its own under ``_build/exp/``: (the
    loaded library, its ptxas lines of deblur_tiled)."""
    from prost_tpu_torch.ops import cuda_build

    out = os.path.join(cuda_build.BUILD_DIR, "exp", "deblur_" + "".join(
        c if c.isalnum() else "_" for c in name))
    os.makedirs(out, exist_ok=True)
    texts = {}
    for fname, old, new in subs + [("fused_deblur.cu", "", "")]:
        if fname not in texts:
            with open(os.path.join(csrc, fname)) as fh:
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
                           "-I", csrc, "-o", stem + ".so", stem + ".cu"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name!r}: nvcc failed:\n{proc.stderr}")
    return ctypes.CDLL(stem + ".so"), tiled_report(proc.stderr)


def tiled_report(log):
    """ptxas's register, stack-frame and spill lines of deblur_tiled (each
    instantiation, by its tap count) in a build log."""
    out, mine = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mine = None
            if "12deblur_tiledILi" in ln:  # deblur_tiled<N>
                mine = ("N " + ln.split("12deblur_tiledILi")[1]
                        .split("E")[0])
        elif mine and ("registers" in ln or "spill" in ln
                       or "stack" in ln):
            out.append(f"{mine}: {ln.strip()}")
    return out


def brief(report):
    """The register, stack and spill lines of deblur_tiled<7> (config 2's
    taps) and deblur_tiled<0> (more than 8) of a ptxas report."""
    return [ln for ln in report if ln.startswith(("N 7:", "N 0:"))]


def finish(card, out, step0):
    """Write ``out`` whole under ``chiprun_out/`` and print the card line
    and ``out`` without the variants' ptxas lines last."""
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "deblur_tiled_probe"
                        + ("_step0" if step0 else "") + ".json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    short = dict(out)
    short.pop("variant_ptxas", None)
    short["variants"] = {name: {k: v for k, v in res.items() if k != "ptxas"}
                         for name, res in out.get("variants", {}).items()}
    print(card)
    print(json.dumps(short))


def typed(lib, host_taps=True):
    """``lib``'s tiled entry point typed: with ``host_taps`` the package's,
    which also takes the taps on the host; PR 23's without."""
    from prost_tpu_torch.ops.pdhg_chunk import CF, CI, VP

    lib.prost_deblur_chunk_tiled.argtypes = ([VP] * 12 + [CI] * 6 + [CF] * 4
                                             + [CI] * 4
                                             + [VP] * (2 if host_taps else 1))
    lib.prost_deblur_chunk_tiled.restype = CI
    lib.host_taps = host_taps
    return lib


class Planes:
    """Random planes of an (n, n) problem under ``kern`` on the card, the
    state's copies the calls work on in place, and the calls of each
    path on them."""

    def __init__(self, n, kern, seed, dev):
        import numpy as np
        import torch

        from prost_tpu_torch.ops import fused_deblur as fd
        from prost_tpu_torch.ops.pdhg_chunk import S_LEN

        self.taps = fd.kernel_taps(torch.as_tensor(kern.T,
                                                   dtype=torch.float32))
        self.n = n
        self.nx2, self.ny2 = n + kern.shape[1] - 1, n + kern.shape[0] - 1
        rng = np.random.RandomState(seed)
        arrs = (rng.rand(n, n), rng.randn(self.nx2, self.ny2),
                0.3 * rng.randn(2, n, n), rng.rand(self.nx2, self.ny2),
                0.5 + rng.rand(self.nx2, self.ny2))
        self.init = [torch.from_numpy(a.astype(np.float32)).to(dev)
                     for a in arrs]
        self.state = [t.clone() for t in self.init[:3]]
        self.prev = [t.clone() for t in self.init[:3]]
        self.fb, self.sv = self.init[3], self.init[4]
        self.taps_t = fd.taps_array(self.taps, dev)
        self.sc = torch.zeros(S_LEN, device=dev)
        self.sc[:5] = torch.tensor([0.9, 1.1, 1.0, LMB, 1.0], device=dev)
        self.partial = torch.empty(
            4 * fd._lib().prost_deblur_num_blocks(self.nx2, self.ny2),
            device=dev)
        # room for the package's scratch and for PR 23's with a carried
        # plane of B x a slot
        nn, m2 = n * n, self.nx2 * self.ny2
        self.scratch = torch.empty(max(fd._scratch(
            "tiled", n, n, self.nx2, self.ny2, dev)[0].numel(),
            3 * nn + 3 * m2), device=dev)
        self.carried = fd._scratch("streaming", n, n, self.nx2, self.ny2,
                                   dev)
        self.h = fd.deblur_tiled_halo(self.taps)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def tiled(self, lib, tile, count=RI):
        ptrs = [t.data_ptr() for t in (*self.state, *self.prev, self.fb,
                                       self.sv, self.taps_t, self.sc,
                                       self.partial, self.scratch)]
        n, h, ntaps = self.n, self.h, len(self.taps)
        nx2, ny2, stream = self.nx2, self.ny2, self.stream
        roots = (0.5, 0.2, 0.5 ** 0.5, 0.2 ** 0.5)
        from prost_tpu_torch.ops import fused_deblur as fd

        extra = ((fd.host_taps(self.taps),)
                 if getattr(lib, "host_taps", True) else ())

        def call():
            rc = lib.prost_deblur_chunk_tiled(*ptrs, n, n, nx2, ny2, ntaps,
                                              h, *roots, 0, count, *tile,
                                              *extra, stream)
            if rc:
                raise RuntimeError(f"prost_deblur_chunk_tiled: CUDA error "
                                   f"{rc}")
        return call

    def streaming(self, count=RI):
        from prost_tpu_torch.ops import fused_deblur as fd

        def call():
            fd._launch_chunk("deblur_chunk", self.state, self.prev, self.fb,
                             self.sv, self.taps_t, self.sc, self.partial,
                             self.carried, ("streaming", None), count,
                             self.taps, 0.5, 0.2)
        return call

    def outputs(self, call):
        """The state, previous iterate and squared norms ``call`` leaves
        from the initial planes."""
        import torch

        from prost_tpu_torch.ops.pdhg_chunk import S_CONV, S_NORM

        for t, v in zip(self.state, self.init[:3]):
            t.copy_(v)
        self.sc[S_CONV] = 0.0
        self.sc[S_NORM:S_NORM + 4] = 0.0
        call()
        torch.cuda.synchronize()
        return ([t.clone() for t in self.state]
                + [t.clone() for t in self.prev]
                + [self.sc[S_NORM:S_NORM + 4].clone()])


def ms(call, reps=10):
    import torch

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


def split(by_count):
    """(an iteration's ms, a call's fixed ms) from the times at counts 1
    and RI."""
    it = (by_count[RI] - by_count[1]) / (RI - 1)
    return it, by_count[1] - it


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--pr23", help="a csrc directory holding PR 23's "
                    "fused_deblur.cu, for the variants on it")
    ap.add_argument("--other", help="a csrc directory holding another "
                    "version of the package's fused_deblur.cu, timed in turns "
                    "with it as the variant \"other\"")
    ap.add_argument("--ptxas", action="store_true", help="build the package "
                    "and the variants, print ptxas's lines of deblur_tiled, "
                    "time nothing")
    ap.add_argument("--step0", action="store_true", help="only the variants "
                    "on PR 23's kernel and its breakdown")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("deblur_tiled_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import prost_tpu_torch as ptt
    from prost_tpu_torch.ops import cuda_build
    from prost_tpu_torch.ops import fused_deblur as fd

    ptt.set_device("cuda:0")
    dev = ptt.device()
    card = cs.card_line()
    print(card)
    bases = {"package": cuda_build.CSRC, "pr23": opts.pr23,
             "other": opts.other}
    # the step 0 variants only with --step0; else PR 23's kernel beside
    # the package's variants
    chosen = {name: v for name, v in VARIANTS.items() if bases[v[0]]
              and (name in STEP0) == opts.step0 or name == "pr23"
              and opts.pr23 or name == "other" and opts.other}
    with ThreadPoolExecutor(len(chosen) + 1) as pool:
        base = pool.submit(fd._lib)
        built = {name: pool.submit(build_variant, name, bases[v[0]], v[1])
                 for name, v in chosen.items()}
        base.result()
        built = {name: fut.result() for name, fut in built.items()}
    libs = {name: typed(lib, VARIANTS[name][0] != "pr23")
            for name, (lib, _) in built.items()}
    out = {"card": card,
           "ptxas": tiled_report(cuda_build.load("fused_deblur").log),
           "variant_ptxas": {name: rep for name, (_, rep) in built.items()}}
    print("ptxas", json.dumps({"package": brief(out["ptxas"]), **{
        name: brief(rep) for name, rep in out["variant_ptxas"].items()}}))
    if opts.ptxas:
        finish(card, out, opts.step0)
        return 0

    lib = fd._lib()
    sms, tsmem = fd.card_limits(dev)[0], fd.deblur_tiled_limit(dev)
    big = Planes(N, cs.motion_kernel(), 7, dev)
    rule = fd.deblur_tiled_tile(big.nx2, big.ny2, big.taps, sms, tsmem)
    out.update({"rule_tile": rule, "halo": big.h, "smem_limit": tsmem})
    if not opts.step0:
        equal = {}
        for count in (RI, 3, 1):
            want = big.outputs(big.streaming(count))
            got = big.outputs(big.tiled(lib, rule, count))
            equal[count] = [bool(torch.equal(a, b))
                            for a, b in zip(got, want)]
            print(f"count {count}: tiled against streaming, bit-equal "
                  f"{equal[count]}; norms {got[-1].tolist()}")
        out["bit_equal"] = equal
        if not all(all(v) for v in equal.values()):
            finish(card, out, opts.step0)
            return 1
        tiles = {}
        for tile in (rule, *TILES):  # "one set": a window too big for two
            nbytes = fd.deblur_tiled_bytes(*tile, big.taps, tsmem)
            key = str(tile) + ("" if nbytes == fd.deblur_tiled_bytes(
                *tile, big.taps) else " one set")
            if nbytes <= tsmem and key not in tiles:
                tiles[key] = ms(big.tiled(lib, tile))
        out["by_tile_ms"] = tiles
        by_count = {c: ms(big.tiled(lib, rule, count=c)) for c in (1, 2, RI)}
        out["by_count_ms"] = by_count
        out["iteration_ms"], out["fixed_ms"] = split(by_count)
        out["by_count_at_ms"] = {}
        for tile in TILES_BY_COUNT:
            bc = {c: ms(big.tiled(lib, tile, count=c)) for c in (1, 2, RI)}
            out["by_count_at_ms"][str(tile)] = {
                "by_count": bc, "iteration_and_fixed": split(bc)}
        out["streaming_ms"] = ms(big.streaming())
        print(json.dumps({k: out[k] for k in ("rule_tile", "by_tile_ms",
                                              "by_count_ms", "iteration_ms",
                                              "fixed_ms", "streaming_ms")}))

        # the tap-count sweep: each kernel's tiled chunk at its rule's tile
        # against the streaming sequence, in turns
        out["taps_sweep"] = {}
        for seed, (label, kern) in enumerate(sweep_kernels().items()):
            pl = Planes(SWEEP_N, kern, 20 + seed, dev)
            tile = fd.deblur_tiled_tile(pl.nx2, pl.ny2, pl.taps, sms, tsmem)
            res = {"taps": len(pl.taps), "tile": tile,
                   "route": fd.deblur_route_of(
                       pl.nx2, SWEEP_N, pl.ny2, pl.taps, sms,
                       fd.card_limits(dev)[1], tsmem)}
            want = pl.outputs(pl.streaming())
            got = pl.outputs(pl.tiled(lib, tile))
            res["bit_equal"] = all(torch.equal(a, b)
                                   for a, b in zip(got, want))
            if res["bit_equal"]:
                # the streaming sequence, the package and each variant that
                # must be bit-equal (PR 23's kernel with --pr23), in turns
                names = ["streaming", "tiled"] + [
                    name for name, (vb, _, _, exact) in VARIANTS.items()
                    if name in libs and exact and vb != "other"]
                calls = [pl.streaming(), pl.tiled(lib, tile)] + [
                    pl.tiled(libs[name], tile) for name in names[2:]]
                t = [ms(c) for c in calls + calls[::-1]]
                res["turns_ms"] = {name: (t[i], t[-1 - i])
                                   for i, name in enumerate(names)}
            if res["bit_equal"]:  # the package at other tiles too
                res["by_tile_ms"] = {
                    str(tl): ms(pl.tiled(lib, tl)) for tl in SWEEP_TILES
                    if tl != tuple(tile) and fd.deblur_tiled_bytes(
                        *tl, pl.taps, tsmem) <= tsmem}
            out["taps_sweep"][label] = res
            print(label, json.dumps(res))
            del pl
            torch.cuda.empty_cache()

    want = big.outputs(big.streaming())
    out["variants"] = {}
    for name, vlib in libs.items():
        vbase, _, vtile, exact = VARIANTS[name]
        vrule = vtile or rule
        res = {"tile": vrule, "ptxas": brief(out["variant_ptxas"][name])}
        try:
            got = big.outputs(big.tiled(vlib, vrule))
        except RuntimeError as e:  # the variant refuses the tile
            res["refused"] = str(e)
            out["variants"][name] = res
            print(name, json.dumps(res))
            continue
        if exact:
            res["bit_equal"] = all(torch.equal(a, b)
                                   for a, b in zip(got, want))
            if not res["bit_equal"]:
                out["variants"][name] = res
                print(name, json.dumps(res))
                continue
        blib, btile = ((libs["pr23"], (104, 64)) if vbase == "pr23"
                       else (lib, rule))
        t = [ms(big.tiled(x, tl)) for x, tl in ((blib, btile), (vlib, vrule),
                                                (vlib, vrule), (blib, btile))]
        res["turns_ms"] = {"pr23" if vbase == "pr23" else "package":
                           (t[0], t[3]), "variant": (t[1], t[2])}
        if not exact or name == "pr23":
            by_count = {c: ms(big.tiled(vlib, vrule, count=c))
                        for c in (1, 2, RI)}
            res["by_count_ms"] = by_count
            res["iteration_ms"], res["fixed_ms"] = split(by_count)
        out["variants"][name] = res
        print(name, json.dumps(res))
    finish(card, out, opts.step0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
