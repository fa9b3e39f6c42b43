#!/usr/bin/env python3
"""Where the tiled ROF chunk's time goes on the card, and what the parts of
its design are worth.

    python3 tools/rof_tiled_probe.py [--old CSRC_DIR] [--step0] [--ptxas]

The tiled launch ``rof_tiled`` (csrc/fused_rof.cu) serves three rows: the
chunk (``prost_rof_chunk_tiled``: the launch, the finish and the copy
back) at 2048x2048 and 2048x1536 and on the 2092x2048 halo band of config
1's sharded route, the multichunk (``prost_rof_multichunk_tiled``, 8
chunks under boyd at 2048x2048) and the batched chunk
(``prost_rof_chunk_batched_tiled``: B = 4 of 2048x2048, 2 of 1280x1280, 8
of 512x512).  Every case runs at ri 10 from random planes with mass on
the dead duals, in place on buffers made once:

* each case's tiled call at the shape rule's tile against the streaming
  sequence from the same inputs (counts 10, 3 and 1, the three data terms
  at 2048x2048): planes, previous iterates and squared norms (the
  multichunk's scalars) bit-equal;
* timed with CUDA events (10 calls after a warm-up) in turns with the
  streaming sequence and, with ``--old``, with the kernel of that
  directory (streaming, package, old, old, package, streaming), each
  first checked bit-equal;
* by count at the rule's tile (1, 2 and 10: an iteration's cost and a
  call's fixed part) at 2048x2048, for B = 4 and on the band;
* at every tile the launch takes, at each shape but the multichunk's:
  the rule's tile (``tiled_tile``, lane rows) against the one of
  ``window_tile``'s measure (window pixels) and the fastest;
* variants (``VARIANTS``: ``fused_rof.cu`` of the package or of the
  ``--old`` directory with substitutions, compiled with the package's
  nvcc flags into a directory of their own under
  ``prost_tpu_torch/_build/exp/``), each first checked bit-equal to the
  streaming sequence where it must be, then timed in turns with its base
  (base, variant, variant, base) at 2048x2048; a variant that need not
  be bit-equal (a step or a phase left out, a stencil without its tests)
  is timed only, at counts 1, 2 and 10.

``--old`` names a ``csrc`` directory holding an earlier
``fused_rof.cu`` and its headers (``git archive`` of an earlier commit
unpacked into a git-ignored directory).  ``--step0`` runs only the
variants on the old kernel (the package's where ``--old`` is not given)
and its breakdown.  ``--ptxas`` builds the package and the variants and
prints ptxas's registers, stack frames and spills of rof_tiled<0..2>,
timing nothing.

Prints the card line and one JSON object last, and writes it whole to
``chiprun_out/rof_tiled_probe*.json``.  Needs a CUDA card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

RI, LMB = 10, 2.0

# the "L2 prefetch of the next round" variant's code, after the window loads
PREFETCH = """  {
    unsigned nsm;
    asm("mov.u32 %0, %%nsmid;" : "=r"(nsm));
    const unsigned nb = gridDim.x * gridDim.y * gridDim.z;
    const unsigned nxt =
        blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z) + nsm;
    if (nxt < nb) {
      const int bx = nxt % gridDim.x, by = nxt / gridDim.x % gridDim.y;
      const size_t bz = nxt / (gridDim.x * gridDim.y);
      const int R0 = by * a.tx, C0 = bx * a.ty;
      const int r0 = max(R0 - a.count - 1, 0), c0 = max(C0 - a.count - 1, 0);
      const int r1 = min(R0 + a.tx + a.count, a.nx);
      const int c1 = min(C0 + a.ty + a.count, a.ny);
      const size_t n = (size_t)a.nx * a.ny;
      const int lines = (c1 - c0 + 31) / 32 + 1, rows = r1 - r0;
      const int planes = DT == DT_WSQUARE ? 5 : 4;
      for (int t = threadIdx.x; t < planes * rows * lines; t += TL_THREADS) {
        const int l = t % lines, rr = t / lines % rows, p = t / lines / rows;
        const float* base = p == 0   ? a.x + bz * n
                            : p == 1 ? a.q + 2 * bz * n
                            : p == 2 ? a.q + (2 * bz + 1) * n
                            : p == 3 ? a.f + bz * n
                                     : a.w + bz * n;
        const float* ptr =
            base + (size_t)(r0 + rr) * a.ny + min(c0 + 32 * l, c1 - 1);
        asm volatile("prefetch.global.L2 [%0];" ::"l"(ptr));
      }
    }
  }
"""

# name: (base ("package" or "old"), substitutions (file of the base's csrc,
# old, new), its tile (None: the rule's), whether it must be bit-equal to
# the streaming sequence; one that need not is timed only, at counts 1, 2
# and 10)
VARIANTS = {
    # the earlier kernel as it was, at the rule's tile
    "old": ("old", [], None, True),
    # the package's kernel with every window's stencils tested (the edge
    # windows' form); its window loads as plain loads and stores
    "every window tested": ("package", [
        ("fused_rof.cu", "  v.inner = !v.top && !v.bot",
         "  v.inner = false && !v.top && !v.bot"),
    ], None, True),
    "plain loads": ("package", [
        ("cp_async.cuh",
         "#ifdef __CUDA_ARCH__\n  asm volatile(\"cp.async.ca",
         "#if 0\n  asm volatile(\"cp.async.ca"),
    ], None, True),
    # where the package's time goes (timed only): a launch returning after
    # its loads; the primal step alone, the dual step alone; no norm pass
    # (the launch returns after its iterations); no copy back
    "loads only": ("package", [
        ("fused_rof.cu", "  __syncthreads();\n  {\n    const TStrip<CB> t("
         "sh.v.wh * S);\n    if (sh.v.inner)",
         "  __syncthreads();\n  if (a.count > 0) return;\n  {\n"
         "    const TStrip<CB> t(sh.v.wh * S);\n    if (sh.v.inner)"),
    ], None, False),
    "primal only": ("package", [
        ("fused_rof.cu", "    dual_strip<EDGE, false>(sh, t, e, it, gx, gy);",
         "    if (c < 0) dual_strip<EDGE, false>(sh, t, e, it, gx, gy);"),
    ], None, False),
    "dual only": ("package", [
        ("fused_rof.cu", "    primal_strip<DT, EDGE, false>(sh, a, t, e, it);",
         "    if (c < 0) primal_strip<DT, EDGE, false>(sh, a, t, e, it);"),
    ], None, False),
    "no norm pass": ("package", [
        ("fused_rof.cu", "  // the four terms of each owned 32x8 tile in "
         "block_partials' tree\n", "  if (a.count > 0) return;\n"),
    ], None, False),
    # the window of the block one round on (the SM count later) prefetched
    # into L2 after the loads: a round's windows at 2048x2048 (132 of 4
    # planes of 93x117) are 23 MB, less than half the 50 MB L2
    "L2 prefetch of the next round": ("package", [
        ("fused_rof.cu", "  __syncthreads();\n  {\n    const TStrip<CB> t("
         "sh.v.wh * S);\n    if (sh.v.inner)",
         "  __syncthreads();\n" + PREFETCH + "  {\n"
         "    const TStrip<CB> t(sh.v.wh * S);\n    if (sh.v.inner)"),
    ], None, True),
    # the aligned step's scalars held in registers and each window's
    # planes its own rows apart (the package rereads the scalars and
    # spaces the planes a whole tile's window apart): as fast at the
    # smaller shapes, 3-8% slower at 2048x2048, on the band, in the
    # multichunk and at B = 4 on an H100
    "scalars held, window stride": ("package", [
        ("fused_rof.cu",
         "  const float tau0 = LAST ? 0.f : sh.k.tau, tl0 = tau0 * sh.k.lmb;\n"
         "  const float dt10 = DT == DT_SQUARE && !LAST ? 1.f / (1.f + tl0)"
         " : 0.f;\n"
         "  const unsigned own = LAST ? t.owned(sh, false) : 0u;",
         "  const float tau = sh.k.tau, tl = tau * sh.k.lmb;\n"
         "  const float dt1 = DT == DT_SQUARE ? 1.f / (1.f + tl) : 0.f;\n"
         "  const unsigned own = LAST ? t.owned(sh, false) : 0u;"),
        ("fused_rof.cu",
         "    if (k < k0 || k >= k1) continue;\n"
         "    const float tau = LAST ? sh.k.tau : tau0;\n"
         "    const float tl = LAST ? tau * sh.k.lmb : tl0;\n"
         "    const float dt1 = LAST && DT == DT_SQUARE ? 1.f / (1.f + tl) :"
         " dt10;\n"
         "    const float kty = kty_tile<EDGE>(t, e, up, k);",
         "    if (k < k0 || k >= k1) continue;\n"
         "    const float kty = kty_tile<EDGE>(t, e, up, k);"),
        ("fused_rof.cu",
         "  const float sig_p0 = LAST ? 0.f : sh.k.sig_p;\n"
         "  const float sig_t0 = LAST ? 0.f : sh.k.sig_t;\n"
         "  const float radius0 = LAST ? 0.f : sh.k.radius;\n"
         "  const unsigned term",
         "  const float sig_p = sh.k.sig_p, sig_t = sh.k.sig_t, radius ="
         " sh.k.radius;\n"
         "  const unsigned term"),
        ("fused_rof.cu",
         "    dual_at(qx, qy, gxn, gyn, gx[k], gy[k], LAST ? sh.k.sig_p :"
         " sig_p0,\n"
         "            LAST ? sh.k.sig_t : sig_t0, LAST ? sh.k.radius :"
         " radius0, qxn,\n"
         "            qyn);",
         "    dual_at(qx, qy, gxn, gyn, gx[k], gy[k], sig_p, sig_t, radius,"
         " qxn, qyn);"),
        ("fused_rof.cu",
         "    const TStrip<CB> t((a.tx + 2 * a.count + 1) * S);\n"
         "    const int wr = t.wr(), wc = t.wc();",
         "    const TStrip<CB> t(v.wh * S);\n"
         "    const int wr = t.wr(), wc = t.wc();"),
        ("fused_rof.cu",
         "    const TStrip<CB> t((a.tx + 2 * a.count + 1) * S);\n"
         "    if (sh.v.inner)",
         "    const TStrip<CB> t(sh.v.wh * S);\n"
         "    if (sh.v.inner)"),
        ("fused_rof.cu",
         "  const int m = (a.tx + 2 * a.count + 1) * S;",
         "  const int m = v.wh * S;"),
    ], None, True),
    "no copy back": ("package", [
        ("fused_rof.cu", "  return tiled_settle(a, x, q, 0, s, batch);",
         "  return 0;"),
    ], None, False),
    # step 0 on the earlier kernel (its first design, with --step0): a window
    # that returns after its loads, after its iterations (no norm pass, no
    # write-out); a chunk with no finish, with no copy back
    "old loads only": ("old", [
        ("fused_rof.cu", "  const int c = a.count;\n",
         "  const int c = a.count;\n  if (c > 0) return;\n"),
    ], None, False),
    "old no write-out": ("old", [
        ("fused_rof.cu", "  // the |dd|^2 and |w_hat|^2 sums from K^T q of "
         "the new dual, and the owned\n",
         "  if (c > 0) return;\n"),
    ], None, False),
    "old no finish": ("old", [
        ("fused_rof.cu",
         "  pdhg_finish<<<batch, FIN, 0, s>>>(a.sc, a.partial, "
         "(int)(g.x * g.y),\n",
         "  if (batch < 0) pdhg_finish<<<batch, FIN, 0, s>>>(a.sc, a.partial, "
         "(int)(g.x * g.y),\n"),
    ], None, False),
    "old no copy back": ("old", [
        ("fused_rof.cu", "  return tiled_settle(a, x, q, 0, s, batch);",
         "  return 0;"),
    ], None, False),
    # the stencils without their tests (wrong at the edges, timed only)
    "old no stencil tests": ("old", [
        ("fused_rof.cu",
         "  float lx = wi > 0 && has_above(r, i) ? s.qx[p - v.ww] : 0.f;\n"
         "  float ly = wj > 0 && j > 0 ? s.qy[p - 1] : 0.f;",
         "  float lx = s.qx[p - v.ww];\n  float ly = s.qy[p - 1];"),
        ("fused_rof.cu",
         "  gx = wi < v.wh - 1 && has_below(r, i, nx) ? u[p + v.ww] - uv : "
         "0.f;\n  gy = wj < v.ww - 1 && j < ny - 1 ? u[p + 1] - uv : 0.f;",
         "  gx = u[p + v.ww] - uv;\n  gy = u[p + 1] - uv;"),
    ], None, False),
    # the primal step alone, the dual step alone (timed only)
    "old primal only": ("old", [
        ("fused_rof.cu",
         "      const TRegion d = exact_region(v, it, true);\n",
         "      const TRegion d = exact_region(v, it, true);\n"
         "      if (c > 0) { __syncthreads(); continue; }\n"),
    ], None, False),
    "old dual only": ("old", [
        ("fused_rof.cu",
         "    const TRegion e = exact_region(v, it, false);\n",
         "    TRegion e = exact_region(v, it, false);\n"
         "    if (!last) e.hi = e.lo;\n"),
    ], None, False),
    # grad x_old not recomputed in the dual step (what a carried copy
    # saves at most; wrong, timed only)
    "old no grad x_old": ("old", [
        ("fused_rof.cu",
         "  grad_tile(xo, v, r, nx, ny, wi, wj, i, j, p, gx, gy);\n",
         "  gx = gy = 0.f;\n"),
    ], None, False),
    # blocks of 512 and 768 threads
    "old 512 threads": ("old", [
        ("fused_rof.cu", "constexpr int TL_THREADS = 1024;",
         "constexpr int TL_THREADS = 512;"),
    ], None, True),
    "old 768 threads": ("old", [
        ("fused_rof.cu", "constexpr int TL_THREADS = 1024;",
         "constexpr int TL_THREADS = 768;"),
    ], None, True),
    # two blocks of 512 threads on each SM, at a tile whose window fits
    # in half a block's budget (40x64: 61x85, 5 planes, 103700 bytes)
    "old two blocks of 512": ("old", [
        ("fused_rof.cu", "constexpr int TL_THREADS = 1024;",
         "constexpr int TL_THREADS = 512;"),
        ("fused_rof.cu",
         "__global__ void __launch_bounds__(TL_THREADS, 1) rof_tiled(",
         "__global__ void __launch_bounds__(TL_THREADS, 2) rof_tiled("),
    ], (40, 64), True),
    "old one block at 40x64": ("old", [], (40, 64), True),
}
STEP0 = [name for name in VARIANTS if name.startswith("old ")] + ["old"]


def build_variant(name, csrc, subs):
    """``fused_rof.cu`` of the directory ``csrc`` with ``subs`` applied (a
    changed header beside the copy, which its quoted include finds first),
    built into a directory of its own under ``_build/exp/``: (the loaded
    library, its ptxas lines of rof_tiled)."""
    from prost_tpu_torch.ops import cuda_build

    out = os.path.join(cuda_build.BUILD_DIR, "exp", "rof_" + "".join(
        c if c.isalnum() else "_" for c in name))
    os.makedirs(out, exist_ok=True)
    texts = {}
    for fname, old, new in subs + [("fused_rof.cu", "", "")]:
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
    stem = os.path.join(out, "fused_rof")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                           "-I", csrc, "-o", stem + ".so", stem + ".cu"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name!r}: nvcc failed:\n{proc.stderr}")
    return typed(ctypes.CDLL(stem + ".so")), tiled_report(proc.stderr)


def typed(lib):
    """``lib``'s entry points typed as the package types its own."""
    from prost_tpu_torch.ops import fused_rof as fr

    pkg = fr._lib()
    for fn in ("prost_rof_chunk_tiled", "prost_rof_chunk_batched_tiled",
               "prost_rof_multichunk_tiled", "prost_rof_num_blocks"):
        getattr(lib, fn).argtypes = getattr(pkg, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def tiled_report(log):
    """ptxas's register, stack-frame and spill lines of rof_tiled<DT> (by
    its data term) in a build log."""
    out, mine = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mine = None
            if "9rof_tiledILi" in ln:  # rof_tiled<DT>
                mine = "DT " + ln.split("9rof_tiledILi")[1].split("E")[0]
        elif mine and ("registers" in ln or "spill" in ln
                       or "stack" in ln):
            out.append(f"{mine}: {ln.strip()}")
    return out


def dump_sass(cuda_build):
    """The SASS of the package's rof_tiled<0, 3> into
    chiprun_out/rof_tiled.sass: the counts of its local-memory loads and
    stores (LDL, STL) and of its shared-memory ones (LDS, STS)."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", cuda_build.load("fused_rof").path],
                          capture_output=True, text=True).stdout
    keep, mine = [], False
    for ln in text.splitlines():
        if "Function :" in ln:
            mine = "9rof_tiledILi0ELi3E" in ln
        if mine:
            keep.append(ln)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "rof_tiled.sass"), "w") as fh:
        fh.write("\n".join(keep))
    body = "\n".join(keep)
    return {op: body.count(op + " ") + body.count(op + ".")
            for op in ("LDL", "STL", "LDS", "STS", "BAR")}


class Case:
    """Random planes of B instances of (nx, ny) (a halo band of nxg global
    rows where ``band``), the state's copies the calls work on in place,
    and the calls of each path on them."""

    def __init__(self, nx, ny, seed, dev, dataterm="square", batch=1,
                 band=0, multi=0):
        import numpy as np
        import torch

        from prost_tpu_torch.ops import fused_rof as fr
        from prost_tpu_torch.ops.pdhg_chunk import S_LEN

        self.nx, self.ny, self.B, self.multi = nx, ny, batch, multi
        self.nxg = nx - 2 * band if band else 0
        self.dt = fr.DATATERMS[dataterm]
        self.dataterm = dataterm
        rng = np.random.RandomState(seed)
        shape = (batch, nx, ny) if batch > 1 else (nx, ny)
        qshape = (batch, 2, nx, ny) if batch > 1 else (2, nx, ny)
        arrs = (rng.rand(*shape), 0.3 * rng.randn(*qshape), rng.rand(*shape),
                (rng.rand(*shape) > 0.3) * 1.0)
        self.init = [torch.from_numpy(a.astype(np.float32)).to(dev)
                     for a in arrs]
        self.state = [t.clone() for t in self.init[:2]]
        self.prev = [t.clone() for t in self.init[:2]]
        self.f, self.w = self.init[2], self.init[3]
        sc = torch.zeros((batch, S_LEN), device=dev)
        sc[:, :5] = torch.tensor([0.9, 1.1, 1.0, LMB, 1.0], device=dev)
        if band:
            sc[:, 5:8] = torch.tensor([-band, band, band + self.nxg],
                                      device=dev, dtype=torch.float32)
        if multi:
            sc[:, 5:9] = torch.tensor([0.5, 0.0, 0.0, 1.0], device=dev)
        self.sc0 = sc.reshape(-1) if batch > 1 else sc[0]
        self.sc = self.sc0.clone()
        self.partial = torch.empty(
            4 * batch * fr._lib().prost_rof_num_blocks(nx, ny), device=dev)
        self.scratch = torch.empty((3 * batch, nx, ny), device=dev)
        self.g = torch.empty((2 * batch, nx, ny), device=dev)
        self.gp = torch.empty((2 * batch, nx, ny), device=dev)
        self.consts = (float(np.sqrt(2 * nx * ny)), float(np.sqrt(nx * ny)),
                       1.5, 0.95, 1.05, 0.8)
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.sms = fr.card_sms(dev)
        self.tsmem = fr.tiled_limit(dev)

    def rule(self, count=RI):
        from prost_tpu_torch.ops import fused_rof as fr

        return fr.tiled_tile(self.nx, self.ny, count, self.dataterm,
                             self.sms, self.tsmem, self.B)

    def old_rule(self, count=RI):
        """The tile the earlier rule picks (5 planes of the window, 6 with
        w)."""
        from prost_tpu_torch.ops import fused_rof as fr

        h, planes = 2 * count + 1, 6 if self.dataterm == "wsquare" else 5
        return fr.window_tile(
            self.nx, self.ny, h, self.sms,
            lambda tx, ty: 4 * planes * (tx + h) * (ty + h) <= self.tsmem,
            self.B)

    def _ptrs(self, *ts):
        return [t.data_ptr() for t in ts]

    def tiled(self, lib, tile=None, count=RI):
        tile = tile or self.rule(count)
        s, p = self.state, self.prev
        ptrs = self._ptrs(*s, *p, self.f, self.w, self.sc, self.partial,
                          self.scratch)
        nx, ny, st = self.nx, self.ny, self.stream
        if self.multi:
            def call():
                return lib.prost_rof_multichunk_tiled(
                    *ptrs, nx, ny, count, self.multi, self.dt, 2,
                    *self.consts, *tile, st)
        elif self.B > 1:
            def call():
                return lib.prost_rof_chunk_batched_tiled(
                    *ptrs, nx, ny, count, self.dt, self.B, *tile, st)
        else:
            def call():
                return lib.prost_rof_chunk_tiled(
                    *ptrs, nx, ny, self.nxg, count, self.dt, *tile, st)
        return checked(call, "tiled")

    def streaming(self, count=RI):
        from prost_tpu_torch.ops import fused_rof as fr

        lib = fr._lib()
        s, p = self.state, self.prev
        ptrs = self._ptrs(*s, *p, self.g, self.gp, self.f, self.w, self.sc,
                          self.partial)
        nx, ny, st = self.nx, self.ny, self.stream
        if self.multi:
            def call():
                return lib.prost_rof_multichunk(
                    *ptrs, nx, ny, count, self.multi, self.dt, 2,
                    *self.consts, st)
        elif self.B > 1:
            def call():
                return lib.prost_rof_chunk_batched(
                    *ptrs, nx, ny, count, self.dt, self.B, st)
        elif self.nxg:
            def call():
                return lib.prost_rof_chunk_halo(
                    *ptrs, nx, ny, self.nxg, count, self.dt, st)
        else:
            def call():
                return lib.prost_rof_chunk(*ptrs, nx, ny, count, self.dt, st)
        return checked(call, "streaming")

    def outputs(self, call):
        """The state, previous iterates and scalars ``call`` leaves from
        the initial planes."""
        import torch

        for t, v in zip(self.state, self.init[:2]):
            t.copy_(v)
        for t in self.prev:
            t.fill_(float("nan"))
        self.sc.copy_(self.sc0)
        call()
        torch.cuda.synchronize()
        return ([t.clone() for t in self.state]
                + [t.clone() for t in self.prev] + [self.sc.clone()])

    def equal(self, call, count=RI):
        import torch

        want = self.outputs(self.streaming(count))
        got = self.outputs(call)
        return all(torch.equal(a, b) for a, b in zip(got, want))


def checked(call, what):
    def run():
        rc = call()
        if rc:
            raise RuntimeError(f"{what}: CUDA error {rc}")
    return run


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


# (label, Case arguments): the shapes each row serves
CASES = [
    ("chunk 2048x2048", dict(nx=2048, ny=2048)),
    ("chunk 2048x1536", dict(nx=2048, ny=1536)),
    ("band 2092x2048", dict(nx=2092, ny=2048, band=22)),
    ("multichunk 2048x2048 x8", dict(nx=2048, ny=2048, multi=8)),
    ("batched 4x2048x2048", dict(nx=2048, ny=2048, batch=4)),
    ("batched 2x1280x1280", dict(nx=1280, ny=1280, batch=2)),
    ("batched 8x512x512", dict(nx=512, ny=512, batch=8)),
]
# cases whose iteration and fixed part are split by count
BY_COUNT = ("chunk 2048x2048", "batched 4x2048x2048", "band 2092x2048")


def prefetch_bound(lib, loads, dev):
    """What a chunk whose next window's loads went under the current
    window's iterations (persistent blocks, a tile after another, with
    cp.async into shared memory the window does not use) could take at
    most, at 2048x2048 and B = 4: at each tile with room for a second
    window (``double``: 8 planes) or for the next f alone (``f``: a fifth
    plane) beside its own, the package's chunk there (ms) less the part
    such loads hide at most: the whole of a launch that only loads its
    windows (``loads only``), or a quarter of it (f is one of the four
    planes); against the package at the rule's tile, in the same turns."""
    import torch

    from prost_tpu_torch.ops import fused_rof as fr

    res = {}
    for label in ("chunk 2048x2048", "batched 4x2048x2048"):
        case = Case(seed=9, dev=dev, **dict(CASES)[label])
        head = 4 * fr.TILE_HEAD
        rule = case.rule()
        room = {}
        for ty in fr.TILE_COLS:
            for tx in fr.TILE_ROWS:
                if not fr.tiled_fits(tx, ty, RI, "square", case.tsmem):
                    continue
                one = fr.tiled_bytes(tx, ty, RI) - head
                if 2 * one + head <= case.tsmem:
                    room[(tx, ty)] = ("double", 1.0)
                elif fr.tiled_bytes(tx, ty, RI, "wsquare") <= case.tsmem:
                    room[(tx, ty)] = ("f", 0.25)
        base = [ms(case.tiled(lib, rule))]
        rows = {}
        for tile, (kind, part) in room.items():
            t, ld = ms(case.tiled(lib, tile)), ms(case.tiled(loads, tile))
            rows["%dx%d" % tile] = (kind, t, ld, t - part * ld)
        base.append(ms(case.tiled(lib, rule)))
        best = {kind: min(((k, r[3]) for k, r in rows.items()
                           if r[0] == kind), key=lambda kv: kv[1],
                          default=None) for kind in ("double", "f")}
        res[label] = {"rule": ("%dx%d" % rule, base), "best": best,
                      "tiles": rows}
        print(label, "prefetch bound", json.dumps(
            {"rule": res[label]["rule"], "best": best}))
        del case
        torch.cuda.empty_cache()
    return res


def finish(card, out, tag):
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", f"rof_tiled_probe{tag}.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    short = dict(out)
    short.pop("variant_ptxas", None)
    print(card)
    print(json.dumps(short))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="a csrc directory holding an earlier "
                    "fused_rof.cu, timed in turns with the package's")
    ap.add_argument("--step0", action="store_true", help="only the variants "
                    "on the old kernel and its breakdown")
    ap.add_argument("--ptxas", action="store_true", help="build the package "
                    "and the variants, print ptxas's lines of rof_tiled, "
                    "time nothing")
    ap.add_argument("--only", help="comma-separated variant names to run")
    ap.add_argument("--no-sweep", action="store_true", help="leave out the "
                    "tiles swept at each shape")
    ap.add_argument("--versus", help="a variant (VARIANTS) that must be "
                    "bit-equal, checked at every case and timed in turns "
                    "there with the package (and --old)")
    ap.add_argument("--rounds", type=int, default=1, help="the turns of "
                    "each case, repeated")
    ap.add_argument("--prefetch-bound", action="store_true", help="the "
                    "least a chunk could take whose loads went under the "
                    "iterations, at every tile with room for the next "
                    "window (prefetch_bound)")
    ap.add_argument("--sass", action="store_true", help="also write the "
                    "SASS of the package's rof_tiled<0, 3> (cuobjdump) to "
                    "chiprun_out/rof_tiled.sass and count its local-memory "
                    "instructions")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("rof_tiled_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import prost_tpu_torch as ptt
    from prost_tpu_torch.ops import cuda_build
    from prost_tpu_torch.ops import fused_rof as fr

    ptt.set_device("cuda:0")
    dev = ptt.device()
    card = cs.card_line()
    print(card)
    old = opts.old or (cuda_build.CSRC if opts.step0 else None)
    bases = {"package": cuda_build.CSRC, "old": old}
    only = set(opts.only.split(",")) if opts.only else None
    chosen = {name: v for name, v in VARIANTS.items()
              if bases[v[0]] and (name in STEP0) == opts.step0
              or name == "old" and old}
    if only is not None:
        chosen = {name: v for name, v in chosen.items() if name in only}
    for name in ([opts.versus] if opts.versus else []) + (
            ["loads only"] if opts.prefetch_bound else []):
        chosen[name] = VARIANTS[name]
    with ThreadPoolExecutor(len(chosen) + 1) as pool:
        base = pool.submit(fr._lib)
        built = {name: pool.submit(build_variant, name, bases[v[0]], v[1])
                 for name, v in chosen.items()}
        base.result()
        built = {name: fut.result() for name, fut in built.items()}
    libs = {name: lib for name, (lib, _) in built.items()}
    out = {"card": card,
           "ptxas": tiled_report(cuda_build.load("fused_rof").log),
           "variant_ptxas": {name: rep for name, (_, rep) in built.items()}}
    print("ptxas", json.dumps({"package": out["ptxas"],
                               **out["variant_ptxas"]}))
    tag = "_step0" if opts.step0 else ""
    if opts.sass:
        out["sass_local"] = dump_sass(cuda_build)
        print("sass", json.dumps(out["sass_local"]))
    if opts.ptxas:
        finish(card, out, tag + "_ptxas")
        return 0
    lib = fr._lib()
    oldlib = libs.get("old")
    vslib = libs[opts.versus] if opts.versus else None

    # bit-equality of the package (and the old kernel) at every case
    out["cases"] = {}
    seed = 30
    for label, kw in CASES:
        terms = (("square", "wsquare", "abs") if label == "chunk 2048x2048"
                 else ("square",))
        for dataterm in terms:
            case = Case(seed=seed, dev=dev, dataterm=dataterm, **kw)
            seed += 1
            key = label if dataterm == "square" else f"{label} {dataterm}"
            res = {"tile": case.rule()}
            counts = (RI, 3, 1) if not opts.step0 else (RI,)
            res["bit_equal"] = {c: case.equal(case.tiled(lib, count=c), c)
                                for c in counts}
            if oldlib is not None:
                res["old_tile"] = case.old_rule()
                res["old_bit_equal"] = case.equal(case.tiled(
                    oldlib, case.old_rule()))
            if vslib is not None:
                res["versus_bit_equal"] = {
                    c: case.equal(case.tiled(vslib, count=c), c)
                    for c in counts}
            ok = all(res["bit_equal"].values()) and res.get(
                "old_bit_equal", True) and all(
                    res.get("versus_bit_equal", {}).values())
            if ok and dataterm == "square":
                calls = [case.streaming(), case.tiled(lib)]
                names = ["streaming", "package"]
                if oldlib is not None and not opts.step0:
                    calls.append(case.tiled(oldlib, case.old_rule()))
                    names.append("old")
                if vslib is not None:
                    calls.append(case.tiled(vslib))
                    names.append("versus")
                turns = {n: [] for n in names}
                for _ in range(opts.rounds):
                    t = [ms(c) for c in calls + calls[::-1]]
                    for i, n in enumerate(names):
                        turns[n] += [t[i], t[-1 - i]]
                res["turns_ms"] = turns
                if label in BY_COUNT:
                    bc = {c: ms(case.tiled(lib, count=c)) for c in (1, 2, RI)}
                    res["by_count_ms"] = bc
                    res["iteration_and_fixed_ms"] = split(bc)
            out["cases"][key] = res
            print(key, json.dumps(res))
            del case
            torch.cuda.empty_cache()
    if not all(all(r["bit_equal"].values()) and r.get("old_bit_equal", True)
               and all(r.get("versus_bit_equal", {}).values())
               for r in out["cases"].values()):
        finish(card, out, tag)
        return 1

    # the package at every tile it takes, at each shape but the
    # multichunk's (the chunk's): the rule's tile (lane rows) against the
    # window-pixel measure's (window_tile) and the fastest
    if not opts.step0 and not opts.no_sweep:
        out["by_tile_ms"], out["rules"] = {}, {}
        for label, kw in CASES:
            if kw.get("multi"):
                continue
            case = Case(seed=8, dev=dev, **kw)
            res = {}
            for ty in fr.TILE_COLS:
                for tx in fr.TILE_ROWS:
                    if (tx - 8 < case.nx and ty - 32 < case.ny
                            and fr.tiled_fits(tx, ty, RI, "square",
                                              case.tsmem)):
                        res[f"{tx}x{ty}"] = ms(case.tiled(lib, (tx, ty)))
            out["by_tile_ms"][label] = res
            pixel = fr.window_tile(
                case.nx, case.ny, 2 * RI + 1, case.sms,
                lambda tx, ty: fr.tiled_fits(tx, ty, RI, "square",
                                             case.tsmem), case.B)
            best = min(res, key=res.get)
            rule = "%dx%d" % case.rule()
            pix = "%dx%d" % pixel
            out["rules"][label] = {"rule": (rule, res[rule]),
                                   "window pixels": (pix, res[pix]),
                                   "fastest": (best, res[best])}
            print(label, "tiles", json.dumps(out["rules"][label]))
            del case
            torch.cuda.empty_cache()

    if opts.prefetch_bound:
        out["prefetch_bound"] = prefetch_bound(lib, libs["loads only"], dev)
    # the variants at 2048x2048 (and B = 4 of it)
    out["variants"] = {}
    for label in ("chunk 2048x2048", "batched 4x2048x2048"):
        kw = dict(CASES)[label]
        case = Case(seed=7, dev=dev, **kw)
        rule = case.rule()
        for name, vlib in libs.items():
            vbase, _, vtile, exact = VARIANTS[name]
            vrule = vtile or (case.old_rule() if vbase == "old" else rule)
            res = {"tile": vrule}
            try:
                if exact:
                    res["bit_equal"] = case.equal(case.tiled(vlib, vrule))
                else:
                    case.outputs(case.tiled(vlib, vrule))
            except RuntimeError as e:  # the variant refuses the tile
                res["refused"] = str(e)
            if "refused" in res or not res.get("bit_equal", True):
                out["variants"][f"{name} @ {label}"] = res
                print(name, label, json.dumps(res))
                continue
            blib = oldlib if vbase == "old" and name != "old" else lib
            bname = "old" if blib is oldlib else "package"
            brule = case.old_rule() if blib is oldlib else rule
            t = [ms(case.tiled(x, tl)) for x, tl in (
                (blib, brule), (vlib, vrule), (vlib, vrule), (blib, brule))]
            res["turns_ms"] = {bname: (t[0], t[3]), "variant": (t[1], t[2])}
            if not exact:
                bc = {c: ms(case.tiled(vlib, vrule, count=c))
                      for c in (1, 2, RI)}
                res["by_count_ms"] = bc
                res["iteration_and_fixed_ms"] = split(bc)
            out["variants"][f"{name} @ {label}"] = res
            print(name, label, json.dumps(res))
        del case
        torch.cuda.empty_cache()
    finish(card, out, tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
