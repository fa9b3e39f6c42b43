#!/usr/bin/env python3
"""Where the time of a fused solve goes, phase by phase, on one card.

    python3 profile_fused.py [name ...]

With names (of ``ROUTES`` or ``ENSEMBLES``, e.g. ``tight vol``) it runs
only those; without, all of them.

Solves chip_smoke.py's ROF model at 512x512 (its procedural image, lmb 16)
through the fused routes of ``backend_admm`` (Chebyshev projection) and
``backend_pdhg`` (boyd), and through the fused routes of ``backend_pdhg``
(boyd) its fast multilabel model (BASELINE config 3: 8 labels on
data/cow.png at 256x256, lmb 0.5), its deblurring model (BASELINE config 2:
data/flowers.png at 512x512 under the 9x9 motion blur, lmb 100), its
tight multilabel model (4 labels on data/junction_gray.png at 128x128,
lmb 1) and its volumetric TV model (vol256x8: eight noisy slices of
data/dog.png at 256x256, lmb 6); each with residual_iter 10, 2000
iterations in 10 callback epochs at tolerance 1e-5, after a warm-up
solve of 200 iterations in one epoch (every phase's kernels launched).
Then four of chip_smoke.py's ensembles through ``BatchedPDHG``'s fused
routes, tolerances 0, after a warm-up run: ensemble1024x128
(BASELINE config 5, 21 + 1000 iterations), deblur8x512, tight8x128x4 and
the 8-instance vol256x8 ensemble (21 + 300), and each one's generic
batched path (the vmapped ``pdhg_step``) for 100 iterations.  Each of
them three times:

1. as a user runs it: the iterating time (host time inside the backend's
   ``run`` calls, each ending with a device sync) and, for each phase of
   ``ops/phases.py`` (generic steps of A and C, canonicalization, B0
   multichunks, B chunks with their adaptation, epilogue; the generic
   batched path has only generic steps), the calls and the host time
   spent issuing them;
2. with a device sync after every phase call, so that each phase's time
   includes its device work;
3. under torch.profiler: device time by kernel (the ``csrc`` kernels and
   torch's own), and the device busy share, device time over the wall of
   the traced solve (the tracer adds host time to every launch, so this
   share is a lower bound).

The last line of standard output is one JSON object with these numbers
per route; the line before it is the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

from chip_smoke import (DB_SIZE, ENS_B, ENS_ITERS, ENS_SIZE, ENS_WARM,
                        ML_LABELS, ML_LMB, ML_SIZE, SMALL_ENS_B,
                        SMALL_ENS_ITERS, TIGHT_LABELS, TIGHT_SIZE,
                        VOL_LABELS, VOL_SIZE, card_line, check, cow_gray,
                        deblur_data, deblur_frames, deblur_model,
                        csrc_kernel_names, ensemble_data, ensemble_problem,
                        ens_opts, kernel_name, ml_model,
                        ml_unaries, recording, run_model, test_image,
                        tight_ensemble_unaries, tight_model, tight_unaries,
                        timed_solve, vol_data, vol_model)

PHASES = ("generic", "canonicalize", "multichunk", "chunk", "epilogue")
LMB = 16.0
SIZE, ITERS = 512, 2000
ROUTES = ("admm", "pdhg", "ml", "deblur", "tight", "vol")
# the backend attribute that holds each route's match
TAKEN = {"admm": "rof", "pdhg": "rof", "ml": "ml", "deblur": "deblur",
         "tight": "tight", "vol": "vol"}
TIGHT_PAIRS = TIGHT_LABELS * (TIGHT_LABELS - 1) // 2
# the ensembles: (fused route, instances, label, timed iterations)
ENSEMBLES = {
    "ens_rof": ("rof", ENS_B, f"{ENS_B}x{ENS_SIZE}x{ENS_SIZE}", ENS_ITERS),
    "ens_deblur": ("deblur", SMALL_ENS_B, f"{SMALL_ENS_B}x{DB_SIZE}x"
                   f"{DB_SIZE}", SMALL_ENS_ITERS),
    "ens_tight": ("tight", SMALL_ENS_B, f"{SMALL_ENS_B}x{TIGHT_SIZE}x"
                  f"{TIGHT_SIZE}x{TIGHT_LABELS}", SMALL_ENS_ITERS),
    "ens_vol": ("vol", SMALL_ENS_B, f"{SMALL_ENS_B}x{VOL_SIZE}x{VOL_SIZE}x"
                f"{VOL_LABELS}", SMALL_ENS_ITERS),
}
GENERIC_ITERS = 100  # of each ensemble's generic batched path


def instrumented(mod, stats, sync):
    """Replace ``mod.run_phases`` by one that times each phase callable
    into ``stats`` ({phase: [calls, seconds]}); returns the original."""
    import torch

    orig = mod.run_phases

    def timed(name, fn):
        if fn is None:
            return None

        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            if sync:
                torch.cuda.synchronize()
            s = stats.setdefault(name, [0, 0.0])
            s[0] += 1
            s[1] += time.perf_counter() - t0
            return out
        return call

    def run_phases(state, start, until, ri, align, generic, canonicalize,
                   chunk, multichunk=None, epilogue=None):
        return orig(state, start, until, ri, align, timed("generic", generic),
                    timed("canonicalize", canonicalize),
                    timed("chunk", chunk), timed("multichunk", multichunk),
                    timed("epilogue", epilogue))

    mod.run_phases = run_phases
    return orig


def route_size(route):
    return {"ml": ML_SIZE, "deblur": DB_SIZE, "tight": TIGHT_SIZE,
            "vol": VOL_SIZE}.get(route, SIZE)


def route_label(route):
    size = route_size(route)
    labels = {"ml": ML_LABELS, "tight": TIGHT_LABELS, "vol": VOL_LABELS}
    return f"{size}x{size}" + (f"x{labels[route]}" if route in labels
                               else "")


def route_data(route):
    size = route_size(route)
    if route == "ml":
        return ml_unaries(cow_gray(size, size), ML_LABELS)
    if route == "deblur":
        return deblur_data(size, size)
    if route == "tight":
        return tight_unaries(size, size, TIGHT_LABELS)
    if route == "vol":
        return vol_data(VOL_LABELS, size, size)
    return test_image(size, size).reshape(-1)


def solve(route, iters, f, cbacks=10):
    """One solve of ``route``'s model on the data ``f`` in ``cbacks``
    callback epochs."""
    from prost_tpu_torch.backend import ADMMOptions, PDHGOptions

    size = route_size(route)
    n = size * size
    if route == "admm":
        backend = recording("admm", ADMMOptions(residual_iter=10))
    else:
        backend = recording("pdhg", PDHGOptions(stepsize="boyd",
                                                residual_iter=10))
    if route in ("admm", "pdhg"):
        res, backend, wall = timed_solve(backend, size, size, f, LMB, iters,
                                         cbacks)
    else:
        prob, ncols = {
            "ml": lambda: (ml_model(size, size, ML_LABELS, f, ML_LMB),
                           n * ML_LABELS),
            "deblur": lambda: (deblur_model(size, size, f), n),
            "tight": lambda: (tight_model(size, size, TIGHT_LABELS, f),
                              n * (TIGHT_LABELS + 2 * TIGHT_PAIRS)),
            "vol": lambda: (vol_model(size, size, VOL_LABELS, f),
                            n * VOL_LABELS),
        }[route]()
        res, backend, wall = run_model(backend, prob, ncols, iters, cbacks)
    check(getattr(backend.made, TAKEN[route]) is not None,
          f"the fused {route} route was not taken")
    return res, backend, wall


def phase_table(mod, route, f, sync):
    stats = {}
    orig = instrumented(mod, stats, sync)
    try:
        res, backend, wall = solve(route, ITERS, f)
    finally:
        mod.run_phases = orig
    return res, backend, wall, {
        name: {"calls": stats[name][0], "ms": stats[name][1] * 1e3,
               "ms_per_call": stats[name][1] * 1e3 / stats[name][0]}
        for name in PHASES if name in stats}


def ensemble(name):
    """The BatchedPDHG of ensemble ``name`` on the card, its fused route
    matched."""
    from prost_tpu_torch.parallel import BatchedPDHG

    route, B = ENSEMBLES[name][:2]
    if route == "rof":
        fs, lmbs = ensemble_data(B, ENS_SIZE, ENS_SIZE)
        problems = [ensemble_problem(ENS_SIZE, ENS_SIZE, f, lmb)
                    for f, lmb in zip(fs, lmbs)]
    elif route == "deblur":
        problems = [deblur_model(DB_SIZE, DB_SIZE, fb).finalize()
                    for fb in deblur_frames(B, DB_SIZE, DB_SIZE)]
    elif route == "vol":  # chip_smoke.py's phase_small_ensembles' volumes
        problems = [vol_model(VOL_SIZE, VOL_SIZE, VOL_LABELS,
                              vol_data(VOL_LABELS, VOL_SIZE, VOL_SIZE,
                                       seed=42 + i)).finalize()
                    for i in range(B)]
    else:
        problems = [tight_model(TIGHT_SIZE, TIGHT_SIZE, TIGHT_LABELS,
                                f).finalize()
                    for f in tight_ensemble_unaries(B)]
    b = BatchedPDHG(problems, *ens_opts())
    check(getattr(b, route) is not None,
          f"the fused batched {route} route was not taken")
    return b


def warm_state(b, warm):
    """``b``'s state after ``warm`` iterations from its initial state."""
    s = b.initial_state()
    if warm:
        s = b.run(s, warm, 0)
    float(s.tau[0])
    return s


def ensemble_run(b, s, iters, warm):
    """``iters`` iterations of ``b`` from ``s`` (after ``warm``), synced by
    a scalar read; the host seconds they took."""
    t0 = time.perf_counter()
    s = b.run(s, warm + iters, warm)
    float(s.tau[0])
    return time.perf_counter() - t0


def ensemble_phases(b, s, iters, warm, sync):
    """``ensemble_run`` with each phase timed: the fused route through
    ``run_phases``, the generic path (no route) by its generic steps."""
    import torch

    from prost_tpu_torch.parallel import ensemble as ens

    stats = {}
    if warm:
        orig = instrumented(ens, stats, sync)
    else:
        step = b.generic_step

        def generic(*args):
            t0 = time.perf_counter()
            out = step(*args)
            if sync:
                torch.cuda.synchronize()
            st = stats.setdefault("generic", [0, 0.0])
            st[0] += 1
            st[1] += time.perf_counter() - t0
            return out
        b.generic_step = generic
    try:
        dt = ensemble_run(b, s, iters, warm)
    finally:
        if warm:
            ens.run_phases = orig
        else:
            del b.generic_step
    return dt, {name: {"calls": stats[name][0], "ms": stats[name][1] * 1e3,
                       "ms_per_call": stats[name][1] * 1e3 / stats[name][0]}
                for name in PHASES if name in stats}


def traced(work, ours):
    """``work()`` under torch.profiler: device ms by kernel and the device
    busy share of its wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = kernel_name(e.name)
            by_kernel[name] = (by_kernel.get(name, 0.0)
                               + e.time_range.elapsed_us() * 1e-3)
    device_ms = sum(by_kernel.values())
    csrc_ms = sum(v for k, v in by_kernel.items() if k in ours)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "csrc_kernels_ms": csrc_ms,
            "torch_kernels_ms": device_ms - csrc_ms,
            "device_busy_share": device_ms / (wall * 1e3) if device_ms
            else None,
            "top_kernels_ms": dict(top)}


def print_phases(enqueue, synced):
    for label, table in (("host enqueue", enqueue),
                         ("synced after each call", synced)):
        for name, r in table.items():
            print(f"  {label:24s} {name:12s} {r['calls']:5d} calls "
                  f"{r['ms']:10.4f} ms ({r['ms_per_call']:.4f} ms/call)")


def print_trace(trace):
    print(f"  traced: wall {trace['wall_ms']:.4f} ms, device "
          f"{trace['device_ms']:.4f} ms (csrc kernels "
          f"{trace['csrc_kernels_ms']:.4f}, torch "
          f"{trace['torch_kernels_ms']:.4f}), busy share "
          f"{trace['device_busy_share']}")


def main(names) -> int:
    import torch

    unknown = set(names) - set(ROUTES) - set(ENSEMBLES)
    if unknown:
        print(f"profile_fused: unknown names {sorted(unknown)}; routes "
              f"{ROUTES}, ensembles {tuple(ENSEMBLES)}", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("profile_fused: no CUDA device", file=sys.stderr)
        return 2
    import prost_tpu_torch as ptt
    from prost_tpu_torch.ops import fused_admm, pdhg_chunk

    ptt.set_device("cuda:0")
    card = card_line()
    ours = csrc_kernel_names()
    # the module whose run_phases each route calls
    mods = {route: pdhg_chunk for route in ROUTES}
    mods["admm"] = fused_admm
    out = {}
    for route in ROUTES:
        if names and route not in names:
            continue
        f = route_data(route)
        # warm-up: build, first launches, in one epoch long enough for the
        # multichunk phase, so that no kernel's first call is timed
        solve(route, 200, f, cbacks=1)
        res, backend, wall, enqueue = phase_table(mods[route], route, f,
                                                  sync=False)
        _, sbackend, _, synced = phase_table(mods[route], route, f,
                                             sync=True)
        trace = traced(lambda: solve(route, ITERS, f), ours)
        label = route_label(route)
        out[route] = {
            "size": label, "iterations": res.iterations,
            "solve_s": wall, "iterating_s": backend.loop_s,
            "it_per_s": res.iterations / backend.loop_s,
            "phases_enqueue": enqueue, "phases_synced": synced,
            "iterating_synced_s": sbackend.loop_s, "trace": trace}
        print(f"{route} {label}: {res.iterations} "
              f"iterations, iterating {backend.loop_s * 1e3:.4f} ms "
              f"({res.iterations / backend.loop_s:.1f} it/s), solve() "
              f"{wall * 1e3:.4f} ms [{card}]")
        print_phases(enqueue, synced)
        print_trace(trace)
    for name, (route, B, label, iters) in ENSEMBLES.items():
        if names and name not in names:
            continue
        b = ensemble(name)
        for variant, warm, n in (("fused", ENS_WARM, iters),
                                 ("generic", 0, GENERIC_ITERS)):
            if variant == "generic":
                setattr(b, route, None)
            s0 = warm_state(b, warm)
            ensemble_run(b, s0, 10, warm)  # warm-up of the timed phases
            dt, enqueue = ensemble_phases(b, s0, n, warm, sync=False)
            sdt, synced = ensemble_phases(b, s0, n, warm, sync=True)
            trace = traced(lambda: ensemble_run(b, s0, n, warm), ours)
            key = f"{name}_{variant}"
            out[key] = {
                "size": label, "iterations": n, "iterating_s": dt,
                "instance_it_per_s": B * n / dt, "phases_enqueue": enqueue,
                "phases_synced": synced, "iterating_synced_s": sdt,
                "trace": trace}
            print(f"{key} {label}: {n} iterations after {warm}, iterating "
                  f"{dt * 1e3:.4f} ms ({B * n / dt:.1f} instance-it/s) "
                  f"[{card}]")
            print_phases(enqueue, synced)
            print_trace(trace)
        del b
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
