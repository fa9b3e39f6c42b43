"""Profiling and observability utilities (counterpart of
``prost_tpu/util/profiling.py``).

The reference's observability surface is per-call kernel timing hooks,
verbose residual printing and a predicted GPU-memory report.  Here:

* ``trace(dir)``     -- a ``torch.profiler`` context that writes a Chrome
  trace of the host and, on a card, of its kernels;
* ``timed(fn, ...)`` -- (result, milliseconds) of a callable after warm-up
  calls, timed with CUDA events on the card;
* ``memory_stats()`` -- the CUDA caching allocator's statistics, with the
  JAX package's ``bytes_in_use`` / ``bytes_limit`` beside torch's keys;
* ``compiled_memory_analysis(fn, *args)`` -- the memory one call of ``fn``
  takes on the card, under the JAX package's four keys (measured by the
  allocator, not predicted by a compiler: eager PyTorch has no compiled
  program; no code is generated, so that key is 0).

Each runs on the device of its tensor arguments, else on
``config.device()``; on the CPU ``memory_stats`` and
``compiled_memory_analysis`` return ``{}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

from ..config import device as config_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside the context; the Chrome trace is written
    to ``log_dir/trace.json`` (replacing an earlier one) when the context
    ends.  Yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _tensors(obj):
    """Every tensor inside ``obj`` (tuples, lists, dicts, dataclasses)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _device_of(args) -> torch.device:
    for t in _tensors(args):
        return t.device
    return config_device()


def timed(fn, *args, warmup: int = 1, repeats: int = 5):
    """(result, average milliseconds of ``repeats`` calls) of
    ``fn(*args)`` after ``warmup`` calls (at least one), the reference's
    5-repeat timing hook: CUDA events on the card, ``perf_counter`` on the
    CPU."""
    dev = _device_of(args)
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args)
    return out, (time.perf_counter() - t0) / repeats * 1e3


def memory_stats(device=None) -> dict:
    """The CUDA caching allocator's statistics for ``device`` (default
    ``config.device()``): torch's own keys, plus ``bytes_in_use`` (bytes
    allocated now), ``peak_bytes_in_use``, ``bytes_reserved`` and
    ``bytes_limit`` (the card's memory).  ``{}`` on the CPU."""
    dev = torch.device(device) if device is not None else config_device()
    if dev.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(dev))
    _, total = torch.cuda.mem_get_info(dev)
    stats.update(
        bytes_in_use=stats.get("allocated_bytes.all.current", 0),
        peak_bytes_in_use=stats.get("allocated_bytes.all.peak", 0),
        bytes_reserved=stats.get("reserved_bytes.all.current", 0),
        bytes_limit=total)
    return stats


def _unique_bytes(tensors, skip=frozenset()):
    """Bytes of the distinct storages of ``tensors`` not in ``skip``, and
    the set of their storage pointers."""
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        ptr = st.data_ptr()
        if ptr in seen or ptr in skip:
            continue
        seen.add(ptr)
        total += st.nbytes()
    return total, seen


def compiled_memory_analysis(fn, *args) -> dict:
    """Device memory of one call of ``fn(*args)`` on the card: the bytes of
    the arguments' tensors, of the output's new tensors, and the call's
    temporaries (its peak above what was allocated before it, less the
    outputs), under the JAX package's keys; ``peak_size_in_bytes`` is the
    arguments plus that peak.  ``{}`` on the CPU."""
    dev = _device_of(args)
    if dev.type != "cuda":
        return {}
    arg_bytes, arg_ptrs = _unique_bytes(_tensors(args))
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    out_bytes, _ = _unique_bytes(_tensors(out), frozenset(arg_ptrs))
    return {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": max(peak - out_bytes, 0),
        "generated_code_size_in_bytes": 0,
        "peak_size_in_bytes": arg_bytes + peak,
    }
