"""Start a ``torch.distributed`` group of spawned ranks on one host.

``run_ranks(world, fn, kwargs, device)`` spawns ``world`` processes, joins
them into one process group (NCCL with rank r on card r, or gloo on the
CPU), calls ``fn(**kwargs)`` on every rank and returns each rank's result.
``fn`` must be a module-level function (the spawned ranks import it), and
its result picklable.  Every rank process is gone when the call returns.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import traceback
from datetime import timedelta

import torch

from ..config import ProstError

# seconds the group may take to finish, and its collectives' timeout
GROUP_TIMEOUT_S = 900
PG_TIMEOUT_S = 300


def _rank_main(rank, world, init_method, device_type, fn, kwargs, results):
    """One rank: join the group, run ``fn``, put (rank, result, None) or
    (rank, None, traceback) on ``results``."""
    import torch.distributed as dist

    from .. import config

    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            config.set_device(f"cuda:{rank}")
            backend = "nccl"
        else:
            torch.set_num_threads(1)
            config.set_device("cpu")
            backend = "gloo"
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=PG_TIMEOUT_S))
        results.put((rank, fn(**kwargs), None))
    except Exception:  # reported by the parent
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world: int, fn, kwargs=None, device=None) -> list:
    """``fn(**kwargs)`` on ``world`` spawned ranks of one process group:
    on the cards when ``device`` is None or a CUDA device (one rank a card;
    raises ``ProstError`` when there are fewer than ``world`` cards), on
    the CPU over gloo when ``device`` is ``"cpu"``.  Returns the ranks'
    results in rank order; raises if a rank fails or the group does not
    finish within GROUP_TIMEOUT_S."""
    device_type = "cuda" if device is None else torch.device(device).type
    if device_type == "cuda" and torch.cuda.device_count() < world:
        raise ProstError(f"{world} ranks need {world} CUDA cards, have "
                         f"{torch.cuda.device_count()}.")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'pg')}"
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, init, device_type, fn,
                                   kwargs or {}, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, errors = {}, []
        try:
            for _ in range(world):
                rank, out, err = results.get(timeout=GROUP_TIMEOUT_S)
                if err is not None:
                    errors.append(f"rank {rank}:\n{err}")
                got[rank] = out
        except queue.Empty:
            errors.append(f"ranks {sorted(set(range(world)) - set(got))} "
                          f"gave no result within {GROUP_TIMEOUT_S} s")
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r] for r in range(world)]
