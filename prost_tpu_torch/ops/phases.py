"""The host-side phase plan shared by every fused route.

A fused route runs its kernels on chunks of ``ri`` (residual_iter)
iterations, each chunk ending on a residual iteration, and falls back to
its backend's generic step where a chunk does not fit.  ``run_phases``
plans the launches on the host from ``start`` (the caller's copy of the
state's iteration counter), so nothing is read from the device:

  A.  generic steps until ``it % ri == align``, where a chunk may start
  --  ``canonicalize``: once per run, the state put into the form the
      kernels assume (the dead dual coordinates zeroed), where a route
      needs one
  B0. ``multichunk`` launches of ``K_CHUNKS * ri`` iterations
  B.  ``chunk`` launches of ``ri`` iterations
  --  ``epilogue``: whatever the chunks do not carry, refreshed once
  C.  generic steps for the tail until ``until``

Once the device sets ``converged`` every later launch returns at once and
every step holds the state, which is what the JAX package's while-loops
do when they stop.
"""

from __future__ import annotations

from typing import Callable, Optional

# chunks per multichunk launch (adaptation between chunks on the device)
K_CHUNKS = 8


def run_phases(state, start: int, until: int, ri: int, align: int,
               generic: Callable, canonicalize: Optional[Callable],
               chunk: Callable, multichunk: Optional[Callable] = None,
               epilogue: Optional[Callable] = None):
    """Run iterations ``start .. until - 1`` through the phases above.
    ``generic(state, it)`` takes the host's count of the iteration; the
    other callables take and return the state."""
    it = start
    while it % ri != align and it < until:
        state = generic(state, it)
        it += 1

    if canonicalize is not None:
        state = canonicalize(state)

    if multichunk is not None:
        while it + K_CHUNKS * ri <= until:
            state = multichunk(state)
            it += K_CHUNKS * ri

    while it + ri <= until:
        state = chunk(state)
        it += ri

    if epilogue is not None:
        state = epilogue(state)

    while it < until:
        state = generic(state, it)
        it += 1
    return state
