"""Problem-assembly validators (counterpart of ``prost_tpu/_native/host.py``).

The JAX package runs these in a C++ host library with numpy fallbacks;
here they are the plain numpy versions.  Porting the C++ host runtime is
later work.
"""

from __future__ import annotations

import numpy as np


def prox_gaps(indices, sizes, total):
    """Uncovered (start, size) ranges; raises ValueError on overlap."""
    indices = np.asarray(indices, np.int64)
    sizes = np.asarray(sizes, np.int64)
    order = np.argsort(indices, kind="stable")
    gaps, pos = [], 0
    for i in order:
        if indices[i] < pos:
            raise ValueError("prox ranges overlap")
        if indices[i] > pos:
            gaps.append((pos, int(indices[i] - pos)))
        pos = int(indices[i] + sizes[i])
    if pos < total:
        gaps.append((pos, int(total - pos)))
    return gaps


def check_block_overlap(rows, cols, nrows, ncols):
    """Returns None if block rectangles are pairwise disjoint, else the
    offending (a, b) pair."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    nrows = np.asarray(nrows, np.int64)
    ncols = np.asarray(ncols, np.int64)
    n = rows.size
    for i in range(n):
        for j in range(i + 1, n):
            if (cols[i] < cols[j] + ncols[j] and cols[j] < cols[i] + ncols[i]
                    and rows[i] < rows[j] + nrows[j]
                    and rows[j] < rows[i] + nrows[i]):
                return (i, j)
    return None
