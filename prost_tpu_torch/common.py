"""Small shared utilities (counterpart of ``prost_tpu/common.py``).

The JAX package registers its dataclasses as pytrees; here they are plain
dataclasses, and ``tree_to`` moves every tensor inside one (recursively,
through tuples and nested dataclasses) to a device in one explicit step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def linspace(start: float, end: float, n: int) -> list[float]:
    """Evenly spaced schedule used for callback iterations (prost::linspace,
    which the solver uses to pick the callback iterations)."""
    if n == 1:
        return [float(start)]
    step = (float(end) - float(start)) / (n - 1)
    return [float(start) + step * i for i in range(n)]


def tree_to(obj, device=None, dtype=None):
    """Copy of ``obj`` with every tensor moved to ``device``; numpy arrays
    become tensors of ``dtype`` on the way.  Python scalars, strings and
    other leaves are kept as they are."""
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point() and dtype is not None:
            return obj.to(device=device, dtype=dtype)
        return obj.to(device=device)
    if isinstance(obj, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(obj))
        return tree_to(t, device, dtype)
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_to(v, device, dtype) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {f.name: tree_to(getattr(obj, f.name), device, dtype)
                   for f in dataclasses.fields(obj) if f.init}
        return dataclasses.replace(obj, **changes)
    return obj


def to_numpy(v):
    """Host numpy copy of a tensor (any device) or array-like."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)
