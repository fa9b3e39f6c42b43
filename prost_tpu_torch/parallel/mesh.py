"""Device-mesh helper (counterpart of ``prost_tpu/parallel/mesh.py``).

A JAX mesh spans the devices one process sees; a ``torch.distributed``
mesh spans the ranks of the default process group, one device each.  The
caller starts that group (``torch.distributed.init_process_group`` with
its address, world size and rank): NCCL for ranks on cards, gloo for ranks
on the CPU.  The mesh's device type is the package's device
(``config.device()``), so it lies on the card unless ``set_device("cpu")``
was called, and raises without a card.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..config import ProstError, device

# the process-group backend each device type takes
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(shape=None, axis_names=("dp", "sp"), device_type=None):
    """A ``DeviceMesh`` over the ranks of the default process group.

    shape: a tuple matching ``axis_names``; None puts every rank on the
    first axis (the others of size 1).  ``device_type`` defaults to the
    package's device type.  Raises ``ProstError`` when no process group
    runs, when its backend is not the one for ``device_type`` (nothing
    switches backend silently), and ``ValueError`` when the shape needs
    more ranks than the world has, as the JAX package does for devices,
    or fewer (a rank outside the mesh would have no part of the state)."""
    dev_type = device_type or device().type
    if dev_type not in BACKENDS:
        raise ProstError(f"No process-group backend for device type "
                         f"'{dev_type}'.")
    if not dist.is_initialized():
        raise ProstError(
            "make_mesh needs a process group: call torch.distributed."
            f"init_process_group('{BACKENDS[dev_type]}', ...) first.")
    backend = dist.get_backend()
    if backend != BACKENDS[dev_type]:
        raise ProstError(f"A '{dev_type}' mesh needs the "
                         f"'{BACKENDS[dev_type]}' backend; the process group "
                         f"runs '{backend}'.")
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names "
                         f"{tuple(axis_names)}")
    total = math.prod(shape)
    if total > n:
        raise ValueError(f"mesh shape {shape} needs {total} ranks, have {n}")
    if total < n:
        raise ValueError(f"mesh shape {shape} covers {total} of the {n} "
                         "ranks; every rank must be in the mesh")
    return init_device_mesh(dev_type, shape,
                            mesh_dim_names=tuple(axis_names))
