"""Global configuration for prost_tpu_torch: dtype, device, errors.

Counterpart of ``prost_tpu/config.py``.  The solver state and operators use
one floating dtype (float32 by default; float64 for parity checks) and one
``torch.device``.  The device is chosen here, explicitly: ``set_device``
names it, and until then ``device()`` is the first CUDA card.  Without a
card and without ``set_device`` it raises: the CPU is taken only when it is
asked for (``set_device("cpu")``).  Nothing in the package falls back from
a device it was given: a CUDA tensor is computed on the card or the call
raises.
"""

from __future__ import annotations

import torch

_DTYPE = torch.float32
_DEVICE: torch.device | None = None


def set_dtype(dtype) -> None:
    """Set the global floating dtype (torch.float32 or torch.float64)."""
    global _DTYPE
    if dtype not in (torch.float32, torch.float64):
        raise ProstError(f"Unsupported dtype {dtype}: use float32 or float64.")
    _DTYPE = dtype


def dtype() -> torch.dtype:
    """Current global floating dtype."""
    return _DTYPE


class ProstError(Exception):
    """Framework-level error (mirrors prost::Exception)."""


def list_devices() -> list[torch.device]:
    """Available CUDA cards, then the CPU (prost.list_gpus analog)."""
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return cards + [torch.device("cpu")]


def set_device(dev) -> None:
    """Select the device for subsequent problems and solver state
    (prost.set_gpu analog).  ``dev`` is a card index, a device string such
    as ``"cuda:0"`` or ``"cpu"``, or a ``torch.device``.  Asking for a card
    that is not there raises instead of falling back to the CPU."""
    global _DEVICE
    d = torch.device("cuda", dev) if isinstance(dev, int) else torch.device(dev)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise ProstError(f"Device {d} requested but CUDA is not available.")
        if d.index is None:
            d = torch.device("cuda", 0)
        if d.index >= torch.cuda.device_count():
            raise ProstError(f"Device {d} does not exist.")
    _DEVICE = d


def device() -> torch.device:
    """The device chosen by ``set_device``; by default the first CUDA card.
    Raises ``ProstError`` when there is no card and none was chosen."""
    if _DEVICE is None:
        if not torch.cuda.is_available():
            raise ProstError('No CUDA card: call set_device("cpu") to run '
                             "on the CPU.")
        return torch.device("cuda", 0)
    return _DEVICE
