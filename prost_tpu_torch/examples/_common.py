"""Shared helpers for the example scripts (counterpart of the JAX
package's ``examples/_common.py``).

The examples load the committed fixtures ``data/*.png`` (lion, dog,
flowers, fisch, house, maske2, cow, junction_gray), each in the role of
the reference example's photo.  The images are decoded and resized with
numpy and zlib alone, bit for bit as the JAX examples' PIL path
(``Image.convert`` then ``resize(..., BILINEAR)``) gives them, so both
packages see the same input and the card's machine needs no image
library.  ``image="synthetic"`` keeps the synthetic piecewise-smooth
pattern.  Every script accepts --size / --cpu / --max-iters.
"""

from __future__ import annotations

import functools
import os
import struct
import zlib

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "..", "..", "data")

# PIL's resampling keeps its normalised filter coefficients in fixed point
# with this many fraction bits (32 - 8 - 2) for 8-bit images.
PIL_PRECISION_BITS = 22
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


@functools.lru_cache(maxsize=None)
def read_png_rgb(path):
    """An 8-bit RGB (colour type 2) or grayscale (colour type 0),
    non-interlaced PNG as an (h, w, c) uint8 array, c = 3 or 1, decoded
    once with zlib and numpy.  Undoes the five PNG row filters (none, sub,
    up, average, Paeth).  The array is shared between calls: read it, do
    not write."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path} is not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    w, h, depth, color, _, _, interlace = hdr
    if not (depth == 8 and color in (0, 2) and interlace == 0):
        raise ValueError(f"{path}: only 8-bit RGB or gray non-interlaced "
                         "PNGs are read")
    bpp = 3 if color == 2 else 1
    stride = bpp * w
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = [0] * stride
    for r in range(h):
        kind, line = int(raw[r, 0]), raw[r, 1:].tolist()
        cur = [0] * stride
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) >> 1
            else:
                c = prev[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (line[i] + pred) & 255
        out[r] = cur
        prev = cur
    return out.reshape(h, w, bpp)


def write_png(path, img):
    """Write an (h, w) gray or (h, w, 3) RGB uint8 array as an 8-bit PNG
    (every row unfiltered, zlib level 6)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    rows = img.reshape(h, -1)
    raw = b"".join(b"\x00" + rows[r].tobytes() for r in range(h))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(_PNG_MAGIC
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                              0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))


def pil_bilinear_pass(img, out_size):
    """One pass of PIL's BILINEAR resample (Resample.c) along the last axis
    of the uint8 array ``img``: the triangle filter's support widened by
    the downscale factor, each output's coefficients normalised in double
    and rounded to PIL_PRECISION_BITS fraction bits, an integer sum with
    half added, shifted back and clipped to uint8."""
    in_size = img.shape[-1]
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = fscale  # the bilinear filter's support is 1
    inv = 1.0 / fscale
    one = 1 << PIL_PRECISION_BITS
    src = img.astype(np.int64)
    out = np.empty(img.shape[:-1] + (out_size,), np.uint8)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [max(0.0, 1.0 - abs((x - center + 0.5) * inv))
             for x in range(xmin, xmax)]
        total = 0.0
        for v in w:  # summed in order, as the C loop does
            total += v
        if total != 0.0:
            w = [v / total for v in w]
        # C's (int) cast of the rounded fixed-point weight truncates
        k = np.array([int(v * one - 0.5) if v < 0 else int(v * one + 0.5)
                      for v in w], np.int64)
        acc = (one >> 1) + src[..., xmin:xmax] @ k
        out[..., xx] = np.clip(acc >> PIL_PRECISION_BITS, 0, 255)
    return out


def fixture_uint8(name, rows=None, cols=None, gray=True):
    """data/<name>.png as PIL gives it after ``convert("L")`` (gray) or
    ``convert("RGB")`` and ``resize((cols, rows), BILINEAR)``: (rows, cols)
    or (rows, cols, 3) uint8.  The luma is ITU-R 601-2, (299 R + 587 G +
    114 B) / 1000 in PIL's 16-bit fixed point, rounded; the resize a
    horizontal pass then a vertical one with a uint8 image between them
    (a pass whose size does not change is skipped), each channel alike."""
    pix = read_png_rgb(os.path.join(_DATA_DIR, f"{name}.png"))
    if gray:
        if pix.shape[-1] == 3:
            p = pix.astype(np.int64)
            img = ((p[..., 0] * 19595 + p[..., 1] * 38470
                    + p[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)
        else:
            img = pix[..., 0]
        img = img[None]
    else:
        img = np.repeat(pix, 3, axis=-1) if pix.shape[-1] == 1 else pix
        img = np.moveaxis(img, -1, 0)  # (c, h, w): one pass per channel
    if cols is not None and img.shape[2] != cols:
        img = pil_bilinear_pass(img, cols)
    if rows is not None and img.shape[1] != rows:
        img = np.swapaxes(pil_bilinear_pass(np.swapaxes(img, 1, 2), rows),
                          1, 2)
    return img[0] if gray else np.moveaxis(img, 0, -1)


def fixture_gray(name, rows, cols):
    """data/<name>.png gray at (rows, cols) as the JAX package's benchmark
    reads it: ``fixture_uint8`` / 255 in float32."""
    return (np.asarray(fixture_uint8(name, rows, cols), np.float32)
            / np.float32(255.0))


def load_fixture_image(name="cow", size=None, gray=True):
    """A committed fixture image (data/<name>.png) as float in [0, 1],
    shape (ny, nx) when gray else (ny, nx, 3).  ``size`` resizes: an int
    means (size, size), a (ny, nx) tuple a rectangle."""
    rows = cols = None
    if size is not None:
        rows, cols = (size, size) if np.isscalar(size) else size
    return np.asarray(fixture_uint8(name, rows, cols, gray),
                      np.float64) / 255.0


def fixture_or_synthetic(name, ny, nx, nc=1, seed=42):
    """The named fixture image resized to (ny, nx, nc), or the synthetic
    piecewise-smooth pattern when name == "synthetic"."""
    if name == "synthetic":
        return synthetic_image(ny, nx, nc, seed)
    im = load_fixture_image(name, size=(ny, nx), gray=(nc == 1))
    if nc == 1:
        return im[..., None]
    if nc == 3:
        return im
    return np.repeat(im[..., None] if im.ndim == 2 else im[..., :1],
                     nc, axis=-1)


def synthetic_image(ny, nx, nc=1, seed=42):
    """Piecewise-smooth test image in [0, 1], shape (ny, nx, nc)."""
    x = np.linspace(0, 1, nx)
    y = np.linspace(0, 1, ny)
    yy, xx = np.meshgrid(y, x, indexing="ij")
    base = (
        0.4 * (((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.09)
        + 0.3 * (xx > 0.7)
        + 0.2 * np.sin(6 * np.pi * yy) * (xx < 0.25)
    )
    im = np.stack(
        [np.clip(base * (1 - 0.15 * c) + 0.05 * c, 0, 1) for c in range(nc)],
        axis=-1,
    )
    return im.astype(np.float64)


def flatten_image(im):
    """(ny, nx, nc) -> flat vector with MATLAB column-major layout
    (index = y + ny*x + nx*ny*c), the gradient blocks' label_first=False
    contract."""
    return im.transpose(2, 1, 0).reshape(-1)


def use_cpu():
    """Run on the CPU (the ``--cpu`` flag)."""
    from prost_tpu_torch import set_device

    set_device("cpu")


def add_std_args(ap, size=128):
    ap.add_argument("--size", type=int, default=size)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--max-iters", type=int, default=None)
    return ap


def apply_linop(linop, v, adjoint=False):
    """``linop.apply`` (or ``apply_adjoint``) of the host vector ``v`` on
    the linop's device, in the configured dtype, back as float64 numpy."""
    import torch

    from prost_tpu_torch.common import to_numpy
    from prost_tpu_torch.config import device, dtype

    t = torch.as_tensor(np.asarray(v, np.float64)).to(device=device(),
                                                      dtype=dtype())
    out = linop.apply_adjoint(t) if adjoint else linop.apply(t)
    return to_numpy(out).astype(np.float64)


ROUTES = ("rof", "ml", "deblur", "tight", "vol")


def route_name(backend) -> str:
    """``<backend class>:<route>``: which of the fused routes (``rof``,
    ``ml``, ``deblur``, ``tight``, ``vol``) the backend matched, ``halo``
    for a halo-sharded route, or ``generic``.  ``backend`` is a backend or a modeling ``Backend``
    factory (its last ``instance``)."""
    b = getattr(backend, "instance", None) or backend
    if getattr(b, "exchange", None) is not None:
        return f"{type(b).__name__}:halo"  # a halo-sharded fused route
    matched = [r for r in ROUTES if getattr(b, r, None) is not None]
    return f"{type(b).__name__}:{matched[0] if matched else 'generic'}"
