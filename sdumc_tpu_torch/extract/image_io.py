"""Image input of the visual stages without Pillow: a BMP / PNG reader and
bilinear and bicubic resizes equal to the bit to Pillow's.

The JAX package opens face crops with PIL (``Image.open(path).convert("RGB")
.resize((224, 224), Image.BILINEAR)``); the card's machine has no Pillow.
OpenFace writes its aligned crops as 112x112 24-bit BMP by default, so the
port reads them itself:

* BMP: uncompressed (``BI_RGB``) 24- and 32-bit, bottom-up or top-down,
  rows padded to 4 bytes, BGR(X) turned into RGB;
* PNG: 8-bit grey, RGB and RGBA, not interlaced (the IDAT
  stream inflated with ``zlib``, the five row filters undone);
* anything else (JPEG, palette or RLE BMP, 16-bit or grey+alpha PNG, ...)
  goes to Pillow,
  imported here only, which raises naming the format where it is missing.

``resize_bilinear`` and ``resize_bicubic`` are Pillow's two-pass separable
resample for 8-bit images (``libImaging/Resample.c``): the filter's
coefficients (triangle, support 1; cubic with a = -0.5, support 2) with
the support scaled by the downsampling factor, normalised per output
pixel, fixed-point at 22 bits; the horizontal pass rounds and clips to
uint8, then the vertical pass runs on that. Each pass is one integer matrix product,
computed exactly in float64 (every partial sum is an integer below 2**31).

``load_face`` is the visual stages' ``Resize((224, 224))`` + ``ToTensor``.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

PRECISION_BITS = 22
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}    # colour type (grey, RGB, RGBA) -> samples per pixel


def _format_name(head: bytes) -> str:
    for magic, name in ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"II*\x00", "TIFF"),
                        (b"MM\x00*", "TIFF"), (b"BM", "BMP"), (_PNG_MAGIC, "PNG")):
        if head.startswith(magic):
            return name
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    return "unknown"


def _read_bmp(buf: bytes) -> Optional[np.ndarray]:
    """[H, W, 3] uint8 RGB of an uncompressed 24/32-bit BMP; None for any
    other kind of BMP."""
    offset, header_size = struct.unpack_from("<I", buf, 10)[0], struct.unpack_from("<I", buf, 14)[0]
    if header_size < 40:
        return None
    width, height, _, bits, compression = struct.unpack_from("<iiHHI", buf, 18)
    if bits not in (24, 32) or compression != 0 or width <= 0 or height == 0:
        return None
    rows, bpp = abs(height), bits // 8
    stride = (width * bpp + 3) & ~3
    data = np.frombuffer(buf, np.uint8, count=stride * rows, offset=offset)
    pix = data.reshape(rows, stride)[:, :width * bpp].reshape(rows, width, bpp)
    if height > 0:                 # bottom-up: the first row stored is the last
        pix = pix[::-1]
    return np.ascontiguousarray(pix[..., 2::-1])


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline with its PNG filter undone (all arithmetic mod 256)."""
    if kind == 0:
        return raw
    if kind == 1:      # Sub: a running sum over the pixels of each channel
        return (np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.int64) % 256
                ).astype(np.uint8).reshape(-1)
    if kind == 2:      # Up
        return raw + prev
    if kind not in (3, 4):
        raise ValueError(f"PNG filter type {kind}")
    out = bytearray(raw.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:  # Average
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
        else:          # Paeth
            upleft = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(left, up[i], upleft)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _read_png(buf: bytes) -> Optional[np.ndarray]:
    """[H, W, 3] uint8 RGB of an 8-bit non-interlaced grey / RGB / RGBA
    PNG; None for any other kind of PNG."""
    pos, header, idat = len(_PNG_MAGIC), None, []
    while pos + 8 <= len(buf):
        length, kind = struct.unpack_from(">I4s", buf, pos)
        body = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace != 0:
        return None
    bpp = _PNG_CHANNELS[colour]
    rowbytes = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:height * (rowbytes + 1)].reshape(height, rowbytes + 1)
    pix = np.zeros((height, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.uint8)
    for y in range(height):
        prev = pix[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, bpp)
    pix = pix.reshape(height, width, bpp)
    if bpp == 1:                   # grey: the grey level in R, G and B
        return np.repeat(pix, 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def _read_with_pillow(path: str, fmt: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{path}: reading {fmt} images needs Pillow, which is not installed "
                           "(the port reads uncompressed 24/32-bit BMP and 8-bit PNG itself)"
                           ) from e
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def read_image(path: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB, as ``Image.open(path).convert("RGB")`` gives."""
    with open(path, "rb") as f:
        buf = f.read()
    fmt = _format_name(buf[:16])
    out = _read_bmp(buf) if fmt == "BMP" else _read_png(buf) if fmt == "PNG" else None
    return out if out is not None else _read_with_pillow(path, fmt)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


def _cubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter, a = -0.5 (Keys' cubic convolution)."""
    a, x = -0.5, np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


# Pillow's filters for 8-bit resampling: (function, support at scale 1)
FILTERS = {"bilinear": (_triangle, 1.0), "bicubic": (_cubic, 2.0)}


@functools.lru_cache(maxsize=32)
def _coefficients(in_size: int, out_size: int, kind: str = "bilinear") -> np.ndarray:
    """Pillow's fixed-point coefficients of filter ``kind`` as a dense [out,
    in] float64 matrix of integers (precompute_coeffs +
    normalize_coeffs_8bpc, operation for operation, in float64 as Pillow
    computes them)."""
    fn, base_support = FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xx = np.arange(out_size)
    center = (xx + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    arg = (taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale)
    w = np.where(taps[None, :] < xmax[:, None], fn(arg), 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):         # Pillow sums the weights in tap order
        total = total + w[:, j]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.trunc(np.where(w < 0, -0.5 + w * (1 << PRECISION_BITS),
                              0.5 + w * (1 << PRECISION_BITS)))
    mat = np.zeros((out_size, in_size))
    rows, cols = np.nonzero(taps[None, :] < xmax[:, None])
    mat[rows, xmin[rows] + cols] = fixed[rows, cols]
    mat.flags.writeable = False
    return mat


def _pass(coeffs: np.ndarray, x: np.ndarray) -> np.ndarray:
    """One resample pass along the first axis of x [in, n] (uint8): the
    product with the [out, in] coefficients, rounded, shifted and clipped
    to 0..255 as Pillow's ``clip8`` does (the bicubic filter's negative
    lobes can take a sum below 0; the shift of a negative sum floors, and
    the clip then gives 0)."""
    acc = coeffs @ x.astype(np.float64) + (1 << (PRECISION_BITS - 1))
    return np.clip(acc.astype(np.int64) >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize(img: np.ndarray, size: Tuple[int, int], kind: str) -> np.ndarray:
    out_w, out_h = size
    h, w, c = img.shape
    x = img
    if out_w != w:                 # horizontal pass, over [W, H * C]
        x = _pass(_coefficients(w, out_w, kind), x.transpose(1, 0, 2).reshape(w, h * c))
        x = x.reshape(out_w, h, c).transpose(1, 0, 2)
    if out_h != h:                 # vertical pass, over [H, w * C]
        x = _pass(_coefficients(h, out_h, kind), x.reshape(h, -1)).reshape(out_h, out_w, c)
    return np.ascontiguousarray(x)


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8 for ``size = (w, h)``, equal to the
    bit to Pillow's ``Image.resize(size, Image.BILINEAR)``."""
    return _resize(img, size, "bilinear")


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8 for ``size = (w, h)``, equal to the
    bit to Pillow's ``Image.resize(size, Image.BICUBIC)``."""
    return _resize(img, size, "bicubic")


def load_face(path: str, size: int = 224) -> np.ndarray:
    """[size, size, 3] float32 in 0..1: the image resized as Pillow's
    BILINEAR does, then divided by 255 (``ToTensor``, channels last)."""
    return resize_bilinear(read_image(path), (size, size)).astype(np.float32) / 255.0
