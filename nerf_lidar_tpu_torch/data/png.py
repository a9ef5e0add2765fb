"""PNG reading and writing with numpy and zlib alone, so that the port's
scene loader and synthetic-scene writer need neither imageio nor Pillow.

`read_png` decodes non-interlaced 8- and 16-bit grey, grey + alpha, RGB
and RGBA images (every row filter); `write_png` encodes uint8 [H, W],
[H, W, 3] or [H, W, 4] and uint16 [H, W] arrays, each row unfiltered. Both
keep the pixel values exactly. `imread` reads PNG through them and other
formats through imageio.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write a uint8 [H, W] / [H, W, 3] / [H, W, 4] or uint16 [H, W] image."""
    a = np.asarray(image)
    if a.dtype not in (np.uint8, np.uint16) or a.ndim not in (2, 3) or (
            a.ndim == 3 and a.shape[2] not in (3, 4)) or (
            a.dtype == np.uint16 and a.ndim != 2):
        raise ValueError(f"write_png: unsupported {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    colour = 0 if a.ndim == 2 else (2 if a.shape[2] == 3 else 6)
    rows = a.astype(a.dtype.newbyteorder(">")).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8 * a.itemsize, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of [h, 1 + stride] bytes (PNG spec 9)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:  # Up
            cur = (line + prev) & 0xFF
        elif kind == 1:  # Sub: a running sum per byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: pixel by pixel
            cur = line.copy()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                up = prev[x]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    ul = prev[x - bpp] if x >= bpp else 0
                    p = left + up - ul
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                    pred = left if pa <= pb and pa <= pc else (
                        up if pb <= pc else ul)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"read_png: bad row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG into uint8 or uint16 [H, W] (grey) or [H, W, C]."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth not in (8, 16) or colour not in _CHANNELS or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {colour}, interlace {interlace})")
    channels, nbytes = _CHANNELS[colour], depth // 8
    stride = w * channels * nbytes
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    pixels = _unfilter(raw.reshape(h, 1 + stride), h, stride,
                       channels * nbytes)
    if nbytes == 2:
        pixels = pixels.view(">u2").astype(np.uint16)
    pixels = pixels.reshape(h, w, channels)
    return pixels[..., 0] if channels == 1 else pixels


def imread(path: str) -> np.ndarray:
    """An image file as an array: PNG through `read_png`, any other format
    through imageio, which the port otherwise does without (a machine
    without it stops here with a message that names it)."""
    if path.lower().endswith(".png"):
        return read_png(path)
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(
            f"{path}: reading a {os.path.splitext(path)[1]} image needs "
            "imageio, which is not installed; convert the capture to PNG "
            "(the port reads PNG itself)") from e
    return np.asarray(imageio.imread(path))
