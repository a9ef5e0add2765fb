"""A reader and a writer of Flax's msgpack checkpoints, without `msgpack`
or `flax` (counterparts of `flax.serialization.msgpack_restore`, which
`nerf_lidar_tpu/train/checkpoints.py:restore_model_params` calls, and of
`msgpack_serialize`, which `to_bytes` calls).

The JAX package writes its train states (`checkpoint_<step>.ckpt`) and
ray-drop states (`raydrop_#####.ckpt`) with `flax.serialization.to_bytes`:
msgpack with three extension types and a chunked form for large arrays.
This module decodes the subset that Flax writes:

- maps (dicts; tuples, lists and optax states arrive keyed "0", "1", ...),
  arrays (lists), str, bin (bytes), ints, float32 / float64 (float), nil,
  bool;
- ext 1, an ndarray: a nested msgpack array (shape, dtype name, the C-order
  bytes);
- ext 2, a complex number: a nested (real, imag);
- ext 3, a numpy scalar: an ndarray of shape () unpacked to its scalar;
- the chunked form of arrays over Flax's MAX_CHUNK_SIZE (2^30 bytes):
  {"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": flat array, ...}}, joined back as Flax joins them.

The file is parsed from one `memoryview` and every array is an
`np.frombuffer` view into it, so no leaf is copied on the way (a 240 MB
hash table included); the views are read-only, and whoever turns one into
a tensor copies it once. A `bfloat16` leaf (numpy has no such type without
`ml_dtypes`) is read as uint16 and returned as a `torch.bfloat16` tensor
with the same bits.

`msgpack_serialize` writes the bytes Flax's `msgpack_serialize` writes for
a tree of dicts (str keys), lists and tuples, str, bytes, bool, None, ints,
floats, numpy arrays and numpy scalars: msgpack's shortest form of each
value, arrays over MAX_CHUNK_SIZE chunked as Flax chunks them (where Flax
does: at the top, or as a dict's value).
"""

from __future__ import annotations

import os
import struct
from typing import Any, Tuple

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """Sequential msgpack decoder over a memoryview."""

    def __init__(self, data, raw: bool = False):
        self.mv = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw  # str as bytes (Flax's nested ndarray header)

    def _take(self, n: int) -> memoryview:
        start = self.pos
        self.pos += n
        if self.pos > len(self.mv):
            raise ValueError("msgpack: truncated input")
        return self.mv[start:self.pos]

    def _unpack(self, fmt: str) -> Tuple:
        out = struct.unpack_from(fmt, self.mv, self.pos)
        self.pos += struct.calcsize(fmt)
        return out

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _array(self, n: int):
        return [self.read() for _ in range(n)]

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")[0]
        return _ext_value(code, self._take(n))

    def read(self) -> Any:
        b = self._unpack(">B")[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _BIN:
            return bytes(self._take(self._unpack(_BIN[b])[0]))
        if b in _EXT:
            return self._ext(self._unpack(_EXT[b])[0])
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        if b in _NUMBER:
            return self._unpack(_NUMBER[b])[0]
        if b in _STR:
            return self._str(self._unpack(_STR[b])[0])
        if b in _ARRAY:
            return self._array(self._unpack(_ARRAY[b])[0])
        if b in _MAP:
            return self._map(self._unpack(_MAP[b])[0])
        raise ValueError(f"msgpack: type byte 0x{b:02x} is not supported")


_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_NUMBER = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
           0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


def _ndarray(data: memoryview):
    """Flax's ext-1 payload: msgpack (shape, dtype name, C-order bytes)."""
    shape, name, buf = _Reader(data, raw=True).read()
    name = name.decode("ascii")
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


def _ext_value(code: int, data: memoryview):
    if code == 1:
        return _ndarray(data)
    if code == 2:
        real, imag = _Reader(data).read()
        return complex(real, imag)
    if code == 3:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack: extension type {code} is not Flax's")


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """Flax's `_unchunk_array_leaves_in_place`: chunked arrays, at the top
    or in nested dicts, joined back into arrays."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_leaves(v)
    return d


def msgpack_restore(data) -> Any:
    """The tree Flax's `msgpack_restore` returns for the same bytes (bytes,
    bytearray, memoryview or an mmap): dicts, lists and Python scalars,
    numpy arrays (read-only views into `data`) and numpy scalars, bfloat16
    leaves as torch tensors."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.mv):
        raise ValueError(f"msgpack: {len(reader.mv) - reader.pos} bytes "
                         "after the first object")
    return _unchunk_leaves(out)


def read_file(path: str) -> Any:
    """`msgpack_restore` of a file's bytes."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# ------------------------------------------------------------- writer
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE, in bytes


def _head(n: int, fix: int, fix_max: int, wide) -> bytes:
    """A length header: the fix form up to `fix_max`, else the first of
    `wide` ((type byte, struct format, exclusive top), ...) that holds n."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in wide:
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} is too large")


_W8, _W16, _W32 = 1 << 8, 1 << 16, 1 << 32


def _pack_int(x: int) -> bytes:
    if 0 <= x <= 0x7F or -32 <= x < 0:
        return struct.pack(">b" if x < 0 else ">B", x)
    for lo, hi, code, fmt in ((0, _W8, 0xCC, ">B"), (0, _W16, 0xCD, ">H"),
                              (0, _W32, 0xCE, ">I"), (0, 1 << 64, 0xCF, ">Q"),
                              (-(1 << 7), 0, 0xD0, ">b"),
                              (-(1 << 15), 0, 0xD1, ">h"),
                              (-(1 << 31), 0, 0xD2, ">i"),
                              (-(1 << 63), 0, 0xD3, ">q")):
        if lo <= x < hi:
            return bytes([code]) + struct.pack(fmt, x)
    raise ValueError(f"msgpack: integer {x} does not fit 64 bits")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(data))
    head = (bytes([fixed]) if fixed is not None else _head(
        len(data), None, 0, ((0xC7, ">B", _W8), (0xC8, ">H", _W16),
                             (0xC9, ">I", _W32))))
    return head + struct.pack(">b", code) + data


def _ndarray_bytes(a: np.ndarray) -> bytes:
    """Flax's `_ndarray_to_bytes`: msgpack (shape, dtype name, C-order
    bytes)."""
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not "
                         "serialised")
    return _pack((tuple(a.shape), a.dtype.name, a.tobytes("C")))


def _pack(x) -> bytes:
    if x is None:
        return b"\xc0"
    if x is True or x is False:
        return b"\xc3" if x else b"\xc2"
    if isinstance(x, dict):
        return _head(len(x), 0x80, 15, ((0xDE, ">H", _W16),
                                        (0xDF, ">I", _W32))) + b"".join(
            _pack(k) + _pack(v) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return _head(len(x), 0x90, 15, ((0xDC, ">H", _W16),
                                        (0xDD, ">I", _W32))) + b"".join(
            _pack(v) for v in x)
    if isinstance(x, str):
        b = x.encode("utf-8")
        return _head(len(b), 0xA0, 31, ((0xD9, ">B", _W8),
                                        (0xDA, ">H", _W16),
                                        (0xDB, ">I", _W32))) + b
    if isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        return _head(len(b), None, 0, ((0xC4, ">B", _W8),
                                       (0xC5, ">H", _W16),
                                       (0xC6, ">I", _W32))) + b
    if isinstance(x, np.ndarray):
        return _pack_ext(1, _ndarray_bytes(x))
    if isinstance(x, np.generic):
        return _pack_ext(3, _ndarray_bytes(np.asarray(x)))
    if isinstance(x, int):
        return _pack_int(x)
    if isinstance(x, float):
        return b"\xcb" + struct.pack(">d", x)
    if isinstance(x, complex):
        return _pack_ext(2, _pack((x.real, x.imag)))
    raise TypeError(f"msgpack: cannot serialise {type(x).__name__}")


def _chunk(a: np.ndarray) -> dict:
    """Flax's `_chunk`: a flat array cut into MAX_CHUNK_SIZE pieces."""
    size = max(1, int(MAX_CHUNK_SIZE / a.dtype.itemsize))
    flat = a.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): n for i, n in enumerate(a.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.size, size))}}


def _chunk_leaves(d):
    """Flax's `_chunk_array_leaves_in_place`, on a copy of the dicts."""
    big = lambda v: isinstance(v, np.ndarray) and \
        v.size * v.dtype.itemsize > MAX_CHUNK_SIZE  # noqa: E731
    if isinstance(d, dict):
        return {k: _chunk(v) if big(v) else _chunk_leaves(v)
                if isinstance(v, dict) else v for k, v in d.items()}
    return _chunk(d) if big(d) else d


def msgpack_serialize(tree) -> bytes:
    """The bytes `flax.serialization.msgpack_serialize` writes for `tree`
    (torch tensors are written as the numpy arrays of their values). Each
    dict's keys are sorted, as `jax.tree_util` sorts them on the way to
    Flax's writer (`jax.device_get`, `msgpack_serialize`)."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        if isinstance(x, dict):
            return {k: host(v) for k, v in sorted(x.items())}
        return x
    return _pack(_chunk_leaves(host(tree)))


def write_file(path: str, tree) -> str:
    """`msgpack_serialize` of `tree` into a file (written under a temporary
    name, then renamed)."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(tree))
    os.replace(tmp, path)
    return path
