"""Build and load the port's CUDA kernels (`nerf_lidar_tpu_torch/csrc/`).

One `nvcc -shared` call compiles every `.cu` source into a shared library
with a plain C interface, which `ctypes` loads. The library goes into
`nerf_lidar_tpu_torch/_build/` (gitignored), named by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one loads at once.

Unlike `nerf_lidar_tpu/native.py`, a build or load failure raises: a CUDA
tensor that reaches a kernel wrapper runs the kernel or fails loudly, never
a quiet fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # density, tdist, dirs, rgb, sem, inten, weights, rgb_out, sem_out,
    # inten_out, depth_out, acc_out, R, S, K, opaque, bg, device, stream
    "nl_composite": [_P] * 12 + [_LL, _I, _I, _I, _F, _I, _P],
    # table, x01, stds, out, resid, B, n, L, C, scale, grid_size, res,
    # rows, offset, tiled, mean, tetra, level_major, slices, lanes, device,
    # stream
    "nl_hash_encode_ms": [_P] * 5 + [_LL, _I, _I, _I] + [_P] * 7
                         + [_I, _I, _I, _I, _I, _P],
    # x01, stds, g_out, d_table, scratch, B, n, L, C, scale, grid_size,
    # res, rows, offset, tiled, mean, tetra, level_major, slices, device,
    # stream
    "nl_hash_encode_ms_bwd": [_P] * 5 + [_LL, _I, _I, _I] + [_P] * 7
                             + [_I, _I, _I, _I, _P],
    # x01, stds, g_out, k, acc, flags, B, n, L, C, scale, grid_size, res,
    # rows, offset, tiled, mean, tetra, level_major, threads, slices,
    # device, stream
    "nl_hash_encode_ms_bwd_fixed": [_P] * 6 + [_LL, _I, _I, _I] + [_P] * 7
                                   + [_I, _I, _I, _I, _I, _P],
    # resid, g_out, d_x01, d_stds, B, n, L, C, device, stream
    "nl_hash_encode_ms_pos_grads": [_P] * 4 + [_LL, _I, _I, _I, _I, _P],
    # idx, vals, out, N, C, rows, device, stream
    "nl_scatter_add_rows": [_P] * 3 + [_LL, _I, _LL, _I, _P],
    # idx, vals, k, acc, flags, N, C, rows, device, stream
    "nl_scatter_add_rows_fixed": [_P] * 5 + [_LL, _I, _LL, _I, _P],
    # acc, flags, k, starts, G, out, rows, C, device, stream
    "nl_fixed_to_float": [_P] * 4 + [_I, _P, _LL, _I, _I, _P],
    # v, part, ticket, S, k, N, F, V, Q, P, chunk, device, stream
    "nl_abs_bound": [_P] * 5 + [_LL, _I, _I, _I, _I, _LL, _I, _P],
    # rows, terms, M, C, acc, transposed, device, stream
    "nl_fixed_sink": [_P, _P, _LL, _I, _P, _I, _I, _P],
    # tbl, idx, out, A, B, G, I, J, axis, device, stream
    "nl_take_along_axis": [_P] * 3 + [_I, _I, _LL, _I, _I, _I, _I, _P],
    # tbl, idx, out, R, C, N, device, stream
    "nl_take_rows": [_P] * 3 + [_I, _I, _LL, _I, _P],
    # device, stream
    "nl_empty_kernel": [_I, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (os.path.join(home, "bin", "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels cannot be built")


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libnerf_lidar_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    # Build under a temporary name, then rename: a build cut short never
    # leaves a library that a later run would load.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nl_error_string.argtypes = [ctypes.c_int]
    lib.nl_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.nl_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, t: torch.Tensor, shape,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise unless t is a contiguous CUDA tensor of `dtype` and `shape`
    (entries of None match any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if len(t.shape) != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def launch_empty(device: torch.device) -> None:
    """One launch of an empty kernel on `device`'s current stream: its
    device time is the card's launch floor."""
    lib = library()
    check(lib, lib.nl_empty_kernel(device.index, torch.cuda.current_stream(
        device).cuda_stream), "empty_kernel")
