"""Chunked full-sweep and full-view rendering (port of
`nerf_lidar_tpu/renderer.py`).

Rays are padded to a multiple of the chunk step by repeating the last ray
(the reference's `_pad_to`), streamed through the model chunk by chunk
under `torch.no_grad()`, and sliced back to N on the host. The dynamic
objects' tracks go with every chunk; the rays' timestamps place them.

The rays go to the device once, from pinned memory. Chunks are dispatched
up to `WINDOW` ahead of the fetch, and each chunk's outputs are then copied
behind into pinned host buffers without a wait, so the host waits for the
device once per render, not once per chunk (as the JAX renderer's window).
With a data mesh (`parallel.DataMesh`) the chunk step is a multiple of the
data shards, each rank renders its rows of every chunk, and the outputs are
all-gathered in ray order: every rank returns the whole render.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from .models.model import Model

# Ray fields the model reads (timestamp: for the dynamic objects;
# exposure_values / exposure_idx: RawNeRF views; cam_idx: GLO). Float fields
# go as float32, the integer ones keep their dtype.
_RAY_KEYS = ("origins", "directions", "viewdirs", "radii", "base_x",
             "base_y", "near", "far", "timestamp", "exposure_values",
             "exposure_idx", "cam_idx")
# Chunks dispatched ahead of the fetch: bounds the chunk outputs resident
# on the device to WINDOW + 1.
WINDOW = 8


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)


def _gather(mesh, v: torch.Tensor) -> torch.Tensor:
    """All data shards' rows of a chunk output, in ray order (a bool mask
    travels as uint8)."""
    if v.dtype == torch.bool:
        return mesh.all_gather_rows(v.to(torch.uint8)).bool()
    return mesh.all_gather_rows(v)


class ChunkRenderer:
    """Chunked renderer over ray dicts, on the model's device.

    fused: composite the final level with `fused_composite` (kernel K1 on
      CUDA); None takes the config's `render_fused`, unset meaning fused,
      the reference's choice on its accelerator. Always off with
      `compute_extras`, whose distance statistics K1 does not compute.
    compute_extras: the renderings also hold acc, distance_mean and the
      distance percentiles (the image entries' panels).
    use_kernels: False renders with the plain torch versions of every
      kernel (for comparisons); the default takes the kernels on CUDA.
    mesh: a `parallel.DataMesh` to split every chunk over its data shards.
    """

    def __init__(self, model: Model, config, chunk_size: int = 16384,
                 use_kernels: bool = True, compute_extras: bool = False,
                 fused: Optional[bool] = None, mesh=None):
        self.model = model
        self.chunk = chunk_size
        if fused is None:
            fused = config.render_fused is not False
        self.fused = bool(fused) and not compute_extras
        self.compute_extras = compute_extras
        self.use_kernels = use_kernels
        self.mesh = mesh

    @torch.no_grad()
    def render(self, rays: Dict[str, np.ndarray],
               tracks: Optional[torch.Tensor] = None,
               track_mask: Optional[torch.Tensor] = None
               ) -> Dict[str, np.ndarray]:
        """rays: dict of [N, ...] numpy arrays; tracks / track_mask: the
        model's track tensor and slot mask on its device, or None. Returns
        the final level's renderings as [N, ...] numpy arrays."""
        device = self.model.nerf_mlp.table.device
        cuda = device.type == "cuda"
        n = rays["origins"].shape[0]
        shards = 1 if self.mesh is None else self.mesh.data_size
        step = max(self.chunk // shards * shards, shards)
        n_pad = (n + step - 1) // step * step
        mine = slice(0, step) if self.mesh is None else self.mesh.rows(step)
        rays_d = {}
        for k in _RAY_KEYS:
            if k in rays:
                arr = np.asarray(rays[k])
                if arr.dtype.kind == "f":
                    arr = arr.astype(np.float32)
                t = torch.from_numpy(_pad_to(arr, n_pad))
                rays_d[k] = (t.pin_memory().to(device, non_blocking=True)
                             if cuda else t)
        host: Dict[str, torch.Tensor] = {}

        def fetch(i, out):
            for k, v in out.items():
                if k not in host:
                    host[k] = torch.empty((n_pad,) + v.shape[1:],
                                          dtype=v.dtype, pin_memory=cuda)
                host[k][i:i + step].copy_(v, non_blocking=cuda)

        pending = deque()
        for i in range(0, n_pad, step):
            batch = {k: v[i + mine.start:i + mine.stop]
                     for k, v in rays_d.items()}
            renderings, _ = self.model(batch, train_frac=1.0,
                                       fused_final=self.fused,
                                       use_kernels=self.use_kernels,
                                       compute_extras=self.compute_extras,
                                       tracks=tracks, track_mask=track_mask)
            out = renderings[-1]
            if self.mesh is not None:
                out = {k: _gather(self.mesh, v) for k, v in out.items()}
            pending.append((i, out))
            if len(pending) > WINDOW:
                fetch(*pending.popleft())
        while pending:
            fetch(*pending.popleft())
        if cuda:
            torch.cuda.current_stream(device).synchronize()
        return {k: v[:n].numpy() for k, v in host.items()}


def render_view(renderer: ChunkRenderer, rays_hw: Dict[str, np.ndarray],
                tracks: Optional[torch.Tensor] = None,
                track_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, np.ndarray]:
    """Render a full [H, W] ray grid; returns [H, W, ...] images."""
    h, w = rays_hw["origins"].shape[:2]
    flat = {k: np.asarray(v).reshape((h * w,) + np.asarray(v).shape[2:])
            for k, v in rays_hw.items()}
    out = renderer.render(flat, tracks, track_mask)
    return {k: v.reshape((h, w) + v.shape[1:]) for k, v in out.items()}
