"""Chunked full-sweep and full-view rendering (port of
`nerf_lidar_tpu/renderer.py`).

Rays are padded to a multiple of the chunk size by repeating the last ray
(the reference's `_pad_to`), streamed through the model chunk by chunk
under `torch.no_grad()`, and sliced back to N on the host. The dynamic
objects' tracks go with every chunk; the rays' timestamps place them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .models.model import Model

# Ray fields the model reads (timestamp: for the dynamic objects).
_RAY_KEYS = ("origins", "directions", "viewdirs", "radii", "base_x",
             "base_y", "near", "far", "timestamp")


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)


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
    """

    def __init__(self, model: Model, config, chunk_size: int = 16384,
                 use_kernels: bool = True, compute_extras: bool = False,
                 fused: Optional[bool] = None):
        self.model = model
        self.chunk = chunk_size
        if fused is None:
            fused = config.render_fused is not False
        self.fused = bool(fused) and not compute_extras
        self.compute_extras = compute_extras
        self.use_kernels = use_kernels

    @torch.no_grad()
    def render(self, rays: Dict[str, np.ndarray],
               tracks: Optional[torch.Tensor] = None,
               track_mask: Optional[torch.Tensor] = None
               ) -> Dict[str, np.ndarray]:
        """rays: dict of [N, ...] numpy arrays; tracks / track_mask: the
        model's track tensor and slot mask on its device, or None. Returns
        the final level's renderings as [N, ...] numpy arrays."""
        device = self.model.nerf_mlp.table.device
        n = rays["origins"].shape[0]
        n_pad = (n + self.chunk - 1) // self.chunk * self.chunk
        rays_p = {k: _pad_to(np.asarray(rays[k], np.float32), n_pad)
                  for k in _RAY_KEYS if k in rays}
        outs = []
        for i in range(0, n_pad, self.chunk):
            batch = {k: torch.from_numpy(v[i:i + self.chunk]).to(device)
                     for k, v in rays_p.items()}
            renderings, _ = self.model(batch, train_frac=1.0,
                                       fused_final=self.fused,
                                       use_kernels=self.use_kernels,
                                       compute_extras=self.compute_extras,
                                       tracks=tracks, track_mask=track_mask)
            outs.append({k: v.cpu().numpy()
                         for k, v in renderings[-1].items()})
        return {k: np.concatenate([o[k] for o in outs], axis=0)[:n]
                for k in outs[0]}


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
