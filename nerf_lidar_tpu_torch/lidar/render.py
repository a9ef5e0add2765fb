"""LiDAR sweep rendering (port of `nerf_lidar_tpu/lidar/render.py`).

Renders each sweep through the port's `ChunkRenderer` and writes the same
on-disk interface as the reference: points_####.npy (world points),
points_semantic_####.npy (class probabilities) and points_rgb_####.npy.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..renderer import ChunkRenderer
from .sensor import Sweep
from .transforms import SceneFrame


def render_sweep(renderer: ChunkRenderer, sweep: Sweep, near: float,
                 far: float, frame: SceneFrame) -> Dict[str, np.ndarray]:
    """Render one sweep. Returns dict with points [N, 3] (world frame),
    depth [N] (scene frame), rgb [N, 3], and semantic [N, K] / intensity
    [N] when the model has those heads."""
    out = renderer.render(sweep.ray_batch(near, far))
    depth = out["depth"]
    pts_scene = sweep.origins + depth[:, None] * sweep.directions
    pts_world = frame.scene_to_world_points(pts_scene)
    result = dict(points=pts_world.astype(np.float32),
                  depth=depth.astype(np.float32),
                  rgb=out["rgb"].astype(np.float32))
    for k in ("semantic", "intensity"):
        if k in out:
            result[k] = out[k].astype(np.float32)
    return result


def render_sweeps_to_dir(renderer: ChunkRenderer, sweeps: List[Sweep],
                         near: float, far: float, frame: SceneFrame,
                         out_dir: str) -> List[str]:
    """Render sweeps and write the points / points_semantic / points_rgb
    trio per sweep. Returns the written point-file paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for idx, sweep in enumerate(sweeps):
        out = render_sweep(renderer, sweep, near, far, frame)
        p = os.path.join(out_dir, f"points_{idx:04d}.npy")
        np.save(p, out["points"])
        if "semantic" in out:
            np.save(os.path.join(out_dir, f"points_semantic_{idx:04d}.npy"),
                    out["semantic"])
        np.save(os.path.join(out_dir, f"points_rgb_{idx:04d}.npy"),
                out["rgb"])
        paths.append(p)
    return paths
