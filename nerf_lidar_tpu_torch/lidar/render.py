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
                 far: float, frame: SceneFrame, tracks=None,
                 track_mask=None) -> Dict[str, np.ndarray]:
    """Render one sweep, with the dynamic objects of `tracks` / `track_mask`
    (tensors on the model's device) placed at the sweep's timestamp.
    Returns dict with points [N, 3] (world frame), depth [N] (scene frame),
    rgb [N, 3], and semantic [N, K] / intensity [N] when the model has
    those heads."""
    out = renderer.render(sweep.ray_batch(near, far), tracks, track_mask)
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
                         out_dir: str, tracks=None,
                         track_mask=None) -> List[str]:
    """Render sweeps and write the points / points_semantic / points_rgb
    trio per sweep. Returns the point-file paths. With the renderer's data
    mesh every rank renders its rows and rank 0 alone writes."""
    mesh = renderer.mesh
    writer = mesh is None or mesh.rank == 0
    if writer:
        os.makedirs(out_dir, exist_ok=True)
    paths = []
    for idx, sweep in enumerate(sweeps):
        out = render_sweep(renderer, sweep, near, far, frame, tracks,
                           track_mask)
        p = os.path.join(out_dir, f"points_{idx:04d}.npy")
        paths.append(p)
        if not writer:
            continue
        np.save(p, out["points"])
        if "semantic" in out:
            np.save(os.path.join(out_dir, f"points_semantic_{idx:04d}.npy"),
                    out["semantic"])
        np.save(os.path.join(out_dir, f"points_rgb_{idx:04d}.npy"),
                out["rgb"])
    return paths
