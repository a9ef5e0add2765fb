# Copy of nerf_lidar_tpu/data/road_augment.py (see tests/test_torch_host.py).
"""Road-ray augmentation: perturb ray origins while keeping the hit point.

Rewrite of reference internal/road_augment.py: for rays with known depth,
move the origin by a random unit offset * delta and re-aim the ray at the
original 3D hit point, recomputing depth — a free-viewpoint consistency
augmentation for road surfaces. Host-side numpy (runs in the batcher).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def batch_perturb(batch: Dict[str, np.ndarray], delta: float = 0.1,
                  rng: np.random.RandomState | None = None
                  ) -> Dict[str, np.ndarray]:
    rng = rng or np.random.RandomState(0)
    out = dict(batch)
    origins = batch["origins"]
    directions = batch["directions"]
    depths = batch["depth"]
    unit_dir = directions / (np.linalg.norm(directions, axis=-1,
                                            keepdims=True) + 1e-8)
    target = origins + depths[:, None] * unit_dir
    ptb = rng.rand(*origins.shape).astype(np.float32)
    ptb /= np.linalg.norm(ptb, axis=-1, keepdims=True) + 1e-8
    new_origins = origins + ptb * delta
    new_depths = np.linalg.norm(target - new_origins, axis=-1)
    new_dirs = (target - new_origins) / (new_depths[:, None] + 1e-12)
    out["origins"] = new_origins.astype(np.float32)
    out["directions"] = new_dirs.astype(np.float32)
    out["viewdirs"] = new_dirs.astype(np.float32)
    out["base_x"] = new_dirs.astype(np.float32)
    out["base_y"] = new_dirs.astype(np.float32)
    out["depth"] = new_depths.astype(np.float32)
    out["aug_mask"] = (depths == 0).astype(np.float32)
    return out
