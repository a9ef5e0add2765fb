# Copy of nerf_lidar_tpu/lidar/transforms.py (see tests/test_torch_host.py).
"""Centralized coordinate-frame bookkeeping.

The reference spells the chain `lidar2global -> cam -> PCA recenter -> scene
scale` inline in 6+ places with mixed transpose conventions
(lidar_utils.py:193-267, nerf2world.py:22-71); SURVEY.md ranks this a top
hard part. Here there is exactly one implementation, tested for roundtrips.

Conventions: matrices are [4,4] homogeneous, applied to column vectors
(`y = T @ x`); the row-vector helpers below handle the `x @ R.T + t` form.
Scene coordinates = PCA-recentered world * scale_factor.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def apply_rigid(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply [4,4] (or [3,4]) transform to [..., 3] points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def apply_rotation(T: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    return vecs @ T[:3, :3].T


def inv_rigid(T: np.ndarray) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    out = np.eye(4, dtype=T.dtype)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


@dataclasses.dataclass(frozen=True)
class SceneFrame:
    """World <-> scene mapping: scene = scale * (recenter @ world).

    `recenter` is the [4,4] PCA transform from camera.transform_poses_pca,
    `scale` the clamped autoscale. Matches the reference's persisted
    c2w_recenter_transform.npy + scene_scale.npy pair (datasets.py:1230-1232).
    """
    recenter: np.ndarray  # [4, 4] world -> recentered
    scale: float

    def world_to_scene_points(self, pts: np.ndarray) -> np.ndarray:
        return apply_rigid(self.recenter, pts) * self.scale

    def scene_to_world_points(self, pts: np.ndarray) -> np.ndarray:
        return apply_rigid(inv_rigid(self.recenter), pts / self.scale)

    def world_to_scene_dirs(self, dirs: np.ndarray) -> np.ndarray:
        return apply_rotation(self.recenter, dirs)

    def scene_to_world_dirs(self, dirs: np.ndarray) -> np.ndarray:
        return apply_rotation(inv_rigid(self.recenter), dirs)

    def world_depth_to_scene(self, d: np.ndarray) -> np.ndarray:
        return d * self.scale

    def scene_depth_to_world(self, d: np.ndarray) -> np.ndarray:
        return d / self.scale

    @staticmethod
    def identity() -> "SceneFrame":
        return SceneFrame(np.eye(4, dtype=np.float32), 1.0)


def lidar_dirs_to_world(dirs_lidar: np.ndarray,
                        lidar2global: np.ndarray) -> np.ndarray:
    """Rotate LiDAR-frame beam directions into the world (global) frame."""
    return apply_rotation(lidar2global, dirs_lidar)
