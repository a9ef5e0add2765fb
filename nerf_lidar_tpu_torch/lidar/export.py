# Copy of nerf_lidar_tpu/lidar/export.py (see tests/test_torch_host.py).
"""SemanticKITTI-format export: velodyne/######.bin + labels/######.label.

Rewrite of the writer in drop_simulation_rays.py:14-22,312-332: .bin holds
[x, y, z, intensity] float32 rows (KITTI convention), .label uint32 class
ids. Plus sensor metadata (lidar2egos / ego2globals) alongside.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def write_bin_label(out_dir: str, index: int, points: np.ndarray,
                    labels: Optional[np.ndarray] = None,
                    intensity: Optional[np.ndarray] = None) -> str:
    """points: [N, 3] sensor-frame; labels: [N] ints; intensity: [N]."""
    vel_dir = os.path.join(out_dir, "velodyne")
    os.makedirs(vel_dir, exist_ok=True)
    n = points.shape[0]
    if intensity is None:
        intensity = np.zeros(n, np.float32)
    arr = np.concatenate([points.astype(np.float32),
                          intensity.reshape(-1, 1).astype(np.float32)],
                         axis=1)
    bin_path = os.path.join(vel_dir, f"{index:06d}.bin")
    arr.astype(np.float32).tofile(bin_path)
    if labels is not None:
        lab_dir = os.path.join(out_dir, "labels")
        os.makedirs(lab_dir, exist_ok=True)
        labels.astype(np.uint32).tofile(
            os.path.join(lab_dir, f"{index:06d}.label"))
    return bin_path


def read_bin(path: str, dims: int = 4) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, dims)


def read_label(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.uint32)


def write_sensor_metadata(out_dir: str, lidar2egos: np.ndarray,
                          ego2globals: np.ndarray) -> None:
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "lidar2egos.npy"), lidar2egos)
    np.save(os.path.join(out_dir, "ego2globals.npy"), ego2globals)


def write_obj(path: str, points: np.ndarray) -> None:
    """Wavefront .obj point dump — the reference's universal point-cloud
    inspection format (nerflidar_related_scripts/points_check.py,
    ray_drop_compare.py:37-44, drop_samples/drop_rays_val.py:44-73 all
    write `v x y z` lines). Columns beyond xyz (e.g. a label) are appended
    to each vertex line like gt_label.py:18-23 does."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for v in np.asarray(points, np.float64):
            f.write("v " + " ".join(f"{x:.8f}" for x in v) + "\n")


def load_points_any(path: str, dims: int = 0,
                    n_points: int = 0) -> np.ndarray:
    """Load a point cloud from any of the formats the reference's vis
    scripts juggle by hand (points_check.py:3-20): SemanticKITTI `.bin`
    (N x 3/4/5 float32 rows — real nuScenes exports are N x 5, this
    framework's exports N x 4; pass dims to force), rendered `points_*.npy`
    (N x 3), or channel-major [3, N] arrays (transposed automatically).
    `n_points` (e.g. the sibling .label count) disambiguates float counts
    divisible by several row widths. Returns [N, 3] xyz."""
    if path.endswith(".npy"):
        pts = np.load(path)
        if pts.ndim == 2 and pts.shape[0] == 3 and pts.shape[1] > 3:
            pts = pts.T
        return np.asarray(pts[:, :3], np.float32)
    raw = np.fromfile(path, dtype=np.float32)
    if dims:
        return raw.reshape(-1, dims)[:, :3]
    if n_points and raw.size % n_points == 0 and raw.size // n_points in \
            (3, 4, 5):
        return raw.reshape(n_points, -1)[:, :3]
    # Prefer width 4 (SemanticKITTI xyzi AND this framework's own
    # write_bin_label exports) over 5 (KITTI-with-ring variants): with
    # divisibility as the only signal, a 4-wide file whose float count
    # happens to divide 5 must not silently shear every xyz across rows.
    for d in (4, 5, 3):
        if raw.size % d == 0:
            return raw.reshape(-1, d)[:, :3]
    raise ValueError(f"{path}: {raw.size} floats is not N x 3/4/5")
