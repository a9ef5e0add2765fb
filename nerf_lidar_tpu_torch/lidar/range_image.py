# Copy of nerf_lidar_tpu/lidar/range_image.py (see tests/test_torch_host.py).
"""Spherical range-image projection (LaserScan analog) + feature helpers.

Rewrite of NeRF_Lidar_code/src/lidar_utils.py:57-381 (itself from
semantic-kitti-api): project a point cloud into an H=32 x W=1024 range image
with a depth-sorted z-buffer, carrying range / xyz / semantic / rgb / index
/ mask channels. Host-side numpy, matching the reference's offline-prep
placement; `project_range_image_torch` gives the nearest-depth image of a
tensor on its device (the original's jittable segment_min version).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

FOV_UP_DEG = 10.67
FOV_DOWN_DEG = -30.67
DEFAULT_H = 32
DEFAULT_W = 1024
RANGE_LOG_NORM = 6.5  # log2(r+1)/6.5 (Generate_feature.py:44-48)


@dataclasses.dataclass
class RangeImage:
    range: np.ndarray  # [H, W] metric range, -1 where empty
    xyz: np.ndarray  # [H, W, 3]
    semantic: np.ndarray  # [H, W]
    rgb: np.ndarray  # [H, W, 3]
    idx: np.ndarray  # [H, W] source point index, -1 where empty
    mask: np.ndarray  # [H, W] 1 where a point landed
    proj_x: np.ndarray  # [N] column of each input point
    proj_y: np.ndarray  # [N] row of each input point


def project_points(points: np.ndarray,
                   semantic: Optional[np.ndarray] = None,
                   rgb: Optional[np.ndarray] = None,
                   h: int = DEFAULT_H, w: int = DEFAULT_W,
                   fov_up: float = FOV_UP_DEG,
                   fov_down: float = FOV_DOWN_DEG) -> RangeImage:
    """Depth-sorted spherical projection (lidar_utils.py:215-283).

    points: [N, 3] in the sensor frame. Nearest point wins each pixel
    (points scattered in decreasing depth order). Always numpy: the port
    loads no native library (the original's numpy branch).
    """
    n = points.shape[0]
    fov_up_r = fov_up / 180.0 * np.pi
    fov_down_r = fov_down / 180.0 * np.pi
    fov = abs(fov_down_r) + abs(fov_up_r)

    depth = np.linalg.norm(points, 2, axis=1)
    depth = np.maximum(depth, 1e-9)
    yaw = -np.arctan2(points[:, 1], points[:, 0])
    pitch = np.arcsin(np.clip(points[:, 2] / depth, -1, 1))

    proj_x = 0.5 * (yaw / np.pi + 1.0) * w
    proj_y = (1.0 - (pitch + abs(fov_down_r)) / fov) * h
    proj_x = np.clip(np.floor(proj_x), 0, w - 1).astype(np.int32)
    proj_y = np.clip(np.floor(proj_y), 0, h - 1).astype(np.int32)

    semantic = (semantic if semantic is not None
                else np.zeros(n, np.float32))
    rgb = rgb if rgb is not None else np.zeros((n, 3), np.float32)

    order = np.argsort(depth)[::-1]
    py, px = proj_y[order], proj_x[order]

    img_range = np.full((h, w), -1.0, np.float32)
    img_xyz = np.full((h, w, 3), -1.0, np.float32)
    img_sem = np.zeros((h, w), semantic.dtype)
    img_rgb = np.zeros((h, w, 3), np.float32)
    img_idx = np.full((h, w), -1, np.int64)

    img_range[py, px] = depth[order]
    img_xyz[py, px] = points[order]
    img_sem[py, px] = semantic[order]
    img_rgb[py, px] = rgb[order]
    img_idx[py, px] = np.arange(n)[order]
    # NOTE: reference uses (proj_idx > 0) which spuriously drops point id 0
    # (lidar_utils.py:282); we use >= 0.
    mask = (img_idx >= 0).astype(np.float32)

    return RangeImage(img_range, img_xyz, img_sem, img_rgb, img_idx, mask,
                      proj_x, proj_y)


def project_range_image_torch(points, h: int = DEFAULT_H,
                              w: int = DEFAULT_W,
                              fov_up: float = FOV_UP_DEG,
                              fov_down: float = FOV_DOWN_DEG):
    """Nearest-depth range image of a [N, 3] tensor, on its device, by a
    scatter-min (returns range [h, w] with +inf empties, and each point's
    flat bin id)."""
    import torch

    fov_up_r = fov_up / 180.0 * np.pi
    fov_down_r = fov_down / 180.0 * np.pi
    fov = abs(fov_down_r) + abs(fov_up_r)

    depth = torch.clamp(torch.linalg.norm(points, dim=-1), min=1e-9)
    yaw = -torch.atan2(points[:, 1], points[:, 0])
    pitch = torch.asin(torch.clamp(points[:, 2] / depth, -1, 1))
    px = torch.clamp(torch.floor(0.5 * (yaw / np.pi + 1.0) * w), 0, w - 1)
    py = torch.clamp(torch.floor((1.0 - (pitch + abs(fov_down_r)) / fov)
                                 * h), 0, h - 1)
    bins = (py * w + px).to(torch.int64)
    rimg = torch.full((h * w,), float("inf"), dtype=depth.dtype,
                      device=depth.device)
    rimg = rimg.scatter_reduce(0, bins, depth, reduce="amin")
    return rimg.reshape(h, w), bins


def unproject_grid(range_img: np.ndarray,
                   fov_up: float = FOV_UP_DEG,
                   fov_down: float = FOV_DOWN_DEG) -> np.ndarray:
    """Back-project a metric range image to sensor-frame xyz at pixel
    centers — the inverse of `project_points`' spherical mapping. The
    reference reads the same geometry back out of LaserScan's proj_xyz
    buffer (drop_samples/drop_rays_val.py:65-73 'prediction mask' dump);
    here the grid is reconstructed analytically so a features-only .npy
    (no retained per-point arrays) can still be visualized.

    range_img: [H, W] metric range (<=0 = empty, left at the origin).
    Returns [H, W, 3].
    """
    h, w = range_img.shape
    fov_up_r = fov_up / 180.0 * np.pi
    fov_down_r = fov_down / 180.0 * np.pi
    fov = abs(fov_down_r) + abs(fov_up_r)
    px = (np.arange(w, dtype=np.float32) + 0.5)[None, :]
    py = (np.arange(h, dtype=np.float32) + 0.5)[:, None]
    yaw = (2.0 * px / w - 1.0) * np.pi  # proj_x = 0.5*(yaw/pi+1)*w
    pitch = (1.0 - py / h) * fov - abs(fov_down_r)
    r = np.maximum(range_img, 0.0)[..., None]
    cp = np.cos(pitch)
    # yaw here is -arctan2(y, x) (the projection's sign convention).
    xyz = np.stack([cp * np.cos(yaw) * np.ones_like(px),
                    -cp * np.sin(yaw) * np.ones_like(px),
                    np.sin(pitch) * np.ones_like(px)], axis=-1)
    return (xyz * r).astype(np.float32)


def denormalize_range(v: np.ndarray) -> np.ndarray:
    """Inverse of `normalize_range`: 2^(v*6.5) - 1
    (drop_rays_val.py:87-92 dist_backtoreal)."""
    return np.where(v > 0, np.exp2(v * RANGE_LOG_NORM) - 1.0,
                    0.0).astype(np.float32)


def normalize_range(r: np.ndarray) -> np.ndarray:
    """log2(r + 1) / 6.5 with empties (-1) left at 0
    (Generate_feature.py:44-48)."""
    out = np.zeros_like(r, np.float32)
    valid = r > 0
    out[valid] = np.log2(r[valid] + 1.0) / RANGE_LOG_NORM
    return out


def local_variance(real: np.ndarray, size: int = 1) -> np.ndarray:
    """Azimuthal local variance feature (lidar_utils.py:348-363)."""
    stacked = np.stack([np.roll(real, i, axis=1)
                        for i in range(-size, size)], axis=-1)
    return np.var(stacked, axis=-1).astype(np.float32)
