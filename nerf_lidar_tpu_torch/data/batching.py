# Copy of nerf_lidar_tpu/data/batching.py (see tests/test_torch_host.py).
"""Mixed patch / pixel / LiDAR ray batching (host-side numpy).

Mirrors the reference's training batch composition (datasets.py:352-403,
707-749): per step,
  - batch_size // 4 rays come from patch_size^2 patches (first in the batch,
    row-major per patch) for the smoothness losses,
  - the rest are independent random pixels,
  - if lidar_supervision, an extra batch_size // lidar_batch_ratio rays are
    real LiDAR returns (depth/intensity supervision only).

All mask fields follow the semantics set up in train.py:286-324 and are
emitted as static-shape arrays (TPU-native replacement of the reference's
boolean indexing). Everything stays in numpy on the host; batches are fed to
the jitted step via device_put with a batch-axis sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from . import camera as camlib


@dataclasses.dataclass
class SceneData:
    """In-memory scene: cameras + per-view supervision + LiDAR returns."""
    camtoworlds: np.ndarray  # [N, 3, 4]
    pixtocam: np.ndarray  # [3, 3] shared, or [N, 3, 3] per view
    images: np.ndarray  # [N, H, W, 3] float in [0, 1]
    near: float
    far: float
    depths: Optional[np.ndarray] = None  # [N, H, W] metric (scene units)
    semantics: Optional[np.ndarray] = None  # [N, H, W] int (255 = unlabeled)
    masks: Optional[np.ndarray] = None  # [N, H, W] 1 = exclude from losses
    timestamps: Optional[np.ndarray] = None  # [N]
    # Pseudo-normal supervision maps (reference datasets.py:1486-1497):
    # world/scene-frame unit normals per pixel, already rotated out of the
    # camera frame by the loader.
    normals: Optional[np.ndarray] = None  # [N, H, W, 3]
    # Camera model extensions (LLFF/COLMAP scenes, data/llff.py): lens
    # distortion inverted at ray-cast time, 'fisheye' equidistant
    # projection, and the forward-facing NDC projection matrix.
    distortion_params: Optional[Dict[str, float]] = None
    camtype: str = "perspective"
    pixtocam_ndc: Optional[np.ndarray] = None  # [3, 3]
    # RawNeRF exposures (utils/raw.load_raw_dataset): per-view relative
    # shutter value + unique-shutter index, emitted per ray so the model's
    # exposure scaling (models/model.py:218-228) trains from data.
    exposure_values: Optional[np.ndarray] = None  # [N]
    exposure_idx: Optional[np.ndarray] = None  # [N] int
    # LiDAR supervision rays (already in scene coordinates).
    lidar_origins: Optional[np.ndarray] = None  # [L, 3]
    lidar_dirs: Optional[np.ndarray] = None  # [L, 3] unit
    lidar_depth: Optional[np.ndarray] = None  # [L]
    lidar_intensity: Optional[np.ndarray] = None  # [L]
    lidar_timestamps: Optional[np.ndarray] = None  # [L]

    @property
    def num_views(self) -> int:
        return self.camtoworlds.shape[0]

    @property
    def height(self) -> int:
        return self.images.shape[1]

    @property
    def width(self) -> int:
        return self.images.shape[2]


LIDAR_RADIUS = 5e-4  # reference internal/lidar_utils.py:8-33


def cast_lidar_rays(origins: np.ndarray, dirs: np.ndarray, near: float,
                    far: float) -> Dict[str, np.ndarray]:
    """LiDAR ray fields: radii 5e-4, base_x = base_y = dir (the multisample
    spiral degenerates onto the beam axis), reference lidar_utils.py:8-33."""
    n = origins.shape[0]
    viewdirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dict(
        origins=origins.astype(np.float32),
        directions=viewdirs.astype(np.float32),
        viewdirs=viewdirs.astype(np.float32),
        radii=np.full((n, 1), LIDAR_RADIUS, np.float32),
        base_x=viewdirs.astype(np.float32),
        base_y=viewdirs.astype(np.float32),
        near=np.full((n, 1), near, np.float32),
        far=np.full((n, 1), far, np.float32))


class RayBatcher:
    """Samples fixed-size training batches from a SceneData."""

    def __init__(self, scene: SceneData, batch_size: int, patch_size: int = 1,
                 lidar_supervision: bool = False, lidar_batch_ratio: int = 4,
                 aug_road: bool = False, aug_delta: float = 0.1,
                 seed: int = 0, mask_moving: bool = True,
                 only_lidar_depth: bool = False,
                 apply_bayer_mask: bool = False):
        self.scene = scene
        # Static-only training excludes moving-object pixels from the
        # losses; when dynamic objects are modeled (instance_obj) the
        # reference CLEARS the moving mask (train.py:288-291) so the obj
        # MLPs receive photometric/depth/semantic supervision. Callers
        # pass mask_moving = not instance_obj.
        self.mask_moving = mask_moving
        # Reference train.py:321-322 (`only_lidar_supervison`): depth loss
        # only on LiDAR-return rows.
        self.only_lidar_depth = only_lidar_depth
        # RawNeRF mosaics: supervise only the channel each RGGB pixel
        # actually observed (reference datasets.py:735-741).
        self.apply_bayer_mask = apply_bayer_mask
        self.batch_size = batch_size
        self.patch_size = max(patch_size, 1)
        self.lidar_supervision = (lidar_supervision
                                  and scene.lidar_origins is not None)
        self.lidar_batch = (batch_size // lidar_batch_ratio
                            if self.lidar_supervision else 0)
        self.rng = np.random.RandomState(seed)
        if self.patch_size > 1:
            patch_ray_budget = batch_size // 4
            self.num_patches = patch_ray_budget // self.patch_size**2
        else:
            self.num_patches = 0
        self.num_patch_rays = self.num_patches * self.patch_size**2
        self.num_pixel_rays = batch_size - self.num_patch_rays
        # Road augmentation (reference datasets.py:367-370): pixel_rays // 4
        # extra rays re-viewing road hit points from perturbed origins.
        self.aug_road = aug_road
        self.aug_delta = aug_delta
        self.aug_rays = self.num_pixel_rays // 4 if aug_road else 0
        self.total_rays = batch_size + self.aug_rays + self.lidar_batch

    def _sample_pixels(self, num: int, patch_size: int):
        """Random (x, y, cam) pixel coords, patch-structured when
        patch_size > 1. Returns flat [num] arrays."""
        s = self.scene
        num_patches = num // patch_size**2
        x0 = self.rng.randint(0, s.width - patch_size + 1,
                              (num_patches, 1, 1))
        y0 = self.rng.randint(0, s.height - patch_size + 1,
                              (num_patches, 1, 1))
        dy, dx = np.meshgrid(np.arange(patch_size), np.arange(patch_size),
                             indexing="ij")
        x = (x0 + dx[None]).reshape(-1)
        y = (y0 + dy[None]).reshape(-1)
        cam = self.rng.randint(0, s.num_views, (num_patches, 1, 1))
        cam = np.broadcast_to(cam, (num_patches, patch_size,
                                    patch_size)).reshape(-1)
        return x, y, cam

    def _camera_ray_batch(self, x, y, cam) -> Dict[str, np.ndarray]:
        s = self.scene
        pixtocam = s.pixtocam if s.pixtocam.ndim == 2 else s.pixtocam[cam]
        rays = camlib.pixels_to_rays(x, y, pixtocam,
                                     s.camtoworlds[cam],
                                     distortion_params=s.distortion_params,
                                     camtype=s.camtype,
                                     pixtocam_ndc=s.pixtocam_ndc)
        n = x.shape[0]
        batch = dict(rays)
        batch["near"] = np.full((n, 1), s.near, np.float32)
        batch["far"] = np.full((n, 1), s.far, np.float32)
        batch["rgb"] = s.images[cam, y, x].astype(np.float32)
        batch["depth"] = (s.depths[cam, y, x].astype(np.float32)
                          if s.depths is not None
                          else np.zeros(n, np.float32))
        batch["semantic"] = (s.semantics[cam, y, x].astype(np.int32)
                             if s.semantics is not None
                             else np.full(n, 255, np.int32))
        batch["intensity"] = np.zeros(n, np.float32)
        excl = (s.masks[cam, y, x].astype(bool)
                if s.masks is not None and self.mask_moving
                else np.zeros(n, bool))
        batch["exclude"] = excl
        batch["cam_idx"] = cam.astype(np.int32)[:, None]
        batch["timestamp"] = (s.timestamps[cam].astype(np.float32)
                              if s.timestamps is not None
                              else np.zeros(n, np.float32))
        batch["lidar_mask"] = np.zeros(n, bool)
        if self.apply_bayer_mask:
            from ..utils import raw as rawlib
            batch["lossmult"] = rawlib.pixels_to_bayer_mask(x, y)
        if s.normals is not None:
            batch["normals"] = s.normals[cam, y, x].astype(np.float32)
        if s.exposure_values is not None:
            ev = s.exposure_values[cam].astype(np.float32)
            batch["exposure_values"] = np.repeat(ev[:, None], 3, axis=1)
            ei = (s.exposure_idx[cam] if s.exposure_idx is not None
                  else np.zeros(n))
            batch["exposure_idx"] = ei.astype(np.int32)[:, None]
        return batch

    def _lidar_ray_batch(self, num: int) -> Dict[str, np.ndarray]:
        s = self.scene
        idx = self.rng.randint(0, s.lidar_origins.shape[0], num)
        batch = cast_lidar_rays(s.lidar_origins[idx], s.lidar_dirs[idx],
                                s.near, s.far)
        batch["rgb"] = np.zeros((num, 3), np.float32)
        batch["depth"] = s.lidar_depth[idx].astype(np.float32)
        batch["semantic"] = np.full(num, 255, np.int32)
        batch["intensity"] = (s.lidar_intensity[idx].astype(np.float32)
                              if s.lidar_intensity is not None
                              else np.zeros(num, np.float32))
        batch["exclude"] = np.zeros(num, bool)
        # LiDAR rays get their own posenet slot AFTER the camera rows
        # (reference train.py:210 routes lidar rays via a per-lidar glo_idx;
        # LearnPose(num_cams, num_lidars=1) reserves row num_cams for it).
        batch["cam_idx"] = np.full((num, 1), s.num_views, np.int32)
        batch["timestamp"] = (s.lidar_timestamps[idx].astype(np.float32)
                              if s.lidar_timestamps is not None
                              else np.zeros(num, np.float32))
        batch["lidar_mask"] = np.ones(num, bool)
        if self.apply_bayer_mask:
            # LiDAR rows carry no color supervision; neutral weight.
            batch["lossmult"] = np.ones((num, 3), np.float32)
        if s.normals is not None:
            # LiDAR returns carry the flat-ground pseudo-normal [0, 0, 1]
            # (reference datasets.py:625-626); they are rgb_mask-excluded
            # so the normal loss never actually fires on them.
            batch["normals"] = np.tile(
                np.array([0.0, 0.0, 1.0], np.float32), (num, 1))
        if s.exposure_values is not None:
            # LiDAR rays carry the anchor exposure (no color supervision).
            batch["exposure_values"] = np.ones((num, 3), np.float32)
            batch["exposure_idx"] = np.zeros((num, 1), np.int32)
        return batch

    def _augment(self, pix_batch: Dict[str, np.ndarray]
                 ) -> Dict[str, np.ndarray]:
        """Static-shape road augmentation (reference datasets.py:536-564):
        select aug_rays rays preferring road pixels (semantic == 0 with
        valid depth), perturb their origins, and re-aim at the original hit
        point. Non-road fillers are marked aug_excl and drop out of every
        supervision mask — the reference's aug_mask==1 convention."""
        from . import road_augment

        road = (pix_batch["semantic"] == 0) & (pix_batch["depth"] > 0)
        # Road indices first (stable), fill with non-road to a fixed size.
        order = np.argsort(~road, kind="stable")
        sel = order[: self.aug_rays]
        aug = {k: np.array(v[sel]) for k, v in pix_batch.items()}
        aug_excl = ~road[sel]
        aug = road_augment.batch_perturb(aug, delta=self.aug_delta,
                                         rng=self.rng)
        aug["exclude"] = aug["exclude"] | aug_excl
        del aug["aug_mask"]  # folded into exclude
        return aug

    def next(self) -> Dict[str, np.ndarray]:
        parts = []
        if self.num_patches > 0:
            x, y, cam = self._sample_pixels(self.num_patch_rays,
                                            self.patch_size)
            parts.append(self._camera_ray_batch(x, y, cam))
        x, y, cam = self._sample_pixels(self.num_pixel_rays, 1)
        parts.append(self._camera_ray_batch(x, y, cam))
        if self.aug_rays > 0:
            parts.append(self._augment(parts[-1]))
        if self.lidar_batch > 0:
            parts.append(self._lidar_ray_batch(self.lidar_batch))

        batch = {k: np.concatenate([p[k] for p in parts], axis=0)
                 for k in parts[0].keys()}

        # Loss masks (train.py:286-324 semantics).
        n = batch["rgb"].shape[0]
        exclude = batch["exclude"]
        lidar = batch["lidar_mask"]
        patch_mask = np.zeros(n, bool)
        patch_mask[: self.num_patch_rays] = True
        rgb_mask = (~exclude) & (~patch_mask) & (~lidar)
        depth_mask = ((batch["depth"] > 0) & rgb_mask) | lidar
        if self.only_lidar_depth:
            depth_mask = lidar.astype(bool)
        sem_mask = (batch["semantic"] != 255) & rgb_mask & (~lidar)
        batch["rgb_mask"] = rgb_mask
        batch["depth_mask"] = depth_mask
        batch["sem_mask"] = sem_mask
        batch["patch_mask"] = patch_mask
        batch["loss_mask"] = ~exclude
        del batch["exclude"]
        return batch
