# Copy of nerf_lidar_tpu/data/synthetic.py (see tests/test_torch_host.py).
"""Analytic synthetic scene: spheres + ground plane with exact ray-traced
RGB / depth / semantics / intensity ground truth.

Serves the role the reference fills with real nuScenes scenes during
development: an oracle dataset for overfit/convergence tests, benchmarking,
and the LiDAR pipeline (the analytic tracer answers LiDAR rays too). Not a
port of anything — the reference has no test data generator at all
(SURVEY.md section 4 gap).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from . import camera as camlib

SKY_CLASS = 10
GROUND_CLASS = 0


@dataclasses.dataclass
class SphereScene:
    centers: np.ndarray  # [M, 3]
    radii: np.ndarray  # [M]
    colors: np.ndarray  # [M, 3]
    classes: np.ndarray  # [M] int
    ground_z: float = -0.5
    ground_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.4, 0.35, 0.3], np.float32))
    sky_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.6, 0.75, 0.95], np.float32))

    @staticmethod
    def random(num_spheres: int = 6, seed: int = 0,
               extent: float = 1.5) -> "SphereScene":
        rng = np.random.RandomState(seed)
        centers = rng.uniform(-extent, extent, (num_spheres, 3)).astype(
            np.float32)
        centers[:, 2] = rng.uniform(-0.2, 0.8, num_spheres)
        radii = rng.uniform(0.15, 0.45, num_spheres).astype(np.float32)
        colors = rng.uniform(0.1, 0.9, (num_spheres, 3)).astype(np.float32)
        classes = rng.randint(1, 5, num_spheres).astype(np.int32)
        return SphereScene(centers, radii, colors, classes)

    def trace(self, origins: np.ndarray, directions: np.ndarray,
              t_max: float = 100.0) -> Dict[str, np.ndarray]:
        """Exact nearest-hit trace. origins/directions: [..., 3] (directions
        need not be unit; depth is measured in units of |directions|, i.e.
        matches the t convention of volume rendering)."""
        shape = origins.shape[:-1]
        o = origins.reshape(-1, 3).astype(np.float64)
        d = directions.reshape(-1, 3).astype(np.float64)
        n = o.shape[0]

        t_hit = np.full(n, np.inf)
        rgb = np.tile(self.sky_color, (n, 1)).astype(np.float64)
        sem = np.full(n, SKY_CLASS, np.int32)
        # Sky keeps the up-vector placeholder; supervision masks sky out
        # (reference train.py:358-363 gates on semantic != 10).
        nrm = np.tile(np.array([0.0, 0.0, 1.0]), (n, 1))

        # Spheres.
        for c, r, col, cls in zip(self.centers, self.radii, self.colors,
                                  self.classes):
            oc = o - c
            a = (d * d).sum(-1)
            b = 2 * (oc * d).sum(-1)
            cc = (oc * oc).sum(-1) - r * r
            disc = b * b - 4 * a * cc
            hit = disc > 0
            sq = np.sqrt(np.maximum(disc, 0))
            t0 = (-b - sq) / (2 * a)
            valid = hit & (t0 > 1e-6) & (t0 < t_hit)
            # Lambertian-ish shading from a fixed sun for texture.
            p = o + t0[:, None] * d
            normal = (p - c) / r
            sun = np.array([0.48, 0.6, 0.64])
            shade = 0.35 + 0.65 * np.clip((normal * sun).sum(-1), 0, 1)
            t_hit = np.where(valid, t0, t_hit)
            rgb = np.where(valid[:, None], col * shade[:, None], rgb)
            sem = np.where(valid, cls, sem)
            nrm = np.where(valid[:, None], normal, nrm)

        # Ground plane z = ground_z.
        dz = d[:, 2]
        t_g = (self.ground_z - o[:, 2]) / np.where(np.abs(dz) < 1e-12,
                                                   1e-12, dz)
        valid = (t_g > 1e-6) & (t_g < t_hit) & (dz < 0)
        p = o + t_g[:, None] * d
        checker = (np.floor(p[:, 0] * 2) + np.floor(p[:, 1] * 2)) % 2
        gcol = self.ground_color * (0.8 + 0.2 * checker[:, None])
        t_hit = np.where(valid, t_g, t_hit)
        rgb = np.where(valid[:, None], gcol, rgb)
        sem = np.where(valid, GROUND_CLASS, sem)
        nrm = np.where(valid[:, None], np.array([0.0, 0.0, 1.0]), nrm)

        hit_mask = np.isfinite(t_hit)
        depth = np.where(hit_mask, t_hit, t_max)
        intensity = np.where(hit_mask, rgb.mean(-1), 0.0)
        return dict(
            rgb=rgb.reshape(shape + (3,)).astype(np.float32),
            depth=depth.reshape(shape).astype(np.float32),
            semantic=sem.reshape(shape).astype(np.int32),
            intensity=intensity.reshape(shape).astype(np.float32),
            normal=nrm.reshape(shape + (3,)).astype(np.float32),
            hit=hit_mask.reshape(shape))


def orbit_cameras(num: int, radius: float = 3.0, height: float = 0.8,
                  target=(0.0, 0.0, 0.0)):
    """num camera-to-world [3,4] poses orbiting the origin."""
    poses = []
    for i in range(num):
        ang = 2 * np.pi * i / num
        eye = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        poses.append(camlib.lookat_pose(eye, np.asarray(target, np.float64)))
    return np.stack(poses)


def make_scene_data(num_views: int = 8, height: int = 32, width: int = 48,
                    focal: float = 40.0, seed: int = 0,
                    near: float = 0.2, far: float = 12.0,
                    num_lidar: int = 2048, with_lidar: bool = True):
    """Build a SceneData (see data/batching.py) from an analytic scene."""
    from . import batching

    scene = SphereScene.random(seed=seed)
    poses = orbit_cameras(num_views)
    views = render_views(scene, poses, height, width, focal)
    pixtocam = camlib.get_pixtocam(focal, width, height)

    lidar = {}
    if with_lidar:
        rng = np.random.RandomState(seed + 1)
        origins = np.tile(np.array([0.0, 0.0, 0.6], np.float32),
                          (num_lidar, 1))
        az = rng.uniform(-np.pi, np.pi, num_lidar)
        el = rng.uniform(np.deg2rad(-30.0), np.deg2rad(10.0), num_lidar)
        dirs = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                         np.sin(el)], -1).astype(np.float32)
        gt = scene.trace(origins, dirs)
        keep = gt["hit"] & (gt["depth"] < far)
        lidar = dict(
            lidar_origins=origins[keep],
            lidar_dirs=dirs[keep],
            lidar_depth=gt["depth"][keep],
            lidar_intensity=gt["intensity"][keep],
            lidar_timestamps=np.zeros(keep.sum(), np.float32))

    data = batching.SceneData(
        camtoworlds=poses, pixtocam=pixtocam, images=views["rgb"],
        near=near, far=far, depths=views["depth"],
        semantics=views["semantic"], normals=views["normal"],
        masks=np.zeros(views["rgb"].shape[:3], np.float32),
        timestamps=np.arange(num_views, dtype=np.float32), **lidar)
    return scene, data, views


def render_views(scene: SphereScene, poses: np.ndarray, height: int,
                 width: int, focal: float) -> Dict[str, np.ndarray]:
    """Ray-trace ground-truth images for each pose: dict of [N, H, W, ...]."""
    outs = {"rgb": [], "depth": [], "semantic": [], "intensity": [],
            "normal": []}
    rays_all = {k: [] for k in
                ("origins", "directions", "viewdirs", "radii", "base_x",
                 "base_y")}
    for pose in poses:
        rays = camlib.camera_rays(pose, height, width, focal)
        gt = scene.trace(rays["origins"], rays["directions"])
        for k in outs:
            outs[k].append(gt[k])
        for k in rays_all:
            rays_all[k].append(rays[k])
    result = {k: np.stack(v) for k, v in outs.items()}
    result.update({k: np.stack(v) for k, v in rays_all.items()})
    return result
