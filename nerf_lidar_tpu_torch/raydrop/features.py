# Copy of nerf_lidar_tpu/raydrop/features.py (see tests/test_torch_host.py).
"""Feature generation for ray-drop learning.

Rewrite of NeRF_Lidar_code/src/Generate_feature.py + depth_filter.py:
 - real sweeps -> [H, W] normalized range + return mask (generate_gt_data),
 - simulated sweeps (rendered point trio) -> 6-channel feature images
   [range, semantic_label, rgb x3, azimuthal variance]
   (generate_simulation_data, default --var path),
 - neighbor-consistency depth filter on the 32-ring structure with
   semantic-edge and car-class exemptions (depth_filter.py:4-26).

All host-side numpy (offline prep, matching the reference's placement);
the port's copy takes the numpy branch everywhere.
Points are expected in the *sensor (lidar) frame*; use
lidar/transforms.py + the sweep metadata to get there.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..lidar import range_image as ri

CAR_CLASS = 13
SKY_CLASS = 10


def depth_filter_mask(points: np.ndarray,
                      semantic: Optional[np.ndarray] = None,
                      threshold: int = 1, radius: float = 1.0,
                      width: int = 3, num_beams: int = 32) -> np.ndarray:
    """Keep points whose >threshold azimuthal neighbors (within +-width
    steps) lie within `radius` meters; semantic edges and cars exempt
    (depth_filter.py:4-26). points: [N, 3] beam-major rings. Always
    numpy: the port loads no native library."""
    pts = points.reshape(num_beams, -1, 3)
    neighbors = np.stack([np.roll(pts, i, axis=1)
                          for i in range(-width, width + 1) if i != 0],
                         axis=-1)
    raw = np.broadcast_to(pts[..., None], neighbors.shape)
    dist = np.linalg.norm(raw - neighbors, axis=-2)
    count = (dist < radius).sum(axis=-1)
    if semantic is None:
        mask = count > threshold
    else:
        sem = semantic.reshape(num_beams, -1)
        edge = np.stack([np.roll(sem, i, axis=1) != sem for i in (-1, 1)],
                        axis=-1).sum(-1)
        mask = (count > threshold) | (edge > 0) | (sem == CAR_CLASS)
    return mask.reshape(-1)


def real_sweep_features(points: np.ndarray,
                        h: int = 32, w: int = 1024
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Real .bin point cloud (sensor frame, moving points removed, 3-80 m
    gated by the caller) -> (normalized range [H, W], return mask [H, W])."""
    img = ri.project_points(points, h=h, w=w)
    real = np.where(img.range < 0, 0, img.range) + 1e-4
    real = np.clip(np.log2(real + 1) / ri.RANGE_LOG_NORM, 0, 1)
    return real.astype(np.float32), img.mask.astype(np.float32)


def simulated_sweep_features(points: np.ndarray, semantic: np.ndarray,
                             rgb: np.ndarray, h: int = 32, w: int = 1024,
                             apply_depth_filter: bool = True,
                             semantic_align: bool = True,
                             filter_threshold: int = 1
                             ) -> Dict[str, np.ndarray]:
    """Rendered sweep (sensor frame) -> the 6-channel feature image.

    points: [N, 3]; semantic: [N, K] probabilities or [N] labels; rgb [N, 3].
    Returns dict(features [H, W, 6], mask [H, W], proj (RangeImage)).
    """
    labels = (semantic.argmax(-1) if semantic.ndim == 2
              else semantic).astype(np.float32)
    if apply_depth_filter:
        keep = depth_filter_mask(
            points, labels if semantic_align else None,
            threshold=filter_threshold,
            width=1 if semantic_align else 5)
        points, labels, rgb = points[keep], labels[keep], rgb[keep]
    img = ri.project_points(points, semantic=labels, rgb=rgb, h=h, w=w)
    real = np.where(img.range < 0, 0, img.range) + 1e-4
    real = np.clip(np.log2(real + 1) / ri.RANGE_LOG_NORM, 0, 1)
    var = ri.local_variance(real, size=2)
    feats = np.concatenate([
        real[..., None], img.semantic[..., None].astype(np.float32),
        img.rgb, var[..., None]], axis=-1).astype(np.float32)
    return dict(features=feats, mask=img.mask, proj=img)


def world_points_to_sensor(points: np.ndarray,
                           lidar2global: np.ndarray) -> np.ndarray:
    """World/global frame -> sensor frame: R^T (p - t)
    (reference nerf2world.nerf_to_lidar inverse transform chain)."""
    R = lidar2global[:3, :3]
    t = lidar2global[:3, 3]
    return ((points - t) @ R).astype(np.float32)


def load_sim_sweep_dir(sim_dir: str):
    """Read a rendered sweep dir (the points/semantic/rgb trio written by
    cli render_lidar) + the persisted per-sweep sensor poses.

    Returns (sweeps list of (points_world, semantic, rgb), l2g [S,4,4] or
    None)."""
    import os
    sweeps = []
    i = 0
    while True:
        p = os.path.join(sim_dir, f"points_{i:04d}.npy")
        if not os.path.exists(p):
            break
        pts = np.load(p)
        sem = np.load(os.path.join(sim_dir, f"points_semantic_{i:04d}.npy"))
        rgb_p = os.path.join(sim_dir, f"points_rgb_{i:04d}.npy")
        rgb = (np.load(rgb_p) if os.path.exists(rgb_p)
               else np.zeros((len(pts), 3), np.float32))
        sweeps.append((pts, sem, rgb))
        i += 1
    l2g_p = os.path.join(sim_dir, "lidar2globals.npy")
    l2g = np.load(l2g_p) if os.path.exists(l2g_p) else None
    if l2g is not None and len(sweeps) != len(l2g):
        # A shorter re-render into the same dir leaves stale points_*.npy
        # beyond the rewritten lidar2globals; pairing them with the wrong
        # pose would silently misplace every later sweep.
        raise ValueError(
            f"{sim_dir}: {len(sweeps)} points_*.npy sweeps but "
            f"lidar2globals.npy has {len(l2g)} poses — stale files from an "
            "earlier longer render? Clear the dir and re-render.")
    return sweeps, l2g


def _read_moving_boxes(scene_dir: str, index: int):
    import os
    mask_file = os.path.join(scene_dir, "lidar_mask", f"{index:04d}.txt")
    if not os.path.exists(mask_file):
        return None
    with open(mask_file) as f:
        rows = f.readlines()
    if not rows:
        return None
    return np.array([r.split()[1:] for r in rows]).astype(
        np.float32).reshape(-1, 8, 3)


def assemble_training_set(scene_dir: str, sim_dir: str, h: int = 32,
                          w: int = 1024, **sim_kwargs
                          ) -> Dict[str, np.ndarray]:
    """End-to-end assembly for ONE scene: pair rendered replay sweeps with
    the scene's real .bin sweeps and build the feature/mask/range stacks
    (reference transfer_lidar_data.load_data, :15-66: generate_gt_data on
    the real bins + generate_simulation_data on the rendered trio).

    Real sweeps: moving points removed via the lidar_mask box hulls, 3-100 m
    gated (read_lidar_bin). Sim sweeps: world-frame trio brought into each
    sweep's sensor frame via the persisted lidar2globals."""
    import os
    from ..data import nuscenes as nusc

    sim_sweeps, l2g = load_sim_sweep_dir(sim_dir)
    if not sim_sweeps:
        raise FileNotFoundError(f"no points_*.npy sweeps in {sim_dir}")
    sims, reals = [], []
    for i, (pts, sem, rgb) in enumerate(sim_sweeps):
        bin_path = os.path.join(scene_dir, "lidar_points", f"{i:06d}.bin")
        if not os.path.exists(bin_path):
            break
        depth, dirs, _ = nusc.read_lidar_bin(bin_path,
                                             _read_moving_boxes(scene_dir, i))
        reals.append(dirs * depth[:, None])
        if l2g is not None:
            pts = world_points_to_sensor(pts, l2g[i])
        sims.append((pts, sem, rgb))
    if not reals:
        raise FileNotFoundError(
            f"no paired real sweeps under {scene_dir}/lidar_points — the "
            "training set needs GT return masks (render with --mode replay)")
    return build_training_set(sims, reals, h=h, w=w, **sim_kwargs)


def concat_training_sets(sets) -> Dict[str, np.ndarray]:
    """Stack per-scene training sets (transfer_lidar_data scans scenes)."""
    keys = sets[0].keys()
    return {k: np.concatenate([s[k] for s in sets], axis=0) for k in keys}


def build_training_set(sim_sweeps, real_sweeps, h: int = 32, w: int = 1024,
                       **sim_kwargs) -> Dict[str, np.ndarray]:
    """Assemble the trainer's dataset from per-frame (points, semantic, rgb)
    sim tuples and real point clouds (transfer_lidar_data.py:15-66)."""
    images, masks, ranges = [], [], []
    for (pts, sem, rgb), real_pts in zip(sim_sweeps, real_sweeps):
        sim = simulated_sweep_features(pts, sem, rgb, h=h, w=w, **sim_kwargs)
        gt_range, gt_mask = real_sweep_features(real_pts, h=h, w=w)
        images.append(sim["features"])
        masks.append(gt_mask.astype(np.int32))
        ranges.append(gt_range)
    return dict(images=np.stack(images), masks=np.stack(masks),
                ranges=np.stack(ranges))
