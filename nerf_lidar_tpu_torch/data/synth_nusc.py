# Copy of nerf_lidar_tpu/data/synth_nusc.py (see tests/test_torch_host.py).
"""Write an oracle-rendered scene in the reference's on-disk nuScenes
layout (poses_bounds.npy + images/ depth/ labels/ mask/ lidar_points/ +
bboxes.json + timestamps.txt), so the FULL loader/training pipeline can be
exercised at scale without real data.

The reference ships no data generator (SURVEY.md section 4 gap); its layout
is defined by internal/load_nuscenes.py + internal/datasets.py:1246-1462.
Content comes from the analytic SphereScene oracle (data/synthetic.py): a
driving corridor in metric units, a 6-camera ring on a moving ego, LiDAR
sweeps traced per frame, and one dynamic sphere with a bboxes.json track.
(The port's copy writes its PNG files with `data/png.py`, so that it needs
no imageio: the same pixels, other compressed bytes.)
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from . import camera as camlib
from . import png
from . import synthetic
from ..lidar import sensor as sensorlib

# Camera ring yaw offsets (radians): front, front-left, front-right,
# back-left, back-right, back — nuScenes-like coverage.
RING_YAWS = (0.0, 0.96, -0.96, 2.2, -2.2, np.pi)


def _corridor_scene(seed: int = 0, num_spheres: int = 14,
                    length: float = 60.0) -> synthetic.SphereScene:
    """Metric-scale corridor: spheres 1-3 m radius scattered along +x,
    ground plane at z=0."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(2.0, length, num_spheres)
    y = rng.uniform(-10.0, 10.0, num_spheres)
    r = rng.uniform(0.8, 2.8, num_spheres)
    z = r * rng.uniform(0.4, 1.4, num_spheres)
    centers = np.stack([x, y, z], -1).astype(np.float32)
    colors = rng.uniform(0.1, 0.9, (num_spheres, 3)).astype(np.float32)
    classes = rng.randint(1, 10, num_spheres).astype(np.int32)
    return synthetic.SphereScene(centers, np.asarray(r, np.float32), colors,
                                 classes, ground_z=0.0)


def _cam_pose(ego_xyz: np.ndarray, yaw: float) -> np.ndarray:
    """[3,4] camera-to-world at ego position looking along `yaw`."""
    fwd = np.array([np.cos(yaw), np.sin(yaw), -0.06])
    return camlib.lookat_pose(ego_xyz, ego_xyz + fwd)


def _moving_center(t: float, speed: float = 4.0) -> np.ndarray:
    """Dynamic sphere: drives down the corridor ahead of the ego."""
    return np.array([8.0 + speed * t, 2.0, 1.0], np.float32)


def write_scene_dir(root: str, num_frames: int = 12, sensor_num: int = 6,
                    height: int = 180, width: int = 320,
                    focal: Optional[float] = None, seed: int = 0,
                    ego_speed: float = 3.0, frame_dt: float = 0.5,
                    moving_radius: float = 1.3,
                    lidar_points_per_beam: int = 256,
                    num_sweeps: Optional[int] = None,
                    write_normals: bool = False) -> str:
    """Render and write the scene directory. Returns `root`.

    Image order matches the loader's sensor blocks (data/nuscenes.py:86):
    all front frames first, then each other camera's block.
    """
    focal = focal or 0.9 * width
    static = _corridor_scene(seed)
    rng = np.random.RandomState(seed + 1)
    os.makedirs(root, exist_ok=True)
    dirs_to_make = ["images", "depth", "labels", "mask"]
    if write_normals:
        dirs_to_make.append("normals")
    for d in dirs_to_make:
        os.makedirs(os.path.join(root, d), exist_ok=True)

    ego = np.stack([np.stack([ego_speed * f, 0.0, 1.8])
                    for f in np.arange(num_frames) * frame_dt])
    frame_times = np.arange(num_frames) * frame_dt
    t0_us = 1.6e15

    num_images = num_frames * sensor_num
    poses_rows = []
    times_us = []
    idx = 0
    for s in range(sensor_num):
        yaw = RING_YAWS[s]
        for f in range(num_frames):
            t = frame_times[f]
            c2w = _cam_pose(ego[f], yaw)
            # Scene at time t: static spheres + the dynamic one.
            scene_t = _scene_at(static, t, moving_radius)
            rays = camlib.camera_rays(c2w, height, width, focal)
            gt = scene_t.trace(rays["origins"], rays["directions"])

            png.write_png(
                os.path.join(root, "images", f"{idx:06d}.png"),
                (np.clip(gt["rgb"], 0, 1) * 255).astype(np.uint8))
            depth_png = np.clip(gt["depth"] * 256.0, 0, 65535)
            png.write_png(os.path.join(root, "depth", f"{idx:06d}.png"),
                            depth_png.astype(np.uint16))
            png.write_png(os.path.join(root, "labels", f"{idx:06d}.png"),
                            gt["semantic"].astype(np.uint8))
            if write_normals:
                # Pseudo-normal sidecars in the reference layout
                # (normals/%06d_normal.png, datasets.py:1276): CAMERA-frame
                # unit normals encoded (n+1)/2*255; the loader rotates them
                # back to the scene frame with the camera pose rotation
                # (datasets.py:1486-1497).
                n_cam = gt["normal"] @ c2w[:, :3]  # R^T n_world, per pixel
                enc = np.clip((n_cam + 1.0) * 0.5 * 255.0, 0, 255)
                png.write_png(
                    os.path.join(root, "normals", f"{idx:06d}_normal.png"),
                    enc.astype(np.uint8))
            # Moving-object 2D box (class 13 = car) for the mask file.
            box = _project_box(c2w, focal, height, width,
                               _moving_center(t), moving_radius)
            with open(os.path.join(root, "mask", f"{idx:06d}.txt"),
                      "w") as fh:
                if box is not None:
                    fh.write("13 %d %d %d %d\n" % box)
            # Invert the loader's LLFF->OpenGL conversion
            # (data/nuscenes.py:58-61): store [-u, r, t] columns.
            llff = np.concatenate(
                [-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:4]], axis=1)
            k_col = np.array([[width / 2.0], [height / 2.0], [focal]])
            row = np.concatenate([llff, k_col], axis=1).reshape(-1)
            row = np.concatenate([row, [1.0, 90.0], [height, width]])
            poses_rows.append(row)
            times_us.append(t0_us + t * 1e6 + s * 1e4)
            idx += 1
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.stack(poses_rows).astype(np.float64))
    np.savetxt(os.path.join(root, "timestamps.txt"), np.asarray(times_us))
    np.save(os.path.join(root, "c2w.npy"), np.eye(4))
    np.save(os.path.join(root, "lidar2cam.npy"), np.eye(4))

    # Dynamic-object track (bboxes.json: center+wlh+quat+[time, class]).
    ann = []
    d = 2 * moving_radius
    for f in range(num_frames):
        t = frame_times[f]
        c = _moving_center(t)
        ann.append(list(map(float, c)) + [d, d, d, 1.0, 0.0, 0.0, 0.0,
                                          float(t0_us + t * 1e6),
                                          "vehicle.car"])
    with open(os.path.join(root, "bboxes.json"), "w") as f:
        json.dump({"instance_0": ann, "ego": [[0.0] * 10 + [t0_us, "ego"]]},
                  f)

    # LiDAR sweeps: 32-beam scans traced at each frame's ego position.
    ld = os.path.join(root, "lidar_points")
    os.makedirs(ld, exist_ok=True)
    n_sw = num_sweeps or num_frames
    dirs = sensorlib.beam_directions(
        elevations_deg=sensorlib.NUSC_ELEVATIONS_DEG,
        azimuths=sensorlib.azimuth_angles(lidar_points_per_beam))
    l2g = np.tile(np.eye(4), (n_sw, 1, 1))
    sweep_times = []
    for i in range(n_sw):
        f = min(i, num_frames - 1)
        t = frame_times[f]
        origin = ego[f] + np.array([0.0, 0.0, 0.2])
        l2g[i, :3, 3] = origin
        scene_t = _scene_at(static, t, moving_radius)
        gt = scene_t.trace(np.broadcast_to(origin, dirs.shape), dirs)
        keep = gt["hit"] & (gt["depth"] > 3.0) & (gt["depth"] < 90.0)
        pts_sensor = dirs[keep] * gt["depth"][keep][:, None]
        scan = np.concatenate(
            [pts_sensor, gt["intensity"][keep][:, None] * 100.0,
             np.zeros((keep.sum(), 1))], axis=1).astype(np.float32)
        scan.tofile(os.path.join(ld, f"{i:06d}.bin"))
        center_mat = np.eye(4)
        center_mat[:3, 3] = origin
        np.save(os.path.join(ld, f"points{i:03d}.npy"), center_mat)
        sweep_times.append(t0_us + t * 1e6)
    np.save(os.path.join(ld, "lidar2global.npy"), l2g)
    np.savetxt(os.path.join(ld, "timestamps.txt"), np.asarray(sweep_times))
    return root


def _scene_at(static: synthetic.SphereScene, t: float,
              moving_radius: float) -> synthetic.SphereScene:
    """Static corridor + the dynamic sphere at time t (class 13 = car)."""
    c = _moving_center(t)
    return synthetic.SphereScene(
        centers=np.concatenate([static.centers, c[None]], 0),
        radii=np.concatenate([static.radii, [moving_radius]]),
        colors=np.concatenate([static.colors,
                               [[0.85, 0.15, 0.1]]], 0).astype(np.float32),
        classes=np.concatenate([static.classes, [13]]).astype(np.int32),
        ground_z=static.ground_z)


def _project_box(c2w: np.ndarray, focal: float, h: int, w: int,
                 center: np.ndarray, radius: float):
    """Project a sphere's bounding box into the image; None if behind or
    outside. Returns (y0, x0, y1, x1) ints."""
    R, t = c2w[:, :3], c2w[:, 3]
    p_cam = R.T @ (center - t)  # OpenGL cam: x right, y up, z backward
    z = -p_cam[2]
    if z <= radius:
        return None
    u = w / 2.0 + focal * p_cam[0] / z
    v = h / 2.0 - focal * p_cam[1] / z
    rpix = focal * radius / z
    x0, x1 = int(np.floor(u - rpix)), int(np.ceil(u + rpix))
    y0, y1 = int(np.floor(v - rpix)), int(np.ceil(v + rpix))
    if x1 < 0 or y1 < 0 or x0 >= w or y0 >= h:
        return None
    return (max(y0, 0), max(x0, 0), min(y1, h), min(x1, w))
