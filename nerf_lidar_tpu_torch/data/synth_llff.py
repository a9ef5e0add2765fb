"""Synthetic LLFF / COLMAP captures: the analytic sphere scene of
`data/synthetic.py` ray-traced from an orbit of cameras and written in the
layouts the llff loader reads, so that the loaders, `train` and the
render entries run on a capture without any dataset from outside.

    python -c "from nerf_lidar_tpu_torch.data import synth_llff; \
        synth_llff.write_capture('exp/capture', num_views=16)"

`write_capture` writes images/*.png (8-bit sRGB-ish colours of the
tracer), a binary COLMAP model under sparse/0 (PINHOLE, one camera; or
the text model with `text_model`; or a Blender `transforms.json`
instead) and poses_bounds.npy. With `raw` it writes a RawNeRF capture
instead of images/: raw/<name>.npy RGGB mosaics (black level 64, white
level 1023) of the linear colours at each view's shutter, and the
exiftool-style <name>.json sidecar that `utils/raw.load_raw_dataset`
reads. Everything is numpy and `data/png.py`: no imageio.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import camera as camlib
from . import colmap, png
from . import quaternion as quat
from .synthetic import SphereScene, orbit_cameras

_FLIP_YZ = np.diag([1.0, -1.0, -1.0, 1.0])  # OpenGL <-> OpenCV camera axes
BLACK_LEVEL, WHITE_LEVEL = 64, 1023


def _bayer_mosaic(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] -> [H, W] RGGB mosaic (the channel each site observes)."""
    h, w = rgb.shape[:2]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    chan = np.where((yy % 2 == 0) & (xx % 2 == 0), 0,
                    np.where((yy % 2 == 1) & (xx % 2 == 1), 2, 1))
    return np.take_along_axis(rgb, chan[..., None], axis=-1)[..., 0]


def write_capture(root: str, num_views: int = 16, height: int = 378,
                  width: int = 504, focal: float = 0.0, seed: int = 0,
                  radius: float = 3.0, raw: bool = False,
                  shutters=(1 / 50, 1 / 100), text_model: bool = False,
                  transforms: bool = False) -> str:
    """Write a 360 capture of `num_views` views at width x height (focal
    0: 0.8 * width) around the sphere scene of `seed` into `root`;
    returns root. `raw`: RawNeRF mosaics, view i shot at shutters[i %
    len(shutters)] seconds; `text_model`: cameras.txt / images.txt
    instead of the binary model; `transforms`: a Blender transforms.json
    instead of a COLMAP model (images named r_<i>.png)."""
    focal = focal or 0.8 * width
    scene = SphereScene.random(seed=seed)
    poses = orbit_cameras(num_views, radius=radius)  # OpenGL c2w [N, 3, 4]
    stem = "r_{:d}" if transforms else "im_{:03d}"
    names = [stem.format(i) + (".npy" if raw else ".png")
             for i in range(num_views)]
    os.makedirs(root, exist_ok=True)
    img_dir = os.path.join(root, "raw" if raw else "images")
    os.makedirs(img_dir, exist_ok=True)
    for i, pose in enumerate(poses):
        rgb = scene.trace(**{
            k: v for k, v in camlib.camera_rays(pose, height, width,
                                                focal).items()
            if k in ("origins", "directions")})["rgb"]
        if raw:
            shutter = shutters[i % len(shutters)]
            level = np.clip(rgb * shutter / max(shutters), 0.0, 1.0)
            mosaic = BLACK_LEVEL + (WHITE_LEVEL - BLACK_LEVEL) * \
                _bayer_mosaic(level)
            base = os.path.join(img_dir, os.path.splitext(names[i])[0])
            np.save(base + ".npy", mosaic.astype(np.float32))
            with open(base + ".json", "w") as f:
                json.dump([{
                    "BlackLevel": BLACK_LEVEL, "WhiteLevel": WHITE_LEVEL,
                    "AsShotNeutral": "1 1 1",
                    "ColorMatrix2": "1 0 0 0 1 0 0 0 1",
                    "ShutterSpeed": f"1/{round(1 / shutter)}"}], f)
        else:
            png.write_png(os.path.join(img_dir, names[i]),
                          (np.clip(rgb, 0, 1) * 255).round().astype(
                              np.uint8))

    if transforms:
        frames = [{"file_path": f"images/{os.path.splitext(n)[0]}",
                   "transform_matrix": camlib.pad_poses(p[None])[0].tolist()}
                  for n, p in zip(names, poses)]
        with open(os.path.join(root, "transforms.json"), "w") as f:
            json.dump({"camera_angle_x": float(
                2 * np.arctan(0.5 * width / focal)), "frames": frames}, f)
    else:
        sparse = os.path.join(root, "sparse", "0")
        os.makedirs(sparse, exist_ok=True)
        cam = colmap.Camera(1, "PINHOLE", width, height, np.array(
            [focal, focal, width / 2, height / 2], np.float64))
        images = {}
        for i, (name, pose) in enumerate(zip(names, poses)):
            w2c = np.linalg.inv(camlib.pad_poses(pose[None])[0] @ _FLIP_YZ)
            images[i + 1] = colmap.Image(
                i + 1, quat.from_rotation_matrix(w2c[:3, :3]), w2c[:3, 3], 1,
                name)
        if text_model:
            _write_text_model(sparse, cam, images)
        else:
            colmap.write_cameras_bin(os.path.join(sparse, "cameras.bin"),
                                     {1: cam})
            colmap.write_images_bin(os.path.join(sparse, "images.bin"),
                                    images)
            colmap.write_points3d_bin(os.path.join(sparse, "points3D.bin"),
                                      scene.centers.astype(np.float64))
    bounds = np.zeros((num_views, 17))
    bounds[:, -2:] = (radius - 2.0, radius + 2.0)
    np.save(os.path.join(root, "poses_bounds.npy"), bounds)
    return root


def _write_text_model(sparse: str, cam, images) -> None:
    """cameras.txt / images.txt (an empty points line per image)."""
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        f.write(f"{cam.camera_id} {cam.model} {cam.width} {cam.height} "
                + " ".join(repr(float(p)) for p in cam.params) + "\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("# Image list\n")
        for im in images.values():
            f.write(f"{im.image_id} "
                    + " ".join(repr(float(v)) for v in (*im.qvec, *im.tvec))
                    + f" {im.camera_id} {im.name}\n\n")
