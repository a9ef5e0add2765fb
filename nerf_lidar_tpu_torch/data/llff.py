# Copy of nerf_lidar_tpu/data/llff.py (see tests/test_torch_host.py).
"""LLFF / COLMAP / Blender scene loading (reference internal/datasets.py
LLFF class, :838-1010, and load_blender_posedata :160-186).

Poses come from a COLMAP sparse model (`sparse/0/`, parsed by
data/colmap.py — the TPU repo's replacement for the reference's vendored
pycolmap) or, when absent, from a Blender/NGP `transforms.json`. Two scene
modes, matching the reference:

- 360 (default): poses are PCA-normalized into the contraction-friendly
  unit box (camera.transform_poses_pca) and the render path is the
  inward-facing ellipse.
- forward-facing (`Config.forward_facing`): poses are rescaled by the
  poses_bounds.npy near bound, recentered onto the average pose, rays are
  cast in NDC (SceneData.pixtocam_ndc), and the render path is the LLFF
  spiral.

Everything stays host-side numpy; the output is the same SceneData the
nuScenes loader produces, so training/eval/render run unchanged.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from . import camera as camlib
from . import colmap, png
from .batching import SceneData
from .nuscenes import NuscenesScene
from ..lidar.transforms import SceneFrame


def _imread(path: str) -> np.ndarray:
    # The port's copy: PNG through data/png.py, other formats through
    # imageio (png.imread).
    return png.imread(path)


from ..utils.image import downsample_area as _downsample


def load_blender_poses(data_dir: str):
    """Blender/NGP transforms.json -> (names, poses [N,3,4] OpenGL,
    pixtocam fn(w, h), None, 'perspective'). Reference datasets.py:160-186."""
    with open(os.path.join(data_dir, "transforms.json")) as f:
        meta = json.load(f)
    names, poses = [], []
    for frame in meta["frames"]:
        names.append(os.path.basename(frame["file_path"]))
        poses.append(np.array(frame["transform_matrix"],
                              np.float64)[:3, :4])
    poses = np.stack(poses)

    def pixtocam(w, h):
        if "fl_x" in meta:
            fx, fy = meta["fl_x"], meta.get("fl_y", meta["fl_x"])
            cx, cy = meta.get("cx", w / 2), meta.get("cy", h / 2)
        else:
            fx = fy = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
            cx, cy = w / 2, h / 2
        return np.linalg.inv(camlib.intrinsic_matrix(fx, fy, cx, cy))

    return names, poses, pixtocam, None, "perspective"


def load_scene(root_dir: str, split: str = "train", factor: int = 1,
               llffhold: int = 8, forward_facing: bool = False,
               use_all_for_training: bool = False,
               near: Optional[float] = None,
               far: Optional[float] = None,
               rawnerf_mode: bool = False,
               exposure_percentile: float = 97.0,
               process_index: int = 0,
               process_count: int = 1) -> NuscenesScene:
    """Load an LLFF-style capture directory. Returns the same scene
    structure as nuscenes.load_scene (no LiDAR, no tracks).

    rawnerf_mode swaps the tonemapped images/ for demosaicked linear raw
    mosaics from raw/ (utils/raw.load_raw_dataset) and emits per-view
    exposure values/indices so the model's RawNeRF exposure scaling
    trains from data (reference datasets.py:944-952)."""
    sparse = os.path.join(root_dir, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(root_dir, "sparse")
    if os.path.isdir(sparse):
        (names, poses, pixtocam, distortion, camtype, _points,
         _wh) = colmap.load_nerf_poses(sparse)
        pixtocam_fn = None
    elif os.path.exists(os.path.join(root_dir, "transforms.json")):
        names, poses, pixtocam_fn, distortion, camtype = \
            load_blender_poses(root_dir)
        pixtocam = None
    else:
        raise FileNotFoundError(
            f"{root_dir}: no COLMAP sparse model and no transforms.json")

    # Filename order defines the canonical index (datasets.py:870-874).
    order = np.argsort(names)
    names = [names[i] for i in order]
    poses = poses[order]

    # Bounds: poses_bounds.npy when present, LLFF default otherwise
    # (datasets.py:876-884).
    bounds = np.array([0.01, 1.0])
    pb = os.path.join(root_dir, "poses_bounds.npy")
    if os.path.exists(pb):
        bounds = np.load(pb)[:, -2:]

    render_poses = None
    pixtocam_ndc = None
    if forward_facing:
        scale = 1.0 / (bounds.min() * 0.75)
        poses[:, :3, 3] *= scale
        bounds = bounds * scale
        poses, transform = camlib.recenter_poses(poses)
        frame = SceneFrame(transform, 1.0)
        render_poses = camlib.generate_spiral_path(poses, bounds)
        near_out, far_out = 0.0, 1.0  # rays live in the NDC cube
    else:
        poses, transform, scale = camlib.transform_poses_pca(poses)
        rigid = transform.copy()
        rigid[:3, :] /= scale
        frame = SceneFrame(rigid, scale)
        try:
            render_poses = camlib.generate_ellipse_path(poses)
        except ValueError:
            # Parallel rig loaded without forward_facing=True: the inward
            # ellipse is undefined, the LLFF spiral still is — but the
            # spiral's contract wants recentered poses (average pose ==
            # identity), not the PCA frame. Generate it there, then map
            # the path back into the PCA frame the model was trained in.
            sp_poses, t_re = camlib.recenter_poses(poses)
            spiral = camlib.generate_spiral_path(sp_poses, bounds * scale)
            t_inv = np.linalg.inv(t_re)
            render_poses = camlib.unpad_poses(
                t_inv[None] @ camlib.pad_poses(spiral)).astype(np.float32)
        # Reference 360 operating point (near 0.2 metric, far open):
        # scaled into the PCA-normalized frame.
        near_out, far_out = 0.2 * scale, 1e6 * scale
    if near is not None:
        near_out = near
    if far is not None:
        far_out = far

    num = len(names)
    all_idx = np.arange(num)
    splits = {
        "test": all_idx[all_idx % llffhold == 0],
        "train": (all_idx if use_all_for_training
                  else all_idx[all_idx % llffhold != 0]),
    }
    indices = splits.get(split, splits["train"])
    if split == "train" and process_count > 1:
        # Multi-host: shard TRAIN images round-robin by rank so each host
        # only holds 1/world of the pixels (reference datasets.py:931-935;
        # the nuScenes path replicates instead, matching datasets.py:1336).
        indices = indices[process_index::process_count]
    # Split ids are GLOBAL; "loaded" records which global views this
    # SceneData actually holds (cli maps test ids through it).
    splits = dict(splits, loaded=indices)

    exposure_values = exposure_idx = None
    if rawnerf_mode:
        from ..utils import raw as rawlib
        # Load ALL views, then subset: the exposure anchor (idx 0, the
        # brightest shutter) and the exposure_values denominator must be
        # computed over the whole capture so train and test agree on what
        # "exposure 1.0" means (reference raw_utils.py:235-339 operates on
        # the full capture before splitting).
        images, meta = rawlib.load_raw_dataset(
            root_dir, names,
            exposure_percentile=exposure_percentile,
            n_downsample=max(factor, 1))
        images = images[indices]
        exposure_values = np.asarray(meta["exposure_values"],
                                     np.float32)[indices]
        exposure_idx = np.asarray(meta["exposure_idx"], np.int32)[indices]
    else:
        # Images: images_{factor}/ when it exists (the reference requires
        # it), else images/ downsampled here.
        img_dir = os.path.join(root_dir, f"images_{factor}")
        post = 1
        if factor <= 1 or not os.path.isdir(img_dir):
            img_dir = os.path.join(root_dir, "images")
            post = factor
        # COLMAP names refer to the full-res originals; downsampled dirs
        # keep the same basenames but may re-encode (e.g. .JPG -> .png),
        # so match on the extension-less stem. Missing images are an
        # error, not a silent positional guess.
        files = {os.path.splitext(f)[0]: f
                 for f in sorted(os.listdir(img_dir))}
        images = []
        for i in indices:
            stem = os.path.splitext(names[i])[0]
            if stem not in files:
                raise FileNotFoundError(
                    f"{img_dir}: no image matching COLMAP entry "
                    f"{names[i]!r}")
            f = files[stem]
            img = _imread(os.path.join(img_dir, f)).astype(np.float32) / 255.
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            images.append(_downsample(img[..., :3], post))
        images = np.stack(images)

    if pixtocam is None:  # Blender: intrinsics derive from the image size
        pixtocam = pixtocam_fn(images.shape[2] * factor,
                               images.shape[1] * factor)
    # Scale inverse intrinsics by the downsampling factor
    # (datasets.py:939-941).
    pixtocam = (pixtocam @ np.diag([factor, factor, 1.0])).astype(np.float32)
    if forward_facing:
        pixtocam_ndc = pixtocam

    data = SceneData(
        camtoworlds=poses[indices].astype(np.float32),
        pixtocam=pixtocam,
        images=images,
        near=float(near_out), far=float(far_out),
        distortion_params=distortion, camtype=camtype,
        pixtocam_ndc=pixtocam_ndc,
        exposure_values=exposure_values, exposure_idx=exposure_idx)
    return NuscenesScene(
        data=data, frame=frame, cam2global=np.eye(4), tracks=None,
        track_mask=None, track_classes=[], lidar=None, splits=splits,
        render_poses=render_poses)
