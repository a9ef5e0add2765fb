# Copy of nerf_lidar_tpu/data/nuscenes.py (see tests/test_torch_host.py).
"""nuScenes scene-directory loader. (The port's copy reads PNG files with
`data/png.py`, so that it needs no imageio.)

Rewrite of reference internal/datasets.py:1183-1538 (NUSCENES._load_renderings)
+ load_nuscenes.py + the LiDAR loading chain in internal/lidar_utils.py:193-267.
Consumes the reference's on-disk scene layout:

  images/            sorted frames (6 cameras interleaved or front-only)
  depth/             16-bit PNG depth (value / 256 = meters)
  labels/            semantic PNGs (cityscapes-style ids; 255 = unlabeled)
  mask/              per-frame txt of 2D moving-object boxes
  normals/           optional pseudo-normal PNGs
  poses_bounds.npy   [N, 19] LLFF-style pose+K(+bounds, hw)
  timestamps.txt     per-image acquisition times (microseconds)
  c2w.npy            front-camera-to-global reference transform
  lidar2cam.npy      LiDAR-to-front-camera extrinsics
  bboxes.json        per-instance [center(3), wlh(3), quat(4), time, class]
  lidar_points/      %06d.bin (N x 5), points%03d.npy, lidar2global.npy,
                     per-sweep timestamps

Outputs the framework-native structures: a batching.SceneData, a
lidar.transforms.SceneFrame, padded track tensors for the object model, and
the sensor trajectories for sweep replay.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..lidar.transforms import SceneFrame, apply_rigid, apply_rotation, \
    inv_rigid
from . import camera as camlib
from . import png
from . import quaternion as quat
from .batching import SceneData

TIME_UNIT_US = 1e6  # 1e6 us = 1 s (load_nuscenes.py:337)


def load_poses_bounds(root_dir: str, factor: int = 1):
    """Parse poses_bounds.npy -> (poses [N,3,4] OpenGL c2w, K [N,3,3],
    hw [2,N], bounds [N,2]). Mirrors load_waymo_meta
    (load_nuscenes.py:97-122)."""
    arr = np.load(os.path.join(root_dir, "poses_bounds.npy")).astype(
        np.float32)
    poses = arr[:, :-4].reshape([-1, 3, 5])
    bounds = arr[:, -4:-2]
    raw_hw = arr[:, -2:].transpose([1, 0]).astype(int)
    cam_k = poses[:, :, 4].transpose([1, 0])
    cx, cy, focal = cam_k[0] / factor, cam_k[1] / factor, cam_k[2] / factor
    K = np.stack([
        np.array([[focal[i], 0, cx[i]], [0, focal[i], cy[i]], [0, 0, 1]])
        for i in range(len(focal))], 0).astype(np.float32)
    # LLFF [-u, r, -t] -> OpenGL [r, u, -t] (load_nuscenes.py:120-121).
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:4]], 2)
    return poses, K, raw_hw, bounds


def load_timestamps(root_dir: str):
    """timestamps.txt -> normalized seconds + (t_min, unit)
    (load_nuscenes.py:333-340)."""
    times = np.loadtxt(os.path.join(root_dir, "timestamps.txt"))
    t_min = times.min()
    return (times - t_min) / TIME_UNIT_US, (t_min, TIME_UNIT_US)


def _imread(path: str) -> np.ndarray:
    """PNG files through the port's own decoder (no imageio needed), other
    formats through imageio (`png.imread`)."""
    return png.imread(path)


def load_moving_masks(root_dir: str, indices, segmentation: np.ndarray,
                      height: int, width: int, sensor_num: int = 6,
                      num_images: int = 0, dilate_semantic: bool = True):
    """Per-frame 2D moving-object masks from mask/*.txt + segmentation
    (datasets.py:1281-1322). Returns (mask [N,H,W] 1=keep, segmentation with
    unlabeled moving pixels set to 255)."""
    mask_dir = os.path.join(root_dir, "mask")
    files = sorted(os.listdir(mask_dir)) if os.path.isdir(mask_dir) else []
    files = [files[i] for i in indices] if files else []
    front_num = num_images // 6 if sensor_num == 6 else 0
    out = []
    seg = segmentation.copy() if segmentation is not None else None
    for count, fname in enumerate(files):
        m = np.ones((height, width), np.float32)
        with open(os.path.join(mask_dir, fname)) as f:
            rows = f.readlines()
        if rows:
            boxes = np.array([r.split()[-4:] for r in rows]).astype(np.int16)
            for b in boxes:
                y0, x0, y1, x1 = b
                if seg is not None:
                    crop = seg[count][y0:y1, x0:x1]
                    dynamic = crop >= 11  # person/vehicle classes
                    m[y0:y1, x0:x1] = dynamic == 0
                    if dilate_semantic:
                        crop2 = crop.copy()
                        crop2[~dynamic] = 255
                        seg[count][y0:y1, x0:x1] = crop2
                else:
                    m[y0:y1, x0:x1] = 0
        if indices[count] < front_num:
            # Ego-vehicle hood on front cameras. The reference masks rows
            # >= 800 at the native 900-row resolution (datasets.py:1311-1320);
            # scale the cut with the loaded image height so downsampled
            # loads (factor > 1) still exclude the hood instead of silently
            # no-opping.
            m[int(round(800.0 * height / 900.0)):, :] = 0
        out.append(m)
    if not out:
        return None, seg
    return np.stack(out, 0), seg


def load_tracks(root_dir: str, frame: SceneFrame, cam2global: np.ndarray,
                timestamps: np.ndarray, time_scale,
                shading_scale: float = 1.2):
    """bboxes.json -> padded track tensors (datasets.py:1394-1462 +
    obj_utils.pose_interpolation).

    Returns (tracks [N_obj, T, 9], track_mask [N_obj], class_names list):
    rows = [cx, cy, cz, theta_z, w, l, h, time, track_id] in scene coords,
    wlh = 0 outside an object's observed time range.
    """
    path = os.path.join(root_dir, "bboxes.json")
    if not os.path.exists(path):
        return None, None, []
    with open(path) as f:
        bboxes = json.load(f)

    t_min, unit = time_scale
    cam_inv = inv_rigid(cam2global)
    # Orientation change of basis: recenter_R @ cam_inv_R, orthonormalized
    # via QR like the reference (datasets.py:1430-1433).
    m = frame.recenter[:3, :3] @ cam_inv[:3, :3]
    q_m, r_m = np.linalg.qr(m)
    orth = q_m @ r_m.round()
    q_orth = quat.from_rotation_matrix(orth)

    times_sorted = np.sort(timestamps)
    tracks, names = [], []
    track_id = 0
    for instance, annotations in bboxes.items():
        if instance == "ego":
            continue
        class_type = annotations[0][11]
        if "human" in class_type:
            continue
        rows = []
        for ann in annotations:
            center = frame.world_to_scene_points(
                apply_rigid(cam_inv, np.array(ann[:3], np.float64)))
            wlh = np.array(ann[3:6], np.float64) * frame.scale * shading_scale
            wlh[0], wlh[1] = wlh[1], wlh[0]  # align l,w,h with x,y,z
            orient = quat.multiply(q_orth, np.array(ann[6:10], np.float64))
            t = (np.array([ann[10]]) - t_min) / unit
            rows.append(np.concatenate(
                [center, orient, wlh, t, [track_id]]))  # [12]
        rows = np.stack(rows)
        rows = rows[np.argsort(rows[:, -2])]
        tracks.append(interpolate_track(times_sorted, rows))
        names.append(class_type)
        track_id += 1
    if not tracks:
        return None, None, []
    tracks = np.stack(tracks).astype(np.float32)  # [N_obj, T, 9]
    return tracks, np.ones(len(tracks), bool), names


def interpolate_track(timestamps: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Interpolate one instance's annotations onto the camera timestamps
    (obj_utils.pose_interpolation:369-410). rows: [K, 12] sorted by time.
    Returns [T, 9] = [center(3), theta_z, wlh(3), time, track_id]; wlh = 0
    outside the observed range."""
    rec_time = rows[:, -2]
    centers = rows[:, :3]
    orients = rows[:, 3:7]
    wlh = rows[0, 7:10]
    track_id = rows[0, -1]
    out = []
    for t in timestamps:
        if t < rec_time.min() or t > rec_time.max():
            edge = rows[0] if t < rec_time.min() else rows[-1]
            yaw = quat.yaw_pitch_roll(edge[3:7])[0]
            pose = np.concatenate([edge[:3], [yaw], edge[7:]])
            pose[4:7] = 0.0  # invalid bbox: zero size
            pose[-2] = t
        else:
            i1 = np.searchsorted(rec_time, t, side="right") - 1
            i1 = min(max(i1, 0), len(rec_time) - 2)
            i2 = i1 + 1
            t0, t1 = rec_time[i1], rec_time[i2]
            amt = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
            center = centers[i1] + amt * (centers[i2] - centers[i1])
            q = quat.slerp(orients[i1], orients[i2], amt)
            yaw = quat.yaw_pitch_roll(q)[0]
            pose = np.concatenate([center, [yaw], wlh, [t], [track_id]])
        out.append(pose)
    return np.stack(out)


def in_hull(points: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """Delaunay containment test (lidar_utils.py:330-345)."""
    from scipy.spatial import Delaunay
    try:
        hull = Delaunay(corners)
    except Exception:
        return np.zeros(points.shape[0], bool)
    return hull.find_simplex(points) >= 0


def read_lidar_bin(path: str, bboxes: Optional[np.ndarray] = None,
                   d_min: float = 3.0, d_max: float = 100.0,
                   return_keep: bool = False):
    """.bin (N x 5: xyz, intensity, ring) -> (depth, unit dirs, intensity)
    in the sensor frame, moving points + range-gated removed
    (lidar_utils.py:346-394). return_keep=True additionally returns the
    boolean keep mask over the raw scan rows (for aligning per-point
    sidecar data such as .label files). Always numpy: the JAX package's
    native decoder gives the same arrays."""
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
    points = scan[:, :3]
    intensity = scan[:, 3]
    keep = np.ones(points.shape[0], bool)
    if bboxes is not None:
        flag = np.zeros(points.shape[0])
        for box in bboxes:
            flag += in_hull(points, box)
        keep &= flag == 0
    depth = np.linalg.norm(points, axis=1)
    keep &= (depth > d_min) & (depth < d_max)
    points, depth, intensity = points[keep], depth[keep], intensity[keep]
    dirs = points / depth[:, None]
    if return_keep:
        return depth, dirs, intensity, keep
    return depth, dirs, intensity


def load_lidar_rays(root_dir: str, frame: SceneFrame,
                    cam2global: np.ndarray, moving_mask: bool = True):
    """All real sweeps -> scene-frame supervision rays
    (lidar_utils.py:193-267). Returns dict of arrays + per-sweep frame ids.
    """
    lidar_dir = os.path.join(root_dir, "lidar_points")
    bins = sorted(glob.glob(os.path.join(lidar_dir, "*.bin")))
    if not bins:
        return None
    l2g = np.load(os.path.join(lidar_dir, "lidar2global.npy"))
    cam_inv = inv_rigid(cam2global)

    origins, dirs, depths, intens, frame_ids = [], [], [], [], []
    labels = []
    for i in range(len(bins)):
        boxes = None
        if moving_mask:
            mask_file = os.path.join(root_dir, "lidar_mask", f"{i:04d}.txt")
            if os.path.exists(mask_file):
                with open(mask_file) as f:
                    rows = f.readlines()
                boxes = np.array([r.split()[1:] for r in rows]).astype(
                    np.float32).reshape(-1, 8, 3)
        label_file = os.path.join(lidar_dir, f"{i:06d}.label")
        if os.path.exists(label_file):
            # SemanticKITTI sidecar labels: align with the same keep mask
            # the bin decode applies (hull removal + range gate).
            depth, d_lidar, intensity, keep = read_lidar_bin(
                os.path.join(lidar_dir, f"{i:06d}.bin"), boxes,
                return_keep=True)
            raw = np.fromfile(label_file, dtype=np.uint32) & 0xFFFF
            labels.append(raw[keep].astype(np.int32))
        else:
            depth, d_lidar, intensity = read_lidar_bin(
                os.path.join(lidar_dir, f"{i:06d}.bin"), boxes)
        center_g = np.load(
            os.path.join(lidar_dir, f"points{i:03d}.npy"))[:, -1][:3]
        origin = frame.world_to_scene_points(apply_rigid(cam_inv, center_g))
        d_world = apply_rotation(cam_inv, d_lidar @ l2g[i][:3, :3].T)
        d_scene = frame.world_to_scene_dirs(d_world)
        n = depth.shape[0]
        origins.append(np.tile(origin, (n, 1)))
        dirs.append(d_scene)
        depths.append(depth * frame.scale)
        intens.append(intensity)
        frame_ids.append(np.full(n, i, np.int32))
    intens = np.concatenate(intens)
    intens = intens / max(intens.max(), 1e-9)
    out = dict(
        origins=np.concatenate(origins).astype(np.float32),
        dirs=np.concatenate(dirs).astype(np.float32),
        depth=np.concatenate(depths).astype(np.float32),
        intensity=intens.astype(np.float32),
        frame_ids=np.concatenate(frame_ids),
        lidar2globals=l2g,
        num_sweeps=len(bins))
    if len(labels) == len(bins):
        out["labels"] = np.concatenate(labels)
    return out


@dataclasses.dataclass
class NuscenesScene:
    data: SceneData
    frame: SceneFrame
    cam2global: np.ndarray
    tracks: Optional[np.ndarray]
    track_mask: Optional[np.ndarray]
    track_classes: List[str]
    lidar: Optional[Dict]
    splits: Dict[str, np.ndarray]
    render_poses: Optional[np.ndarray] = None


def load_scene(root_dir: str, split: str = "train", factor: int = 1,
               llffhold: int = 10, use_all_for_training: bool = True,
               sensor_num: int = 6, load_lidar: bool = True,
               load_objects: bool = True,
               semantic_dilate: bool = True,
               load_normals: bool = False) -> NuscenesScene:
    """Load a full scene directory into framework structures.

    Splits (datasets.py:1254-1263): LIDAR = first 2 frames, TEST = every
    llffhold-th, TRAIN = all (when use_all_for_training) else the rest.
    """
    poses, K, raw_hw, bounds = load_poses_bounds(root_dir, factor)
    num = len(poses)
    poses_rc, transform, scale = camlib.transform_poses_pca(poses)
    # transform_poses_pca folds the scale into the matrix (matching the
    # reference's persisted c2w_recenter_transform.npy); SceneFrame wants the
    # pure rigid part + scalar scale.
    rigid = transform.copy()
    rigid[:3, :] /= scale
    frame = SceneFrame(rigid, scale)
    near, far = 2 * scale, 500 * scale

    all_idx = np.arange(num)
    splits = {
        "lidar": all_idx[:2],
        "test": all_idx[all_idx % llffhold == 0],
        "train": (all_idx if use_all_for_training
                  else all_idx[all_idx % llffhold != 0]),
    }
    indices = splits[split if split in splits else "train"]
    # Global ids of the views actually loaded into SceneData: split ids
    # are GLOBAL, so consumers (cli train's test-view monitor) must map
    # through "loaded" before indexing data.images.
    splits = dict(splits, loaded=indices)

    img_dir = os.path.join(root_dir, "images")
    img_files = sorted(os.listdir(img_dir))
    images = np.stack([_imread(os.path.join(img_dir, img_files[i]))
                       for i in indices], 0).astype(np.float32) / 255.0
    h, w = images.shape[1:3]

    def _aligned(name, loader, default):
        d = os.path.join(root_dir, name)
        if not os.path.isdir(d) or not os.listdir(d):
            return default
        files = sorted(os.listdir(d))
        return np.stack([loader(os.path.join(d, files[i]))
                         for i in indices], 0)

    depths = _aligned(
        "depth", lambda p: _imread(p).astype(np.float32) / 256.0 * scale,
        np.zeros(images.shape[:3], np.float32))
    semantics = _aligned("labels",
                         lambda p: _imread(p).astype(np.int32),
                         np.full(images.shape[:3], 255, np.int32))

    normals = None
    if load_normals:
        # Pseudo-normal sidecars (reference datasets.py:1486-1497):
        # normals/%06d_normal.png hold CAMERA-frame normals encoded
        # (n+1)/2*255; decode and rotate to the scene frame with the
        # (PCA-recentered) camera rotation — rotations commute with the
        # rigid recentering, so supervising in the scene frame matches the
        # reference's world-frame supervision.
        ndir = os.path.join(root_dir, "normals")
        if os.path.isdir(ndir) and os.listdir(ndir):
            nfiles = sorted(os.listdir(ndir))
            local = np.stack(
                [_imread(os.path.join(ndir, nfiles[i])) for i in indices],
                0).astype(np.float32)[..., :3] / 255.0 * 2.0 - 1.0
            rot = poses_rc[indices][:, :3, :3]
            normals = np.einsum("nij,nhwj->nhwi", rot, local)
        else:
            raise FileNotFoundError(
                f"normal_supervision requested but {ndir} has no "
                "normal PNGs (expected normals/%06d_normal.png)")

    masks_keep, semantics = load_moving_masks(
        root_dir, indices, semantics, h, w, sensor_num, num,
        dilate_semantic=semantic_dilate)
    masks_exclude = (1.0 - masks_keep if masks_keep is not None
                     else np.zeros(images.shape[:3], np.float32))

    timestamps = None
    time_scale = (0.0, TIME_UNIT_US)
    ts_file = os.path.join(root_dir, "timestamps.txt")
    if os.path.exists(ts_file):
        timestamps, time_scale = load_timestamps(root_dir)

    cam2global = np.eye(4, dtype=np.float64)
    c2w_file = os.path.join(root_dir, "c2w.npy")
    if os.path.exists(c2w_file):
        cam2global = np.load(c2w_file).astype(np.float64)

    tracks = track_mask = None
    classes: List[str] = []
    if load_objects and timestamps is not None:
        tracks, track_mask, classes = load_tracks(
            root_dir, frame, cam2global, timestamps, time_scale)

    lidar = None
    lidar_fields = {}
    if load_lidar:
        lidar = load_lidar_rays(root_dir, frame, cam2global,
                                moving_mask=not load_objects)
        if lidar is not None:
            lidar_ts = None
            lt_file = os.path.join(root_dir, "lidar_points",
                                   "timestamps.txt")
            if os.path.exists(lt_file):
                raw = np.loadtxt(lt_file)
                # Per-sweep scene-normalized times: the LIDAR-split render
                # path stamps sweep i with these so object pose
                # interpolation works (reference datasets.py:637,703-704).
                sweep_ts = ((raw - time_scale[0])
                            / time_scale[1]).astype(np.float32)
                lidar["sweep_timestamps"] = sweep_ts
                lidar_ts = sweep_ts[lidar["frame_ids"]]
            lidar_fields = dict(
                lidar_origins=lidar["origins"], lidar_dirs=lidar["dirs"],
                lidar_depth=lidar["depth"],
                lidar_intensity=lidar["intensity"],
                lidar_timestamps=lidar_ts)

    data = SceneData(
        camtoworlds=poses_rc[indices],
        pixtocam=np.linalg.inv(K[indices]).astype(np.float32),
        images=images, near=near, far=far, depths=depths,
        semantics=semantics, masks=masks_exclude, normals=normals,
        timestamps=(timestamps[indices].astype(np.float32)
                    if timestamps is not None else None),
        **lidar_fields)
    return NuscenesScene(
        data=data, frame=frame, cam2global=cam2global, tracks=tracks,
        track_mask=track_mask, track_classes=classes, lidar=lidar,
        splits=splits)
