# Copy of nerf_lidar_tpu/data/validate.py (see tests/test_torch_host.py).
"""Scene-directory validator: check a real nuScenes export against every
convention the loader assumes BEFORE burning chip time on a broken scene.

The loader (data/nuscenes.py) consumes the reference's on-disk layout
(reference internal/datasets.py:1183-1538 NUSCENES._load_renderings,
scripts load_nuscenes.py, internal/lidar_utils.py:193-267). This module
re-states each convention as an explicit check with a failure message that
names the exact reference convention violated, so the moment a real scene
is mountable, `nerf-lidar validate_scene <dir>` either passes or says
precisely what to fix. No chip, no jax — pure host-side numpy.

Checks are graded:
  ERROR   the loader will crash or silently mis-load
  WARN    optional subsystem missing / suspicious value (still trainable)
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import List, Optional

import numpy as np

from . import png


@dataclasses.dataclass
class Issue:
    level: str  # 'ERROR' | 'WARN'
    path: str
    message: str

    def __str__(self):
        return f"[{self.level}] {self.path}: {self.message}"


class _Report:
    def __init__(self):
        self.issues: List[Issue] = []
        self.info: List[str] = []

    def error(self, path, msg):
        self.issues.append(Issue("ERROR", path, msg))

    def warn(self, path, msg):
        self.issues.append(Issue("WARN", path, msg))

    def note(self, msg):
        self.info.append(msg)

    @property
    def ok(self):
        return not any(i.level == "ERROR" for i in self.issues)


def _check_poses_bounds(root, rep) -> Optional[int]:
    """poses_bounds.npy: [N, 19] LLFF rows = 3x5 pose+K column + 2 bounds +
    2 raw hw (reference load_nuscenes.py:97-122 load_waymo_meta)."""
    path = os.path.join(root, "poses_bounds.npy")
    if not os.path.exists(path):
        rep.error(path, "missing; the loader starts from poses_bounds.npy "
                        "(load_nuscenes.py:97 np.load)")
        return None
    try:
        arr = np.load(path)
    except Exception as e:  # noqa: BLE001
        rep.error(path, f"np.load failed: {e}")
        return None
    if arr.ndim != 2 or arr.shape[1] != 19:
        rep.error(path, f"shape {arr.shape}, want [N, 19] = 3x5 "
                        "pose-with-K-column + near/far + raw h/w "
                        "(load_nuscenes.py:98-103)")
        return None
    if not np.isfinite(arr).all():
        rep.error(path, "non-finite entries")
    poses = arr[:, :-4].reshape(-1, 3, 5)
    hw = arr[:, -2:]
    focal = poses[:, 2, 4]
    if (focal <= 0).any():
        rep.error(path, "K column row 2 (focal) must be positive "
                        "(load_nuscenes.py:104-107 cx/cy/f unpack)")
    if (hw <= 0).any():
        rep.error(path, "trailing [h, w] columns must be positive "
                        "(raw capture size, e.g. 900 1600)")
    # Rotation part should be orthonormal-ish after the LLFF column swap.
    r = np.concatenate([poses[:, :, 1:2], -poses[:, :, 0:1],
                        poses[:, :, 2:3]], 2)
    err = np.abs(np.einsum("nij,nik->njk", r, r)
                 - np.eye(3)).max(axis=(1, 2))
    if (err > 1e-2).any():
        rep.warn(path, f"rotation columns deviate from orthonormal by up "
                       f"to {err.max():.3g} (LLFF [-u, r, -t] convention "
                       "mismatch? load_nuscenes.py:120-121)")
    rep.note(f"poses_bounds: {len(arr)} frames, raw hw "
             f"{hw[0].astype(int).tolist()}, focal {focal[0]:.1f}")
    return len(arr)


def _sorted_files(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def _check_images(root, n_poses, factor, rep):
    d = os.path.join(root, "images")
    files = _sorted_files(d)
    if not files:
        rep.error(d, "missing or empty; loader reads sorted(images/) "
                     "(datasets.py:1267-1273)")
        return None, None
    if n_poses is not None and len(files) != n_poses:
        rep.error(d, f"{len(files)} images but poses_bounds has {n_poses} "
                     "rows; they index the same sorted order "
                     "(datasets.py:1267)")
    try:
        # The port's copy reads through png.imread (PNG without imageio).
        img0 = png.imread(os.path.join(d, files[0]))
        img_last = png.imread(os.path.join(d, files[-1]))
    except Exception as e:  # noqa: BLE001
        rep.error(d, f"imread failed: {e}")
        return None, None
    if img0.ndim != 3 or img0.shape[-1] < 3:
        rep.error(d, f"first image shape {img0.shape}; want [H, W, 3] RGB")
        return None, None
    if img0.shape != img_last.shape:
        rep.error(d, f"image shapes differ across frames: {img0.shape} vs "
                     f"{img_last.shape}; one camera resolution per scene")
    h, w = img0.shape[:2]
    rep.note(f"images: {len(files)} files at {h}x{w}")
    return h, w


def _check_aligned_pngs(root, name, n_images, hw, rep, dtype_check=None,
                        required=False, what=""):
    d = os.path.join(root, name)
    files = _sorted_files(d)
    if not files:
        (rep.error if required else rep.warn)(
            d, f"missing/empty; {what}")
        return
    if n_images is not None and len(files) != n_images:
        rep.error(d, f"{len(files)} files vs {n_images} images; sidecars "
                     "are index-aligned with sorted(images/) "
                     "(datasets.py:1274-1322)")
    try:
        img = png.imread(os.path.join(d, files[0]))
    except Exception as e:  # noqa: BLE001
        rep.error(d, f"imread failed: {e}")
        return
    if hw is not None and img.shape[:2] != hw:
        rep.error(d, f"resolution {img.shape[:2]} != images {hw}")
    if dtype_check:
        dtype_check(d, img)


def _check_depth(root, n_images, hw, rep):
    def dt(d, img):
        if img.dtype != np.uint16:
            rep.warn(d, f"dtype {img.dtype}; reference depth PNGs are "
                        "16-bit with meters = value/256 "
                        "(datasets.py:1274-1280)")
    _check_aligned_pngs(root, "depth", n_images, hw, rep, dt,
                        what="depth supervision disabled without it "
                             "(datasets.py:1274)")


def _check_labels(root, n_images, hw, rep):
    def dt(d, img):
        if not np.issubdtype(img.dtype, np.integer):
            rep.error(d, f"dtype {img.dtype}; labels are integer "
                         "cityscapes-style id PNGs")
        ids = np.unique(img)
        bad = ids[(ids > 18) & (ids != 255)]
        if bad.size:
            rep.warn(d, f"label ids {bad.tolist()} outside [0, 18] + "
                        "{255=unlabeled} (19-class scheme, "
                        "colormap.yaml / datasets.py:1281)")
    _check_aligned_pngs(root, "labels", n_images, hw, rep, dt,
                        what="semantic supervision disabled without it")


def _check_masks(root, n_images, hw, rep):
    d = os.path.join(root, "mask")
    files = _sorted_files(d)
    if not files:
        rep.warn(d, "missing; no moving-object masking "
                    "(datasets.py:1281-1322)")
        return
    if n_images is not None and len(files) != n_images:
        rep.error(d, f"{len(files)} mask txts vs {n_images} images")
    with open(os.path.join(d, files[0])) as f:
        rows = f.readlines()
    for r in rows:
        parts = r.split()
        if len(parts) < 4:
            rep.error(d, f"row '{r.strip()}' has {len(parts)} fields; "
                         "loader takes the LAST 4 as int y0 x0 y1 x1 "
                         "(datasets.py:1287-1293)")
            break
        try:
            y0, x0, y1, x1 = [int(float(v)) for v in parts[-4:]]
        except ValueError:
            rep.error(d, f"row '{r.strip()}' last-4 fields not numeric")
            break
        if hw is not None and (y1 > hw[0] or x1 > hw[1] or y0 < 0 or x0 < 0):
            rep.warn(d, f"box ({y0},{x0},{y1},{x1}) exceeds image {hw}; "
                        "boxes must be in LOADED-image pixel coords "
                        "(mind --factor)")


def _check_normals(root, n_images, hw, rep):
    d = os.path.join(root, "normals")
    files = _sorted_files(d)
    if not files:
        rep.warn(d, "missing; normal_supervision needs "
                    "normals/%06d_normal.png (datasets.py:1486-1497)")
        return
    bad = [f for f in files if not f.endswith("_normal.png")]
    if bad:
        rep.warn(d, f"{len(bad)} files without the _normal.png suffix "
                    f"(e.g. {bad[0]})")
    _check_aligned_pngs(root, "normals", n_images, hw, rep,
                        what="(unreachable)")


def _check_timestamps(root, n_poses, rep):
    path = os.path.join(root, "timestamps.txt")
    if not os.path.exists(path):
        rep.warn(path, "missing; dynamic objects need per-image times "
                       "(load_nuscenes.py:333-340)")
        return None
    try:
        t = np.loadtxt(path)
    except Exception as e:  # noqa: BLE001
        rep.error(path, f"np.loadtxt failed: {e}")
        return None
    t = np.atleast_1d(t)
    if n_poses is not None and len(t) != n_poses:
        rep.error(path, f"{len(t)} rows vs {n_poses} poses")
    span = (t.max() - t.min())
    if span > 0 and span < 1e3:
        rep.warn(path, f"time span {span:.3g}; reference times are "
                       "MICROSECONDS (1e6 us/s, load_nuscenes.py:337) — "
                       "a span this small looks like seconds")
    return t


def _check_matrix(root, name, shape, rep, required=False, what=""):
    path = os.path.join(root, name)
    if not os.path.exists(path):
        (rep.error if required else rep.warn)(path, f"missing; {what}")
        return None
    try:
        m = np.load(path)
    except Exception as e:  # noqa: BLE001
        rep.error(path, f"np.load failed: {e}")
        return None
    if m.shape != shape:
        rep.error(path, f"shape {m.shape}, want {shape}")
        return None
    return m


def _check_bboxes(root, timestamps, rep):
    path = os.path.join(root, "bboxes.json")
    if not os.path.exists(path):
        rep.warn(path, "missing; dynamic objects disabled "
                       "(datasets.py:1394-1462)")
        return
    try:
        with open(path) as f:
            bb = json.load(f)
    except Exception as e:  # noqa: BLE001
        rep.error(path, f"json.load failed: {e}")
        return
    if not isinstance(bb, dict):
        rep.error(path, f"top level {type(bb).__name__}, want dict of "
                        "instance_token -> [annotations]")
        return
    n_tracks = 0
    for inst, anns in bb.items():
        if inst == "ego":
            continue
        if not isinstance(anns, list) or not anns:
            rep.error(path, f"instance {inst!r}: want non-empty list")
            continue
        ann = anns[0]
        if len(ann) < 12:
            rep.error(path, f"instance {inst!r}: annotation length "
                            f"{len(ann)}, want >= 12 = center(3) wlh(3) "
                            "quat(4) time class (datasets.py:1400-1412)")
            continue
        if not isinstance(ann[11], str):
            rep.error(path, f"instance {inst!r}: field 11 is "
                            f"{type(ann[11]).__name__}, want the class "
                            "name string (e.g. 'vehicle.car')")
        q = np.asarray(ann[6:10], np.float64)
        if abs(np.linalg.norm(q) - 1.0) > 0.05:
            rep.warn(path, f"instance {inst!r}: quaternion norm "
                           f"{np.linalg.norm(q):.3f} != 1 "
                           "(fields 6:10 must be wxyz unit quat)")
        if timestamps is not None:
            t = float(ann[10])
            if not (timestamps.min() - 1e6 <= t <= timestamps.max() + 1e6):
                rep.warn(path, f"instance {inst!r}: time {t:.0f} far "
                               "outside timestamps.txt range — same raw "
                               "unit/epoch required (datasets.py:1407)")
        if "human" not in str(ann[11]):
            n_tracks += 1
    rep.note(f"bboxes.json: {n_tracks} non-human tracks")


def _check_lidar(root, rep):
    d = os.path.join(root, "lidar_points")
    bins = sorted(glob.glob(os.path.join(d, "*.bin")))
    if not bins:
        rep.warn(d, "no .bin sweeps; LiDAR supervision/simulation "
                    "disabled (lidar_utils.py:193-267)")
        return
    n = len(bins)
    want_names = [f"{i:06d}.bin" for i in range(n)]
    got_names = [os.path.basename(b) for b in bins]
    if got_names != want_names:
        rep.error(d, f"bins must be %06d.bin for 0..{n - 1}; got "
                     f"{got_names[:3]}... (loader indexes by i, "
                     "nuscenes.py read loop)")
    sz = os.path.getsize(bins[0])
    if sz % 20 != 0:
        rep.error(bins[0], f"size {sz} not divisible by 20 bytes; rows "
                           "are float32 x 5 = [xyz, intensity, ring] "
                           "(lidar_utils.py:346-353)")
    l2g = _check_matrix(os.path.join(root, "lidar_points"),
                        "lidar2global.npy", (n, 4, 4), rep, required=True,
                        what="per-sweep LiDAR->global extrinsics "
                             "(lidar_utils.py:200)")
    if l2g is None:
        # Maybe it exists with a different first dim.
        p = os.path.join(d, "lidar2global.npy")
        if os.path.exists(p):
            m = np.load(p)
            if m.ndim == 3 and m.shape[1:] == (4, 4) and m.shape[0] != n:
                rep.error(p, f"{m.shape[0]} transforms vs {n} sweeps")
    for i in range(n):
        p = os.path.join(d, f"points{i:03d}.npy")
        if not os.path.exists(p):
            rep.error(p, "missing; loader reads the sensor center from "
                         "points%03d.npy [:, -1][:3] (nuscenes.py / "
                         "lidar_utils.py sweep origins)")
            break
        if i == 0:
            m = np.load(p)
            if m.ndim != 2 or m.shape[0] < 3:
                rep.error(p, f"shape {m.shape}; want [>=3, K] with the "
                             "sensor center in the LAST column")
    ts = os.path.join(d, "timestamps.txt")
    if not os.path.exists(ts):
        rep.warn(ts, "missing; sweep replay with dynamic objects needs "
                     "per-sweep times (datasets.py:637,703-704)")
    else:
        t = np.atleast_1d(np.loadtxt(ts))
        if len(t) != n:
            rep.error(ts, f"{len(t)} rows vs {n} sweeps")
    labels = sorted(glob.glob(os.path.join(d, "*.label")))
    if labels:
        raw = np.fromfile(labels[0], dtype=np.uint32)
        rows = os.path.getsize(bins[0]) // 20
        if len(raw) != rows:
            rep.error(labels[0], f"{len(raw)} labels vs {rows} scan rows; "
                                 ".label sidecars are uint32 per raw "
                                 "scan row (SemanticKITTI layout)")
    lm = os.path.join(root, "lidar_mask")
    if os.path.isdir(lm):
        files = _sorted_files(lm)
        if files:
            with open(os.path.join(lm, files[0])) as f:
                row = f.readline().split()
            if row and (len(row) - 1) % 24 != 0:
                rep.error(lm, f"row has {len(row)} fields; want label + "
                              "8 corners x 3 coords (reshape(-1, 8, 3), "
                              "nuscenes.py load_lidar_rays)")
    rep.note(f"lidar_points: {n} sweeps, {os.path.getsize(bins[0]) // 20} "
             "points in sweep 0")


def validate_scene(root: str, sensor_num: int = 6, factor: int = 1):
    """Validate a scene dir. Returns (_Report with .issues/.info/.ok)."""
    rep = _Report()
    if not os.path.isdir(root):
        rep.error(root, "not a directory")
        return rep
    n_poses = _check_poses_bounds(root, rep)
    hw = _check_images(root, n_poses, factor, rep)
    hw = None if hw == (None, None) else hw
    if n_poses is not None and sensor_num == 6 and n_poses % 6 != 0:
        rep.error(os.path.join(root, "images"),
                  f"{n_poses} frames with sensor_num=6: must divide by 6 "
                  "(camera-blocked order, front block first — front_num = "
                  "N // 6 gates the hood mask, datasets.py:1311-1320)")
    _check_depth(root, n_poses, hw, rep)
    _check_labels(root, n_poses, hw, rep)
    _check_masks(root, n_poses, hw, rep)
    _check_normals(root, n_poses, hw, rep)
    t = _check_timestamps(root, n_poses, rep)
    _check_matrix(root, "c2w.npy", (4, 4), rep,
                  what="front-camera->global reference transform; without "
                       "it LiDAR/global alignment assumes identity "
                       "(nuscenes.py load_scene)")
    _check_bboxes(root, t if t is not None else None, rep)
    _check_lidar(root, rep)
    if hw is not None and n_poses is not None:
        # Hood-mask sanity: reference masks rows >= 800/900 of the native
        # height on front cams; warn if the loaded height is not a clean
        # fraction of the recorded raw height.
        arr = np.load(os.path.join(root, "poses_bounds.npy"))
        raw_h = int(arr[0, -2])
        if raw_h % hw[0] != 0:
            rep.warn(os.path.join(root, "images"),
                     f"loaded height {hw[0]} does not divide raw height "
                     f"{raw_h}; the resolution-scaled hood mask "
                     "(nuscenes.py:108-113) assumes integer downsampling")
    return rep
