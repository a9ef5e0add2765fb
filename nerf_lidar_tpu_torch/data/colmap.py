# Copy of nerf_lidar_tpu/data/colmap.py (see tests/test_torch_host.py).
"""Compact COLMAP sparse-model reader (binary + text), written from the
published COLMAP model format. Replaces the reference's vendored pycolmap
package (reference internal/pycolmap/, consumed by datasets.py:64-156
NeRFSceneManager.process) with the ~150 lines this pipeline actually needs:
camera intrinsics/distortion and image extrinsics.

Only the fields the NeRF loaders consume are kept; points3D are parsed
(for scene-bound estimation) but their tracks are skipped.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import quaternion as quat

# model_id -> (name, num_params). Params are ordered as COLMAP documents.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),   # f, cx, cy
    1: ("PINHOLE", 4),          # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),    # f, cx, cy, k1
    3: ("RADIAL", 5),           # f, cx, cy, k1, k2
    4: ("OPENCV", 8),           # fx, fy, cx, cy, k1, k2, p1, p2
    5: ("OPENCV_FISHEYE", 8),   # fx, fy, cx, cy, k1, k2, k3, k4
}
_NAME_TO_ID = {v[0]: k for k, v in CAMERA_MODELS.items()}


@dataclasses.dataclass
class Camera:
    camera_id: int
    model: str  # one of CAMERA_MODELS names
    width: int
    height: int
    params: np.ndarray  # [num_params] float64

    @property
    def fx(self) -> float:
        return float(self.params[0])

    @property
    def fy(self) -> float:
        return float(self.params[1] if self.model in
                     ("PINHOLE", "OPENCV", "OPENCV_FISHEYE")
                     else self.params[0])

    @property
    def cx(self) -> float:
        i = 2 if self.model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE") else 1
        return float(self.params[i])

    @property
    def cy(self) -> float:
        i = 3 if self.model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE") else 2
        return float(self.params[i])

    def distortion(self) -> Tuple[Optional[Dict[str, float]], str]:
        """(distortion_params or None, camtype) in this repo's conventions
        (data/camera.py pixels_to_rays), mirroring the reference's mapping
        in datasets.py:119-155."""
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "PINHOLE"):
            return None, "perspective"
        if self.model == "SIMPLE_RADIAL":
            return dict(k1=float(p[3])), "perspective"
        if self.model == "RADIAL":
            return dict(k1=float(p[3]), k2=float(p[4])), "perspective"
        if self.model == "OPENCV":
            return dict(k1=float(p[4]), k2=float(p[5]),
                        p1=float(p[6]), p2=float(p[7])), "perspective"
        if self.model == "OPENCV_FISHEYE":
            return dict(k1=float(p[4]), k2=float(p[5]),
                        k3=float(p[6]), k4=float(p[7])), "fisheye"
        raise ValueError(f"unsupported COLMAP camera model {self.model}")


@dataclasses.dataclass
class Image:
    image_id: int
    qvec: np.ndarray  # [4] (w, x, y, z), world-to-camera rotation
    tvec: np.ndarray  # [3] world-to-camera translation
    camera_id: int
    name: str

    def world_to_cam(self) -> np.ndarray:
        """[4, 4] world-to-camera matrix."""
        m = np.eye(4)
        m[:3, :3] = quat.to_rotation_matrix(self.qvec)
        m[:3, 3] = self.tvec
        return m


def _read(f, fmt: str):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{np_}d"))
            out[cid] = Camera(cid, name, int(w), int(h), params)
    return out


def read_images_bin(path: str) -> Dict[int, Image]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            q = np.array(_read(f, "<4d"))
            t = np.array(_read(f, "<3d"))
            (cid,) = _read(f, "<i")
            chars = []
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                chars.append(c)
            (npts,) = _read(f, "<Q")
            f.seek(npts * 24, os.SEEK_CUR)  # (x, y, point3D_id) per point
            out[iid] = Image(iid, q, t, cid, b"".join(chars).decode("utf-8"))
    return out


def read_points3d_bin(path: str) -> np.ndarray:
    """[P, 3] xyz only; per-point tracks are skipped."""
    pts = []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            f.seek(8, os.SEEK_CUR)  # point3D_id
            pts.append(_read(f, "<3d"))
            f.seek(3 + 8, os.SEEK_CUR)  # rgb + error
            (track_len,) = _read(f, "<Q")
            f.seek(track_len * 8, os.SEEK_CUR)
    return np.array(pts, np.float64).reshape(-1, 3)


def read_cameras_txt(path: str) -> Dict[int, Camera]:
    out = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cid, model = int(parts[0]), parts[1]
        if model not in _NAME_TO_ID:
            raise ValueError(f"unsupported COLMAP camera model {model}")
        out[cid] = Camera(cid, model, int(parts[2]), int(parts[3]),
                          np.array([float(x) for x in parts[4:]]))
    return out


def read_images_txt(path: str) -> Dict[int, Image]:
    out = {}
    # Each image record is a pose line followed by a 2D-point line; the
    # point line is EMPTY for images with zero observations, so records
    # can't be recovered by filtering blanks and striding — consume the
    # line after each pose unconditionally.
    expect_points = False
    for line in open(path):
        s = line.strip()
        if expect_points:
            expect_points = False
            continue
        if not s or s.startswith("#"):
            continue
        p = s.split()
        # The image name is the remainder of the pose line — filenames may
        # contain spaces (COLMAP writes them verbatim).
        out[int(p[0])] = Image(
            int(p[0]), np.array([float(x) for x in p[1:5]]),
            np.array([float(x) for x in p[5:8]]), int(p[8]),
            " ".join(p[9:]))
        expect_points = True
    return out


def read_model(sparse_dir: str):
    """Read a COLMAP sparse model directory (binary preferred, text
    fallback). Returns (cameras, images, points_xyz_or_None)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cameras = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        images = read_images_bin(os.path.join(sparse_dir, "images.bin"))
        p3d = os.path.join(sparse_dir, "points3D.bin")
        points = read_points3d_bin(p3d) if os.path.exists(p3d) else None
    else:
        cameras = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        images = read_images_txt(os.path.join(sparse_dir, "images.txt"))
        points = None
    return cameras, images, points


def load_nerf_poses(sparse_dir: str):
    """The reference NeRFSceneManager.process (datasets.py:71-155):
    camera-to-world poses in the NeRF (right, up, back) frame plus shared
    inverse intrinsics and distortion.

    Returns (names, poses [N,3,4], pixtocam [3,3], distortion_params,
    camtype, points_xyz_or_None, (width, height)).
    """
    cameras, images, points = read_model(sparse_dir)
    cam = cameras[min(cameras)]  # shared intrinsics, like the reference
    k = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
    pixtocam = np.linalg.inv(k)

    names, c2ws = [], []
    for iid in sorted(images):
        im = images[iid]
        c2w = np.linalg.inv(im.world_to_cam())[:3, :4]
        # COLMAP (right, down, fwd) -> NeRF (right, up, back).
        c2ws.append(c2w @ np.diag([1.0, -1.0, -1.0, 1.0]))
        names.append(im.name)
    poses = np.stack(c2ws).astype(np.float64)
    distortion, camtype = cam.distortion()
    return (names, poses, pixtocam, distortion, camtype, points,
            (cam.width, cam.height))


# ---------------------------------------------------------------------------
# Writers (used by tests and the synthetic-scene tooling to fabricate a
# model dir; COLMAP itself is not available in this environment).

def write_cameras_bin(path: str, cameras: Dict[int, Camera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid = _NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.camera_id, mid, cam.width,
                                cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_bin(path: str, images: Dict[int, Image]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_bin(path: str, xyz: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, p in enumerate(xyz):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<3d", *p))
            f.write(struct.pack("<3B", 128, 128, 128))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 0))
