# Copy of nerf_lidar_tpu/data/tat_dtu.py (see tests/test_torch_host.py).
"""Tanks-and-Temples and DTU scene loading (reference
internal/waymo_zipnerf_dataset.py:817-1010 — TanksAndTemplesNerfPP,
TanksAndTemplesFVS, DTU).

These are the remaining entries of the reference's multinerf dataset zoo
(Blender/LLFF live in data/llff.py, WAYMO shares the poses_bounds path of
data/nuscenes.py). Everything stays host-side numpy and returns the same
NuscenesScene/SceneData the other loaders produce, so training, eval, and
the render entries run unchanged.

Format conventions, per loader:

- TaT-NeRF++ (`tat_nerfpp`): <root>/{train,test,camera_path}/{rgb,pose,
  intrinsics} with one whitespace 4x4 matrix file per image. Poses are
  OpenCV cam-to-world; flipping Y/Z columns converts to the OpenGL frame
  the model uses (reference :839-841).
- TaT-FVS (`tat_fvs`): <root>/dense/ibr3d_*/ pyramid; `factor` indexes the
  resolution ladder from largest (reference :873-880). Ks/Rs/ts.npy hold
  COLMAP world-to-cam; poses are inverted, flipped, then PCA-normalized.
- DTU (`dtu`): <root>/rect_{i:03d}_<light>.png rectified captures plus
  <root>/../../cal18/pos_{i:03d}.txt 3x4 projection matrices, decomposed
  into K[R|t] here with an RQ factorization (the reference calls
  cv2.decomposeProjectionMatrix, :972-981). Poses are recentered, rescaled
  by the max |t| and flipped into OpenGL (reference :985-1000).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from . import camera as camlib
from . import png
from .batching import SceneData
from .nuscenes import NuscenesScene
from ..lidar.transforms import SceneFrame

_FLIP_YZ = np.diag(np.array([1.0, -1.0, -1.0, 1.0]))


def _imread(path: str) -> np.ndarray:
    # The port's copy: PNG through data/png.py, other formats through
    # imageio (png.imread).
    return png.imread(path)


def _load_rgb(path: str) -> np.ndarray:
    img = _imread(path).astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


def decompose_projection(p: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decompose a 3x4 projection P = K [R | -R c] into (K, R, c).

    K is upper-triangular with positive diagonal, R is a world-to-camera
    rotation, c the camera center (P @ [c, 1] == 0). Numpy RQ stand-in for
    the reference's cv2.decomposeProjectionMatrix (reference :972-976)."""
    import scipy.linalg
    m = np.asarray(p, np.float64)[:, :3]
    k, r = scipy.linalg.rq(m)
    # RQ is unique only up to per-row signs; fold them so diag(K) > 0.
    signs = np.diag(np.sign(np.diag(k)))
    k = k @ signs
    r = signs @ r
    if np.linalg.det(r) < 0:  # projection scale ambiguity
        k, r = -k, -r
    c = -np.linalg.solve(m, np.asarray(p, np.float64)[:, 3])
    return k / k[2, 2], r, c


def _scene(data: SceneData, splits, render_poses=None) -> NuscenesScene:
    return NuscenesScene(
        data=data, frame=SceneFrame.identity(), cam2global=np.eye(4),
        tracks=None, track_mask=None, track_classes=[], lidar=None,
        splits=splits, render_poses=render_poses)


def load_tat_nerfpp(root_dir: str, split: str = "train",
                    near: float = 0.2, far: float = 1e6) -> NuscenesScene:
    """Tanks and Temples, NeRF++ layout (reference :817-862)."""
    basedir = os.path.join(root_dir, "test" if split == "test" else "train")

    def load_files(dirname, load_fn, shape=None):
        d = os.path.join(basedir, dirname)
        files = [os.path.join(d, f) for f in sorted(os.listdir(d))]
        mats = np.array([load_fn(f) for f in files])
        if shape is not None:
            mats = mats.reshape(mats.shape[:1] + shape)
        return mats

    poses = load_files("pose", np.loadtxt, (4, 4))
    poses = (poses @ _FLIP_YZ)[:, :3, :4]
    intrinsics = load_files("intrinsics", np.loadtxt, (4, 4))
    images = load_files("rgb", _load_rgb)
    h, w = images.shape[1:3]
    focal = float(intrinsics[0, 0, 0])
    pixtocam = np.linalg.inv(
        camlib.intrinsic_matrix(focal, focal, w / 2, h / 2)
    ).astype(np.float32)

    n = images.shape[0]
    idx = np.arange(n)
    # Train/test are separate directories: each split sees all its images.
    splits = {"train": idx, "test": idx, "loaded": idx}
    data = SceneData(
        camtoworlds=poses.astype(np.float32), pixtocam=pixtocam,
        images=images.astype(np.float32), near=float(near), far=float(far))
    render_poses = None
    campath = os.path.join(root_dir, "camera_path", "pose")
    if os.path.isdir(campath):
        rp = np.array([np.loadtxt(os.path.join(campath, f))
                       for f in sorted(os.listdir(campath))])
        render_poses = (rp.reshape(-1, 4, 4) @ _FLIP_YZ)[:, :3, :4].astype(
            np.float32)
    return _scene(data, splits, render_poses)


def load_tat_fvs(root_dir: str, split: str = "train", factor: int = 0,
                 llffhold: int = 8, near: float = 0.2,
                 far: float = 1e6) -> NuscenesScene:
    """Tanks and Temples, Free-View-Synthesis layout (reference :865-928)."""
    basedir = os.path.join(root_dir, "dense")
    sizes = [f for f in sorted(os.listdir(basedir))
             if f.startswith("ibr3d")][::-1]
    if factor >= len(sizes):
        raise ValueError(f"factor {factor} larger than {len(sizes)} "
                         f"available ibr3d resolutions in {basedir}")
    basedir = os.path.join(basedir, sizes[max(factor, 0)])

    files = [f for f in sorted(os.listdir(basedir)) if f.startswith("im_")]
    images = np.array([_load_rgb(os.path.join(basedir, f)) for f in files])
    intrinsics, rot, trans = (np.load(os.path.join(basedir, f"{n}.npy"))
                              for n in ("Ks", "Rs", "ts"))

    # COLMAP world-to-cam -> our cam-to-world, then flip into OpenGL.
    w2c = np.concatenate([rot, trans[..., None]], axis=-1)
    c2w = np.linalg.inv(camlib.pad_poses(w2c))[:, :3, :4]
    c2w = c2w @ _FLIP_YZ
    poses, _, _ = camlib.transform_poses_pca(c2w)

    h, w = images.shape[1:3]
    focal = float(intrinsics[0, 0, 0])
    pixtocam = np.linalg.inv(
        camlib.intrinsic_matrix(focal, focal, w / 2, h / 2)
    ).astype(np.float32)

    n = images.shape[0]
    idx = np.arange(n)
    splits = {"test": idx[idx % llffhold == 0],
              "train": idx[idx % llffhold != 0]}
    sel = splits.get(split, splits["train"])
    splits = dict(splits, loaded=sel)  # global ids actually loaded
    render_poses = camlib.generate_ellipse_path(poses)
    data = SceneData(
        camtoworlds=poses[sel].astype(np.float32), pixtocam=pixtocam,
        images=images[sel].astype(np.float32),
        near=float(near), far=float(far))
    return _scene(data, splits, render_poses)


def load_dtu(root_dir: str, split: str = "train", factor: int = 1,
             dtu_light_cond: int = 2, dtuhold: int = 8,
             near: float = 0.2, far: float = 1e6,
             cal_dir: Optional[str] = None) -> NuscenesScene:
    """DTU rectified scans (reference :930-1010).

    Each scan holds n images under 8 lighting conditions; `dtu_light_cond`
    < 7 picks one fixed condition (exposure suffix _r5000 below image 50,
    _r7000 from it), 7 picks the 'max' composite. Projection matrices live
    in <root>/../../cal18/pos_{i:03d}.txt unless `cal_dir` overrides."""
    from ..utils.image import downsample_area

    cal_dir = cal_dir or os.path.join(root_dir, "..", "..", "cal18")
    n_images = len(os.listdir(root_dir)) // 8
    images, pixtocams, camtoworlds = [], [], []
    for i in range(1, n_images + 1):
        if dtu_light_cond < 7:
            light = f"{dtu_light_cond}_r" + ("5000" if i < 50 else "7000")
        else:
            light = "max"
        img = _load_rgb(os.path.join(root_dir, f"rect_{i:03d}_{light}.png"))
        if factor > 1:
            img = downsample_area(img, factor)
        images.append(img)

        proj = np.loadtxt(os.path.join(cal_dir, f"pos_{i:03d}.txt"),
                          dtype=np.float64)
        k, r, c = decompose_projection(proj)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = r.T
        pose[:3, 3] = c
        camtoworlds.append(pose[:3])
        if factor > 1:
            k = np.diag([1.0 / factor, 1.0 / factor, 1.0]) @ k
        pixtocams.append(np.linalg.inv(k))

    images = np.stack(images)
    pixtocams = np.stack(pixtocams).astype(np.float32)
    camtoworlds = np.stack(camtoworlds)

    # Center, rescale by the max |t|, flip into OpenGL (reference :985-1000).
    camtoworlds, _ = camlib.recenter_poses(camtoworlds)
    scale = np.max(np.abs(camtoworlds[:, :3, -1]))
    camtoworlds[:, :3, -1] /= scale
    camtoworlds = camtoworlds @ _FLIP_YZ.astype(np.float32)

    idx = np.arange(images.shape[0])
    splits = {"test": idx[idx % dtuhold == 0],
              "train": idx[idx % dtuhold != 0]}
    sel = splits.get(split, splits["train"])
    splits = dict(splits, loaded=sel)  # global ids actually loaded
    data = SceneData(
        camtoworlds=camtoworlds[sel].astype(np.float32),
        pixtocam=pixtocams[sel],
        images=images[sel].astype(np.float32),
        near=float(near), far=float(far))
    return _scene(data, splits)
