# Copy of nerf_lidar_tpu/utils/raw.py (see tests/test_torch_host.py).
"""RawNeRF raw-sensor processing (reference internal/raw_utils.py).

Implements the full raw pipeline as host-side numpy: Bayer demosaicking,
black/white-level scaling, EXIF -> color-transform metadata, exposure
indexing, sRGB postprocessing, and the affine image matching used by
RawNeRF eval. The demosaic here is a normalized-convolution formulation
(mask-weighted 3x3 smoothing) rather than the reference's quad-reshape
construction — same bilinear estimator, expressed as three dense
stencil ops that vectorize cleanly.

DNG decoding needs `rawpy`, which is not available in every deployment;
`load_raw_images` therefore also accepts `.npy` mosaics (a [H, W] float
array per image + a `.json` EXIF sidecar) so the pipeline stays testable
and usable offline.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Brightness percentiles logged for re-exposure sweeps
# (reference raw_utils.py:157).
PERCENTILE_LIST = (80, 90, 97, 99, 100)

# Reference-illuminant RGB -> XYZ (Bradford-adapted sRGB D50 matrix, the
# standard constants; reference raw_utils.py:173-176).
RGB2XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                    [0.2126729, 0.7151522, 0.0721750],
                    [0.0193339, 0.1191920, 0.9503041]])

_EXIF_KEYS = ("BlackLevel", "WhiteLevel", "AsShotNeutral", "ColorMatrix2",
              "NoiseProfile")


def pixels_to_bayer_mask(pix_x: np.ndarray, pix_y: np.ndarray) -> np.ndarray:
    """Binary RGB mask of which channel each RGGB-mosaic pixel observes
    (reference raw_utils.py:38-46; used as a per-ray lossmult so training
    only supervises observed channels)."""
    r = (pix_x % 2 == 0) & (pix_y % 2 == 0)
    g = ((pix_x % 2) != (pix_y % 2))
    b = (pix_x % 2 == 1) & (pix_y % 2 == 1)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def _stencil_sum(z: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """3x3 cross-correlation with edge padding, via shifted adds."""
    out = np.zeros_like(z)
    zp = np.pad(z, 1, mode="edge")
    h, w = z.shape
    for dy in range(3):
        for dx in range(3):
            k = kernel[dy, dx]
            if k != 0.0:
                out += k * zp[dy:dy + h, dx:dx + w]
    return out


def bilinear_demosaic(bayer: np.ndarray) -> np.ndarray:
    """[H, W] RGGB mosaic -> [H, W, 3] RGB by bilinear interpolation.

    Normalized convolution: each channel's observed samples are scattered
    onto the full grid and smoothed by its bilinear stencil; dividing by
    the identically-smoothed observation mask yields exact bilinear
    weights at every site, including image edges (where the reference's
    roll-based variant wraps around). Same estimator as reference
    raw_utils.py:49-115 in the interior.
    """
    h, w = bayer.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    masks = pixels_to_bayer_mask(xx, yy)  # [H, W, 3]
    full = np.array([[0.25, 0.5, 0.25], [0.5, 1.0, 0.5], [0.25, 0.5, 0.25]])
    cross = np.array([[0.0, 0.25, 0.0], [0.25, 1.0, 0.25], [0.0, 0.25, 0.0]])
    out = []
    for c, kernel in ((0, full), (1, cross), (2, full)):
        m = masks[..., c]
        num = _stencil_sum(bayer * m, kernel)
        den = _stencil_sum(m, kernel)
        out.append(num / np.maximum(den, 1e-12))
    return np.stack(out, axis=-1).astype(bayer.dtype)


def postprocess_raw(raw: np.ndarray, camtorgb: np.ndarray,
                    exposure: Optional[float] = None) -> np.ndarray:
    """Demosaicked raw -> sRGB: color-correct, expose, gamma
    (reference raw_utils.py:11-35)."""
    if raw.shape[-1] != 3:
        raise ValueError(f"raw.shape[-1] is {raw.shape[-1]}, expected 3")
    if camtorgb.shape != (3, 3):
        raise ValueError(f"camtorgb.shape is {camtorgb.shape}, expected 3x3")
    rgb_linear = raw @ camtorgb.T
    if exposure is None:
        exposure = np.percentile(rgb_linear, 97)
    scaled = np.clip(rgb_linear / exposure, 0.0, 1.0)
    # sRGB OETF in numpy (same piecewise curve as utils.image.linear_to_srgb,
    # kept host-side: this runs in the input/vis pipeline, not on device).
    return np.where(scaled <= 0.0031308, 323 / 25 * scaled,
                    (211 * np.maximum(1e-10, scaled) ** (5 / 12) - 11) / 200)


def _parse_shutter(v) -> float:
    """EXIF ShutterSpeed -> seconds. exiftool emits '1/250', '3/10', '2',
    or 0.5 depending on the exposure length."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    if "/" in s:
        num, den = s.split("/")
        return float(num) / float(den)
    return float(s)


def _level_map(vals, n: int, hw: Tuple[int, int]) -> np.ndarray:
    """Per-image black/white levels -> array broadcastable against
    [N, H, W] mosaics. DNG metadata gives either one scalar per image or
    one value per CFA site (BlackLevelRepeatDim 2x2, row-major over the
    RGGB pattern)."""
    v = np.asarray(vals, np.float32).reshape(n, -1)
    if v.shape[1] == 1:
        return v[:, :, None]  # [N, 1, 1]
    if v.shape[1] == 4:
        quad = v.reshape(n, 2, 2)
        yy, xx = np.meshgrid(np.arange(hw[0]) % 2, np.arange(hw[1]) % 2,
                             indexing="ij")
        return quad[:, yy, xx]  # [N, H, W]
    raise ValueError(
        f"unsupported per-image level count {v.shape[1]} (expected 1 or 4)")


def process_exif(exifs: Sequence[Dict]) -> Dict:
    """EXIF dicts (exiftool -json output) -> the metadata RawNeRF needs:
    black/white levels, white balance, and the cam -> linear-sRGB color
    transform (reference raw_utils.py:178-232)."""
    meta: Dict = {}
    first = exifs[0]
    for key in _EXIF_KEYS:
        v = first.get(key)
        if v is None:
            continue
        if isinstance(v, (int, float)):
            vals = [x[key] for x in exifs]
        else:
            # exiftool string mode emits space-separated numbers; JSON
            # sidecars may carry real arrays — accept both.
            vals = [np.asarray(x[key], np.float64) if
                    isinstance(x[key], (list, tuple)) else
                    [float(z) for z in str(x[key]).split()] for x in exifs]
        meta[key] = np.squeeze(np.array(vals))
    meta["ShutterSpeed"] = np.array(
        [_parse_shutter(x["ShutterSpeed"]) for x in exifs])

    # cam -> sRGB: white balance (divide by AsShotNeutral), then invert the
    # row-normalized (rgb -> white-balanced-cam) matrix built from
    # ColorMatrix2 (XYZ -> camwb) @ RGB2XYZ.
    wb = meta["AsShotNeutral"].reshape(-1, 3)
    cam2camwb = np.stack([np.diag(1.0 / x) for x in wb])
    xyz2camwb = meta["ColorMatrix2"].reshape(-1, 3, 3)
    rgb2camwb = xyz2camwb @ RGB2XYZ
    rgb2camwb = rgb2camwb / rgb2camwb.sum(axis=-1, keepdims=True)
    meta["cam2rgb"] = np.linalg.inv(rgb2camwb) @ cam2camwb
    return meta


def load_raw_images(image_dir: str,
                    image_names: Optional[List[str]] = None
                    ) -> Tuple[np.ndarray, List[Dict]]:
    """Load raw mosaics + EXIF sidecars. `.dng` via rawpy when available;
    `.npy` mosaics always (reference raw_utils.py:117-154 + offline
    fallback)."""
    if not os.path.isdir(image_dir):
        raise ValueError(f"raw image folder {image_dir} does not exist")
    if image_names is None:
        image_names = [os.path.basename(f) for f in sorted(
            glob.glob(os.path.join(image_dir, "*.dng"))
            or glob.glob(os.path.join(image_dir, "*.npy")))]

    def load_one(name):
        base = os.path.join(image_dir, os.path.splitext(name)[0])
        if os.path.exists(base + ".npy"):
            raw = np.load(base + ".npy")
        else:
            try:
                import rawpy
            except ImportError as e:
                raise ImportError(
                    f"{base}.dng needs rawpy, which is unavailable; "
                    "pre-convert mosaics to .npy instead") from e
            with open(base + ".dng", "rb") as f:
                raw = rawpy.imread(f).raw_image
        with open(base + ".json", "rb") as f:
            exif = json.load(f)[0]
        return raw, exif

    raws, exifs = zip(*[load_one(x) for x in image_names])
    return np.stack(raws).astype(np.float32), list(exifs)


def load_raw_dataset(data_dir: str, image_names: Optional[List[str]],
                     exposure_percentile: float = 97.0,
                     n_downsample: int = 1):
    """RawNeRF input stack: [N, H/n, W/n, 3] demosaicked linear images +
    metadata with per-image exposure indices/values (reference
    raw_utils.py:235-339; the HDR+ test-scene special case is folded in
    by its callers there and out of scope here)."""
    raws, exifs = load_raw_images(os.path.join(data_dir, "raw"), image_names)
    meta = process_exif(exifs)

    shutters = meta["ShutterSpeed"]
    unique_shutters = np.sort(np.unique(shutters))[::-1]  # brightest first
    exposure_idx = np.zeros_like(shutters, dtype=np.int32)
    for i, s in enumerate(unique_shutters):
        exposure_idx[shutters == s] = i
    meta["exposure_idx"] = exposure_idx
    meta["unique_shutters"] = unique_shutters
    meta["exposure_values"] = shutters / unique_shutters[0]

    n = len(raws)
    black = _level_map(meta["BlackLevel"], n, raws.shape[1:])
    white = _level_map(meta["WhiteLevel"], n, raws.shape[1:])
    images = (raws - black) / (white - black)

    demosaicked = [bilinear_demosaic(im) for im in images]

    # Exposure point: percentile of frame 0 at full resolution, reused for
    # every visualization so brightness is comparable across logs.
    rgb0 = demosaicked[0] @ meta["cam2rgb"][0].T
    meta["exposure"] = np.percentile(rgb0, exposure_percentile)
    meta["exposure_levels"] = {p: np.percentile(rgb0, p)
                               for p in PERCENTILE_LIST}
    cam2rgb0 = meta["cam2rgb"][0]
    meta["postprocess_fn"] = (
        lambda z, x=meta["exposure"]: postprocess_raw(z, cam2rgb0, x))

    from . import image as imagelib
    return np.stack([imagelib.downsample_area(rgb, n_downsample)
                     for rgb in demosaicked]), meta


def best_fit_affine(x: np.ndarray, y: np.ndarray, axis):
    """Least-squares a, b with a * x + b ~= y (reference
    raw_utils.py:342-352)."""
    x_m = x.mean(axis=axis)
    y_m = y.mean(axis=axis)
    xy_m = (x * y).mean(axis=axis)
    xx_m = (x * x).mean(axis=axis)
    a = (xy_m - x_m * y_m) / (xx_m - x_m * x_m)
    b = y_m - a * x_m
    return a, b


def match_images_affine(est: np.ndarray, gt: np.ndarray,
                        axis=(0, 1)) -> np.ndarray:
    """Affine-match a (noisy) estimate to ground truth for metrics: fit
    gt -> est, then invert (reference raw_utils.py:354-360)."""
    a, b = best_fit_affine(gt, est, axis=axis)
    return (est - b) / a
