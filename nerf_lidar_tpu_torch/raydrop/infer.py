"""Ray-drop inference: turn rendered sweeps into realistic labeled clouds
(counterpart of `nerf_lidar_tpu/raydrop/infer.py`; host numpy around the
trainer's U-Net).

Rewrite of NeRF_Lidar_code/src/drop_simulation_rays.py:24-164: build the
6-channel features from a rendered sweep, run the U-Net, threshold the keep
probability at 0.5 (with an optional car-median rule), AND with the
projection mask and depth filter, back-project surviving pixels, then drop
sky points (class 10) and road outliers below z = -3, and export
SemanticKITTI .bin/.label files.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..lidar import export as export_lib
from . import features as feat_lib
from .trainer import RayDropState, RayDropTrainer

SKY_CLASS = 10
CAR_CLASS = 13
ROAD_Z_MIN = -3.0
KEEP_THRESHOLD = 0.5


def drop_sweep(trainer: RayDropTrainer, state: RayDropState,
               points: np.ndarray, semantic: np.ndarray, rgb: np.ndarray,
               intensity: Optional[np.ndarray] = None,
               h: int = 32, w: int = 1024,
               threshold: float = KEEP_THRESHOLD,
               car_median_rule: bool = False) -> Dict[str, np.ndarray]:
    """points/semantic/rgb: one rendered sweep in the sensor frame.

    Returns dict(points [M, 3], labels [M], intensity [M], keep_prob
    [H, W], keep_mask [H, W]).
    """
    sim = feat_lib.simulated_sweep_features(points, semantic, rgb, h=h, w=w)
    feats = sim["features"][None]  # [1, H, W, 6]
    prob = trainer.predict_prob(state, feats)[0]  # [H, W]

    keep = prob > threshold
    labels_img = sim["proj"].semantic.astype(np.int32)
    if car_median_rule:
        # Cars keep rays above the per-image median car probability
        # (drop_simulation_rays.py:100-106, used when placing new cars).
        car_pix = labels_img == CAR_CLASS
        if car_pix.sum() > 0:
            med = np.median(prob[car_pix])
            keep = np.where(car_pix, prob > med, keep)

    keep &= sim["proj"].mask > 0
    # Drop sky and deep road outliers (drop_simulation_rays.py:157-164).
    xyz = sim["proj"].xyz
    keep &= labels_img != SKY_CLASS
    keep &= xyz[..., 2] >= ROAD_Z_MIN

    out_points = xyz[keep]
    out_labels = labels_img[keep]
    out_rgb = sim["proj"].rgb[keep]
    if intensity is not None:
        ii = feat_lib.ri.project_points(
            points, semantic=intensity, h=h, w=w).semantic
        out_intensity = ii[keep].astype(np.float32)
    else:
        out_intensity = out_rgb.mean(-1)
    return dict(points=out_points, labels=out_labels,
                intensity=out_intensity, keep_prob=prob,
                keep_mask=keep.astype(np.float32))


def drop_and_export(trainer: RayDropTrainer, state: RayDropState,
                    sweeps, out_dir: str, **kw) -> int:
    """sweeps: iterable of (points, semantic, rgb[, intensity]) sensor-frame
    tuples. Writes velodyne/.bin + labels/.label per sweep; returns count."""
    count = 0
    for i, sweep in enumerate(sweeps):
        points, semantic, rgb = sweep[:3]
        intensity = sweep[3] if len(sweep) > 3 else None
        out = drop_sweep(trainer, state, points, semantic, rgb, intensity,
                         **kw)
        export_lib.write_bin_label(out_dir, i, out["points"], out["labels"],
                                   out["intensity"])
        count += 1
    return count
