"""Validation-split drop-mask visualization (counterpart of
`nerf_lidar_tpu/raydrop/val_vis.py`).

Rewrite of NeRF_Lidar_code/src/drop_samples/drop_rays_val.py:14-202: for
each held-out range-image frame, reconstruct the point cloud under
  raw        every simulated return (no drop mask)
  gt         the real sensor's return pattern (GT mask)
  pred       the U-Net's learned drop mask (prob > threshold)
and dump each as a .obj for side-by-side inspection, plus per-frame mask
accuracy (the number drop_rays_val prints at :54) and the aggregate
IoU/precision/recall metrics.

The reference back-projects through LaserScan's retained proj_xyz buffer;
this framework's training set is the features .npy alone (range channel +
GT range), so the clouds are reconstructed analytically from the range
image via `range_image.unproject_grid` — geometrically the same pixels.
The split is re-derived with the trainer's own RNG convention
(trainer.fit: permutation(seed), first val_fraction), so `--features` +
the fit seed reproduce exactly the frames the early-stop validated on.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from ..lidar import export as export_lib
from ..lidar import range_image as ri
from .trainer import RayDropState, RayDropTrainer


def val_indices(n: int, val_fraction: float, seed: int = 0) -> np.ndarray:
    """The exact held-out indices trainer.fit(seed=seed) used."""
    perm = np.random.RandomState(seed).permutation(n)
    n_val = max(1, int(n * val_fraction)) if n > 1 else 0
    return perm[:n_val]


def dump_val_masks(trainer: RayDropTrainer, state: RayDropState,
                   data: Dict[str, np.ndarray], out_dir: str,
                   threshold: float = 0.5, seed: int = 0,
                   max_frames: int = 0) -> Dict[str, float]:
    """Write raw/gt/pred .obj triples for every val frame; returns the
    aggregate metrics (also persisted to <out_dir>/val_vis.json)."""
    images, masks, ranges = data["images"], data["masks"], data["ranges"]
    idx = val_indices(images.shape[0], trainer.cfg.val_fraction, seed)
    if max_frames:
        idx = idx[:max_frames]
    os.makedirs(out_dir, exist_ok=True)
    accs = []
    for i in idx:
        prob = trainer.predict_prob(state, images[i:i + 1])[0]
        pred = prob > threshold
        gt = masks[i] == 1
        sim_valid = images[i][..., 0] > 0
        accs.append(float((pred == gt).mean()))
        xyz = ri.unproject_grid(ri.denormalize_range(images[i][..., 0]))
        export_lib.write_obj(os.path.join(out_dir, f"raw_{i:04d}.obj"),
                             xyz[sim_valid])
        export_lib.write_obj(os.path.join(out_dir, f"gt_{i:04d}.obj"),
                             xyz[gt & sim_valid])
        export_lib.write_obj(os.path.join(out_dir, f"pred_{i:04d}.obj"),
                             xyz[pred & sim_valid])
        # The real sweep as the sensor saw it (GT range + GT mask) — the
        # reference's `lidar_{}.obj` comparison dump (:118-124).
        gt_xyz = ri.unproject_grid(ri.denormalize_range(ranges[i]))
        export_lib.write_obj(os.path.join(out_dir, f"real_{i:04d}.obj"),
                             gt_xyz[gt])
    metrics = trainer.evaluate(state, images[idx], masks[idx], ranges[idx],
                               threshold=threshold)
    metrics["acc_mean"] = float(np.mean(accs)) if accs else 0.0
    metrics["frames"] = [int(i) for i in idx]
    with open(os.path.join(out_dir, "val_vis.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    return metrics
