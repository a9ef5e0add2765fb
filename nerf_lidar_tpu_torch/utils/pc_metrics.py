"""Point-cloud and semantic-segmentation metrics (port of
`nerf_lidar_tpu/utils/pc_metrics.py`).

- per-class IoU / mIoU from a confusion matrix: numpy copies of the JAX
  package's host functions;
- Chamfer distance between point clouds: blocked brute-force nearest
  neighbours on a torch device, exact differences (no `|a|^2 + |b|^2 - 2ab`
  expansion, whose float32 cancellation at coordinates of 50-100 m puts
  centimetres of error on centimetre distances).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def confusion_matrix(pred: np.ndarray, gt: np.ndarray, num_classes: int,
                     ignore_label: int = 255) -> np.ndarray:
    valid = gt != ignore_label
    pred = pred[valid].astype(np.int64)
    gt = gt[valid].astype(np.int64)
    idx = gt * num_classes + pred
    cm = np.bincount(idx, minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes)


def iou_from_confusion(cm: np.ndarray) -> Tuple[np.ndarray, float]:
    """Per-class IoU (NaN for absent classes) and mIoU over present ones."""
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    denom = tp + fp + fn
    iou = np.where(denom > 0, tp / np.maximum(denom, 1), np.nan)
    miou = float(np.nanmean(iou)) if np.isfinite(iou).any() else float("nan")
    return iou, miou


def eval_miou(pred: np.ndarray, gt: np.ndarray, num_classes: int = 19,
              ignore_label: int = 255,
              class_names: Optional[list] = None) -> Dict:
    cm = confusion_matrix(pred, gt, num_classes, ignore_label)
    iou, miou = iou_from_confusion(cm)
    out = {"miou": miou}
    for i, v in enumerate(iou):
        name = class_names[i] if class_names else f"class_{i}"
        if np.isfinite(v):
            out[f"iou_{name}"] = float(v)
    return out


# Bytes of the two [block, M] float32 buffers of one block: 1 GiB keeps a
# block of a 10^6-point cloud at 134 rows and fits any card.
BLOCK_BUDGET_BYTES = 1 << 30


def block_rows(m: int) -> int:
    """Rows of `a` per block against M points of `b`: two [block, M]
    float32 buffers within `BLOCK_BUDGET_BYTES`."""
    return max(1, BLOCK_BUDGET_BYTES // (8 * max(m, 1)))


def min_dists_sq(a: torch.Tensor, b: torch.Tensor,
                 block: Optional[int] = None) -> torch.Tensor:
    """Min squared distance from each point of a [N, 3] to the set b [M, 3],
    block rows of `a` at a time. The largest intermediates are two
    [block, M] buffers: the squared x difference, onto which y's and z's
    squares are added in place (the JAX version's `((blk[:, None] -
    b[None]) ** 2).sum(-1)` would hold [block, M, 3] in eager torch). Seven
    passes over [block, M] per block: the work is bound by memory."""
    block = block or block_rows(b.shape[0])
    out = torch.empty(a.shape[0], dtype=a.dtype, device=a.device)
    bt = b.t().contiguous()  # [3, M]: each coordinate a contiguous row
    d = t = None
    for i in range(0, a.shape[0], block):
        blk = a[i:i + block]
        n = blk.shape[0]
        if d is None or d.shape[0] != n:
            d = torch.empty(n, b.shape[0], dtype=a.dtype, device=a.device)
            t = torch.empty_like(d)
        torch.sub(blk[:, 0:1], bt[0], out=d).square_()
        for c in (1, 2):
            torch.sub(blk[:, c:c + 1], bt[c], out=t)
            d.addcmul_(t, t)
        torch.amin(d, dim=1, out=out[i:i + n])
    return out


def chamfer_distance(a, b, device=None, block: Optional[int] = None
                     ) -> Dict[str, float]:
    """Symmetric Chamfer (mean nearest-neighbour distance each way) of two
    [N, 3] / [M, 3] clouds (numpy or tensors), in float32 on `device`
    (default: a's device; numpy: the CPU). The means are summed in float64.
    `block`: rows per block (default from `block_rows`)."""
    def prep(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.asarray(x, np.float32))
        return t.to(device=device, dtype=torch.float32)

    a = prep(a)
    if device is None:
        device = a.device
    b = prep(b)
    d_ab = float(min_dists_sq(a, b, block).sqrt().double().mean())
    d_ba = float(min_dists_sq(b, a, block).sqrt().double().mean())
    return {"chamfer": 0.5 * (d_ab + d_ba), "chamfer_a_to_b": d_ab,
            "chamfer_b_to_a": d_ba}
