# Copy of pixels_to_bayer_mask from nerf_lidar_tpu/utils/raw.py, the one
# function of that module the port's batcher uses (apply_bayer_mask).
"""RawNeRF helpers the port's data layer needs (numpy)."""

from __future__ import annotations

import numpy as np


def pixels_to_bayer_mask(pix_x: np.ndarray, pix_y: np.ndarray) -> np.ndarray:
    """Binary RGB mask of which channel each RGGB-mosaic pixel observes
    (reference raw_utils.py:38-46; used as a per-ray lossmult so training
    only supervises observed channels)."""
    r = (pix_x % 2 == 0) & (pix_y % 2 == 0)
    g = ((pix_x % 2) != (pix_y % 2))
    b = (pix_x % 2 == 1) & (pix_y % 2 == 1)
    return np.stack([r, g, b], axis=-1).astype(np.float32)
