"""Darknet-53 (rangenet) multi-scale feature loss for range images
(counterpart of `nerf_lidar_tpu/raydrop/darknet.py`), on NCHW tensors.

The encoder of rangenet's Darknet-53: a 3x3 stem, then five stages that
downsample the azimuth (width) axis only, by 2 each, followed by 1, 2, 8, 8
and 4 residual blocks. Its modules carry rangenet's own names (`conv1`,
`bn1`, `enc{1..5}.conv`, `enc{k}.bn`, `enc{k}.residual_{i}.{conv1,bn1,conv2,
bn2}`), so a rangenet `backbone` state dict loads as it is
(`load_rangenet`).

Two details that keep it equal to the Flax module:
- the width-only downsample is a SAME-padded 3x3 conv of stride (1, 2):
  XLA pads an even width by (0, 1) and the height by (1, 1), which torch's
  symmetric `padding=1` would shift by a column; `_same_pad` pads as XLA
  does and the conv runs unpadded;
- BatchNorm always uses the running statistics (the loss network is never
  trained): `FrozenBatchNorm2d` ignores train mode.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..lidar import range_image as ri
from .unet import BN_EPS, init_flax_default_
from .vgg import freeze

# Residual-block counts per encoder stage (darknet.py:40-43, layers=53).
_BLOCKS_53 = (1, 2, 8, 8, 4)
_STAGE_CH = ((32, 64), (64, 128), (128, 256), (256, 512), (512, 1024))
# Multi-scale MSE weights (darknet.py:225-226: [1/16,1/16,1/8,1/4,1/2,1]/2).
_WEIGHTS = (1 / 32, 1 / 32, 1 / 16, 1 / 8, 1 / 4, 1 / 2)
# SemanticKITTI HDL-64 sensor stats [range, x, y, z]
# (darknet53-1024px_noremission.yaml img_means/img_stds).
_MEANS = np.array([12.12, 10.88, 0.23, -1.04], np.float32)
_STDS = np.array([12.32, 11.47, 6.91, 0.86], np.float32)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm that normalises with its running statistics in either
    mode (Flax `use_running_average=True`)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _same_pad(x, kernel: Tuple[int, int], stride: Tuple[int, int]):
    """Pad [N, C, H, W] as XLA's SAME does: the total in each axis is what
    ceil(size / stride) outputs need, the extra one on the high side."""
    pads = []
    for size, k, s in zip(x.shape[2:], kernel, stride):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    (ht, hb), (wl, wr) = pads
    return F.pad(x, (wl, wr, ht, hb))


class _Residual(nn.Module):
    """1x1-reduce + 3x3 residual block (darknet.py BasicBlock)."""

    def __init__(self, planes: Tuple[int, int]):
        super().__init__()
        self.conv1 = nn.Conv2d(planes[1], planes[0], 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes[0])
        self.conv2 = nn.Conv2d(planes[0], planes[1], 3, padding=1,
                               bias=False)
        self.bn2 = FrozenBatchNorm2d(planes[1])

    def forward(self, x):
        r = x
        x = F.leaky_relu(self.bn1(self.conv1(x)), 0.1)
        x = F.leaky_relu(self.bn2(self.conv2(x)), 0.1)
        return x + r


class _Stage(nn.Module):
    """Width-only downsample (reference stride=[1, 2]), then the blocks."""

    def __init__(self, cin: int, planes: Tuple[int, int], blocks: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, planes[1], 3, stride=(1, 2), bias=False)
        self.bn = FrozenBatchNorm2d(planes[1])
        for bi in range(blocks):
            self.add_module(f"residual_{bi}", _Residual(planes))
        self.blocks = blocks

    def forward(self, x):
        x = self.conv(_same_pad(x, (3, 3), (1, 2)))
        x = F.leaky_relu(self.bn(x), 0.1)
        for bi in range(self.blocks):
            x = getattr(self, f"residual_{bi}")(x)
        return x


class DarknetBackbone(nn.Module):
    """Darknet-53 encoder, [N, 4, H, W] -> the 6-level feature pyramid
    (darknet.py:158-196 forward with return_features=True)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(4, 32, 3, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm2d(32)
        cin = 32
        for si, (planes, blocks) in enumerate(zip(_STAGE_CH, _BLOCKS_53)):
            self.add_module(f"enc{si + 1}", _Stage(cin, planes, blocks))
            cin = planes[1]

    def forward(self, x) -> List[torch.Tensor]:
        x = F.leaky_relu(self.bn1(self.conv1(x)), 0.1)
        feats = [x]
        for si in range(len(_BLOCKS_53)):
            x = getattr(self, f"enc{si + 1}")(x)
            feats.append(x)
        return feats


def init_darknet(generator: Optional[torch.Generator] = None,
                 device="cpu") -> DarknetBackbone:
    """A frozen Darknet-53 with Flax's default init drawn from `generator`
    (BatchNorm at mean 0, variance 1)."""
    return freeze(init_flax_default_(DarknetBackbone(), generator)
                  .to(device))


def rangenet_state_dict(sd: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """A rangenet `backbone` state dict (or the `.npz` of it): drops a
    `module.` prefix and `num_batches_tracked`, keeps float32 tensors."""
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k.endswith("num_batches_tracked"):
            continue
        out[k] = torch.as_tensor(np.asarray(v, np.float32))
    return out


def load_rangenet(path: str, device="cpu") -> DarknetBackbone:
    """A frozen Darknet-53 from a rangenet `backbone` checkpoint (`.pth`)
    or its `.npz` (as `convert_rangenet` writes)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            raw = {k: z[k] for k in z.files}
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(raw, "state_dict"):
            raw = raw.state_dict()
    model = DarknetBackbone()
    model.load_state_dict(rangenet_state_dict(raw))
    return freeze(model.to(device))


def _pixel_dirs(h: int, w: int) -> np.ndarray:
    """Unit ray direction at every range-image pixel center — the inverse
    of lidar/range_image.py's (yaw, pitch) projection."""
    px = (np.arange(w, dtype=np.float32) + 0.5) / w
    py = (np.arange(h, dtype=np.float32) + 0.5) / h
    yaw = -(2.0 * px - 1.0) * np.pi  # [W]
    fov_up = ri.FOV_UP_DEG / 180.0 * np.pi
    fov_down = ri.FOV_DOWN_DEG / 180.0 * np.pi
    fov = abs(fov_down) + abs(fov_up)
    pitch = (1.0 - py) * fov - abs(fov_down)  # [H]
    cp = np.cos(pitch)[:, None]
    return np.stack([cp * np.cos(yaw)[None],
                     cp * np.sin(yaw)[None],
                     np.broadcast_to(np.sin(pitch)[:, None], (h, w))],
                    axis=-1).astype(np.float32)


def feature_loss(model: DarknetBackbone, sim_range: torch.Tensor,
                 gt_range: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Multi-scale darknet feature MSE (darknet.py FeatureLoss.forward).

    sim_range/gt_range: [N, H, W] log2-normalized ranges; mask: [N, H, W]
    keep-probability applied to the sim input (the Gumbel-hard mask in the
    trainer). xyz channels are reconstructed from the metric range on the
    pixel-center ray grid; gt features take no gradient.
    """
    n, h, w = sim_range.shape
    dev, dt = sim_range.device, sim_range.dtype
    dirs = torch.from_numpy(_pixel_dirs(h, w)).to(dev, dt).permute(2, 0, 1)
    means = torch.from_numpy(_MEANS).to(dev, dt)[None, :, None, None]
    stds = torch.from_numpy(_STDS).to(dev, dt)[None, :, None, None]

    def stack(r_norm):
        r_metric = torch.exp2(r_norm * ri.RANGE_LOG_NORM) - 1.0
        xyz = r_metric[:, None] * dirs[None]
        return torch.cat([r_norm[:, None], xyz], dim=1)

    x = (stack(sim_range) * mask[:, None] - means) / stds
    fx = model(x)
    with torch.no_grad():
        fy = model((stack(gt_range) - means) / stds)
    loss = 0.0
    for wgt, a, b in zip(_WEIGHTS, fx, fy):
        loss = loss + wgt * ((a - b) ** 2).mean()
    return loss
