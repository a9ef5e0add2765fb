"""U-Net ray-drop network on NCHW tensors (counterpart of
`nerf_lidar_tpu/raydrop/unet.py`).

The classic 4-down / 4-up U-Net at the published widths 64-128-256-512-1024:
DoubleConv (3x3 conv -> BN -> ReLU, twice), max-pool downs, transposed-conv
(or bilinear) ups with skip concatenation, a 1x1 head of `n_classes` logits
and an optional sigmoid range head.

Two places where torch's defaults differ from Flax's, both matched here:
- `nn.ConvTranspose` (Flax, `transpose_kernel=False`) is torch's
  `conv_transpose2d` with the kernel flipped in both spatial axes; the flip
  lives in `convert.py`, the module is a plain `nn.ConvTranspose2d`.
- `nn.BatchNorm(momentum=0.9)` keeps 0.9 of the running statistics and
  updates the running variance with the *biased* batch variance;
  `FlaxBatchNorm2d` does the same (torch's `BatchNorm2d` would use the
  unbiased one).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Flax nn.BatchNorm's defaults.
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose train-mode call normalises with the batch statistics
    and moves the running ones as Flax does: ra = m * ra + (1 - m) * batch,
    with the biased batch variance. Eval mode uses the running statistics."""

    def __init__(self, num_features: int, momentum: float = BN_MOMENTUM):
        super().__init__(num_features, eps=BN_EPS)
        self.flax_momentum = momentum

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


@functools.lru_cache(maxsize=32)
def _resize_matrix(n_out: int, n_in: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """[n_out, n_in] weights of torch's bilinear resize along one axis
    (align_corners=False): output i reads (i + 0.5) * n_in / n_out - 0.5,
    clamped at 0, from its two neighbours. Built once per shape and
    device; shared, do not modify it."""
    src = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out)
           - 0.5).clamp(min=0.0)
    i0 = src.floor().long().clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    lam = src - i0
    rows = torch.arange(n_out)
    m = torch.zeros((n_out, n_in), dtype=torch.float64)
    m.index_put_((rows, i0), 1.0 - lam, accumulate=True)
    m.index_put_((rows, i1), lam, accumulate=True)
    return m.to(dtype=dtype, device=device)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`F.interpolate(x, size, mode="bilinear", align_corners=False)` of
    [N, C, H, W], as a product with two fixed interpolation matrices,
    whose backward is a product too: F.interpolate's CUDA backward sums
    with atomics, and torch refuses it under its deterministic
    algorithms."""
    mh = _resize_matrix(size[0], x.shape[2], x.dtype, x.device)
    mw = _resize_matrix(size[1], x.shape[3], x.dtype, x.device)
    return torch.matmul(torch.matmul(mh, x), mw.t())


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    """Flax's default kernel init: a normal truncated at two deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
        weight.mul_(std)
    return weight


def init_flax_default_(module: nn.Module,
                       generator: Optional[torch.Generator] = None):
    """Every conv of `module` as Flax initialises it (kernels lecun-normal
    over kh * kw * in, biases zero), every BatchNorm scale 1 and bias 0."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = m.kernel_size
            cin = m.in_channels
            lecun_normal_(m.weight, kh * kw * cin, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return module


class DoubleConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, mid_ch: Optional[int] = None):
        super().__init__()
        mid = mid_ch or out_ch
        self.conv1 = nn.Conv2d(in_ch, mid, 3, padding=1, bias=False)
        self.bn1 = FlaxBatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, out_ch, 3, padding=1, bias=False)
        self.bn2 = FlaxBatchNorm2d(out_ch)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class Down(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x):
        return self.conv(F.max_pool2d(x, 2, 2))


class Up(nn.Module):
    """x1 (the coarser map, `in_ch` channels) upsampled by 2, padded to the
    skip map x2 (`skip_ch` channels), concatenated after it, then a
    DoubleConv to `out_ch`."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int,
                 bilinear: bool = False):
        super().__init__()
        self.bilinear = bilinear
        if bilinear:
            self.up = DoubleConv(in_ch, out_ch, mid_ch=in_ch // 2)
            up_ch = out_ch
        else:
            self.up = nn.ConvTranspose2d(in_ch, in_ch // 2, 2, stride=2)
            up_ch = in_ch // 2
        self.conv = DoubleConv(skip_ch + up_ch, out_ch)

    def forward(self, x1, x2):
        if self.bilinear:
            x1 = resize_bilinear(x1, (x1.shape[2] * 2, x1.shape[3] * 2))
        up = self.up(x1)
        # Pad to match the skip connection (odd sizes).
        dh = x2.shape[2] - up.shape[2]
        dw = x2.shape[3] - up.shape[3]
        up = F.pad(up, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2, up], dim=1))


class UNet(nn.Module):
    """in: [N, n_channels, H, W]; out: [N, n_classes, H, W] logits (and,
    with `regression`, a [N, 1, H, W] sigmoid range)."""

    def __init__(self, n_channels: int = 6, n_classes: int = 2,
                 bilinear: bool = False, regression: bool = False):
        super().__init__()
        self.n_channels, self.n_classes = n_channels, n_classes
        self.bilinear, self.regression = bilinear, regression
        f = 2 if bilinear else 1
        self.inc = DoubleConv(n_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 1024 // f)
        self.up1 = Up(1024 // f, 512, 512 // f, bilinear)
        self.up2 = Up(512 // f, 256, 256 // f, bilinear)
        self.up3 = Up(256 // f, 128, 128 // f, bilinear)
        self.up4 = Up(128 // f, 64, 64, bilinear)
        self.outc = nn.Conv2d(64, n_classes, 1)
        self.regc = nn.Conv2d(64, 1, 1) if regression else None

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        logits = self.outc(y)
        if not self.regression:
            return logits
        return logits, torch.sigmoid(self.regc(y))
