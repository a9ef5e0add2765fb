"""Image metrics and colour tools (port of `nerf_lidar_tpu/utils/image.py`).

PSNR / SSIM of the eval loop on the tensors' device, the quadratic colour
correction on the host in float64, sRGB transforms and the host area
downsample. Metrics take torch tensors or numpy arrays ([H, W, C] images)
and compute in float32, as the JAX functions do.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _tensor(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x, np.float32))
    return t.to(device=device, dtype=torch.float32)


def downsample_area(img: np.ndarray, factor: int) -> np.ndarray:
    """Host-side area-average downsample of an [H, W, C] image by an
    integer factor."""
    if factor <= 1:
        return img
    h = img.shape[0] // factor * factor
    w = img.shape[1] // factor * factor
    img = img[:h, :w].reshape(h // factor, factor, w // factor, factor,
                              img.shape[-1])
    return img.mean(axis=(1, 3))


def mse_to_psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 / math.log(10.0) * torch.log(mse)


def psnr(img0, img1) -> torch.Tensor:
    """PSNR of two images in [0, 1], on img0's device (numpy: the CPU)."""
    a = _tensor(img0)
    return mse_to_psnr(((a - _tensor(img1, a.device)) ** 2).mean())


def linear_to_srgb(linear: torch.Tensor, eps: float = 1e-10):
    srgb0 = 323 / 25 * linear
    srgb1 = (211 * torch.clamp(linear, min=eps) ** (5 / 12) - 11) / 200
    return torch.where(linear <= 0.0031308, srgb0, srgb1)


def srgb_to_linear(srgb: torch.Tensor, eps: float = 1e-10):
    linear0 = 25 / 323 * srgb
    linear1 = torch.clamp((200 * srgb + 11) / 211, min=eps) ** (12 / 5)
    return torch.where(srgb <= 0.04045, linear0, linear1)


def ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03
         ) -> torch.Tensor:
    """SSIM with a Gaussian window over [H, W, C] images: a separable
    depthwise conv2d ('valid', over H then W) on img0's device. The filter
    is symmetric, so the correlation equals the JAX `convolve`. TF32 is off
    inside: a cuDNN convolution takes TF32 by default, about three digits."""
    a = _tensor(img0)
    b = _tensor(img1, a.device)
    c = a.shape[-1]
    shift = torch.arange(-(filter_size // 2), filter_size // 2 + 1,
                         dtype=torch.float32)
    f = torch.exp(-0.5 * (shift / filter_sigma) ** 2)
    f = (f / f.sum()).to(a.device)
    f_h = f.view(1, 1, -1, 1).expand(c, 1, -1, 1)
    f_w = f.view(1, 1, 1, -1).expand(c, 1, 1, -1)

    def blur(x):
        x = x.permute(2, 0, 1)[None]  # [1, C, H, W]
        x = F.conv2d(F.conv2d(x, f_h, groups=c), f_w, groups=c)
        return x[0].permute(1, 2, 0)

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        mu0, mu1 = blur(a), blur(b)
        mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
        sigma00 = blur(a ** 2) - mu00
        sigma11 = blur(b ** 2) - mu11
        sigma01 = blur(a * b) - mu01
    sigma00 = torch.clamp(sigma00, min=0.0)
    sigma11 = torch.clamp(sigma11, min=0.0)
    sigma01 = torch.sign(sigma01) * torch.minimum(
        torch.sqrt(sigma00 * sigma11), sigma01.abs())
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    return (numer / denom).mean()


def color_correct(img, ref, num_iters: int = 5, eps: float = 0.5 / 255):
    """Warp `img`'s colours onto `ref` with a per-channel quadratic fit,
    solved per channel with lstsq, on the host in float64: the JAX package
    found the ~HW x 10 normal system ill-conditioned in float32 (a float32
    solve put its psnr_cc 12 dB below the raw PSNR). Returns float32 numpy.
    """
    img = np.asarray(img.cpu() if isinstance(img, torch.Tensor) else img,
                     np.float64)
    ref = np.asarray(ref.cpu() if isinstance(ref, torch.Tensor) else ref,
                     np.float64)
    if img.shape[-1] != ref.shape[-1]:
        raise ValueError(
            f"img's {img.shape[-1]} and ref's {ref.shape[-1]} channels differ")
    num_channels = img.shape[-1]
    img_mat = img.reshape([-1, num_channels])
    ref_mat = ref.reshape([-1, num_channels])

    def is_unclipped(z):
        return (z >= eps) & (z <= 1 - eps)

    mask0 = is_unclipped(img_mat)
    for _ in range(num_iters):
        # Quadratic features: x, x*x cross terms, 1.
        a_mat = []
        for c in range(num_channels):
            a_mat.append(img_mat[:, c:c + 1] * img_mat[:, c:])
        a_mat.append(img_mat)
        a_mat.append(np.ones_like(img_mat[:, :1]))
        a_mat = np.concatenate(a_mat, axis=-1)
        warp = []
        for c in range(num_channels):
            b = ref_mat[:, c]
            mask = mask0[:, c] & is_unclipped(img_mat[:, c]) & is_unclipped(b)
            ma_mat = np.where(mask[:, None], a_mat, 0)
            mb = np.where(mask, b, 0)
            w = np.linalg.lstsq(ma_mat, mb, rcond=-1)[0]
            assert np.all(np.isfinite(w)), "color_correct: non-finite warp"
            warp.append(w)
        warp = np.stack(warp, axis=-1)
        img_mat = np.clip(a_mat @ warp, 0, 1)
    return img_mat.reshape(img.shape).astype(np.float32)


class MetricHarness:
    """PSNR + SSIM bundle."""

    def __call__(self, rgb_pred, rgb_gt, name_suffix: str = ""):
        return {
            "psnr" + name_suffix: float(psnr(rgb_pred, rgb_gt)),
            "ssim" + name_suffix: float(ssim(rgb_pred, rgb_gt)),
        }
