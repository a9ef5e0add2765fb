"""Self-supervised pretraining of the VGG feature pyramid on range images
(counterpart of `nerf_lidar_tpu/raydrop/pretrain.py`).

The reference's perceptual loss uses torchvision's ImageNet-pretrained
VGG19; with no weights to download, the same `Vgg19Features` encoder is
pretrained on range images with a masked-reconstruction objective (corrupt
-> encode -> decode -> L1 to clean). The result drops into
`vgg.vgg_loss_map`, and is saved / loaded as a Flax-layout `.npz` that the
JAX package's `pretrain.load_vgg_npz` reads too.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import vgg as vgg_lib
from .unet import init_flax_default_, resize_bilinear


class _Decoder(nn.Module):
    """Reconstruct the clean range image from the 4-level feature pyramid."""

    def __init__(self, feat_channels=(64, 128, 256, 512)):
        super().__init__()
        self.lat = nn.ModuleList(nn.Conv2d(c, 32, 1) for c in feat_channels)
        self.mix = nn.Conv2d(32 * len(feat_channels), 64, 3, padding=1)
        self.out = nn.Conv2d(64, 1, 1)

    def forward(self, feats: List[torch.Tensor], h: int, w: int):
        ups = [resize_bilinear(lat(f), (h, w))
               for lat, f in zip(self.lat, feats)]
        x = F.relu(torch.cat(ups, dim=1))
        x = F.relu(self.mix(x))
        return self.out(x)[:, 0]


def _corrupt(img: torch.Tensor, generator: Optional[torch.Generator] = None,
             n_holes: int = 6, hole_h: int = 8, hole_w: int = 96,
             noise: float = 0.02) -> torch.Tensor:
    """Random rectangular dropouts + Gaussian noise on [N, H, W] ranges,
    drawn from `generator` (on the image's device)."""
    n, h, w = img.shape
    dev = img.device
    ys = torch.randint(0, max(h - hole_h, 1), (n, n_holes), device=dev,
                       generator=generator)
    xs = torch.randint(0, max(w - hole_w, 1), (n, n_holes), device=dev,
                       generator=generator)
    yy = torch.arange(h, device=dev)[None, :, None, None]
    xx = torch.arange(w, device=dev)[None, None, :, None]
    ys, xs = ys[:, None, None, :], xs[:, None, None, :]
    in_hole = ((yy >= ys) & (yy < ys + hole_h)
               & (xx >= xs) & (xx < xs + hole_w))
    keep = ~in_hole.any(-1)
    eps = torch.randn(img.shape, device=dev, generator=generator)
    return torch.where(keep, img + noise * eps, torch.zeros_like(img))


def pretrain_vgg(range_images: np.ndarray, steps: int = 300,
                 batch_size: int = 4, lr: float = 1e-3, seed: int = 0,
                 device="cpu") -> Tuple[vgg_lib.Vgg19Features, Dict]:
    """Train Vgg19Features on [N, H, W] normalized range images.

    Returns (the frozen encoder, usable with vgg.vgg_loss_map; a history
    dict of (step, loss) pairs).
    """
    dev = torch.device(device)
    imgs = torch.as_tensor(np.asarray(range_images, np.float32), device=dev)
    n, h, w = imgs.shape
    g = torch.Generator().manual_seed(seed)
    enc = init_flax_default_(vgg_lib.Vgg19Features(), g).to(dev)
    dec = init_flax_default_(_Decoder(), g).to(dev)
    params = list(enc.parameters()) + list(dec.parameters())
    opt = torch.optim.Adam(params, lr=lr, eps=1e-8)
    dgen = torch.Generator(device=dev).manual_seed(seed + 1)

    hist = []
    for i in range(steps):
        sel = torch.randint(0, n, (batch_size,), device=dev, generator=dgen)
        clean = imgs[sel]
        x = _corrupt(clean, dgen)
        rec = dec(enc(x[:, None].expand(-1, 3, h, w)), h, w)
        loss = (rec - clean).abs().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if (i + 1) % 50 == 0 or i == 0:
            hist.append((i + 1, float(loss)))
    return vgg_lib.freeze(enc), {"loss": hist}


def save_vgg_npz(path: str, vgg: vgg_lib.Vgg19Features) -> None:
    """Save the encoder as a flat Flax-layout .npz ({s0_c0.kernel
    [kh, kw, in, out], s0_c0.bias, ...})."""
    flat = {}
    for name in vgg_lib.conv_names():
        conv = vgg.convs[name]
        flat[f"{name}.kernel"] = conv.weight.detach().cpu().numpy(
        ).transpose(2, 3, 1, 0)
        flat[f"{name}.bias"] = conv.bias.detach().cpu().numpy()
    np.savez(path, **flat)


def load_vgg_npz(path: str, device="cpu") -> vgg_lib.Vgg19Features:
    """Load an encoder saved by save_vgg_npz (here or by the JAX package)."""
    return vgg_lib.load_vgg19(path, device)
