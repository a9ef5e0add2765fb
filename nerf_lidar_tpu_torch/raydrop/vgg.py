"""VGG19-slice perceptual loss for range images (counterpart of
`nerf_lidar_tpu/raydrop/vgg.py`), on NCHW tensors.

VGG19's conv trunk from conv1_1 to relu4_1 (the reference's relu1_1 ..
relu4_1 feature pyramid), written out by hand: neither torchvision nor any
other model zoo is needed. Weights: a fixed seeded init by default, a
torchvision `features.N.weight` state dict (`.pth`, or the `.npz` the JAX
package's converter writes), or the Flax-layout `.npz` of
`pretrain.save_vgg_npz` (`load_vgg19`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .unet import init_flax_default_, resize_bilinear

# VGG19 feature config up to relu4_1: (out_channels, pool_before) per conv.
_SLICES = [
    [(64, False)],                         # slice1: conv1_1 -> relu1_1
    [(64, False), (128, True)],            # slice2: conv1_2, pool, conv2_1
    [(128, False), (256, True)],           # slice3: conv2_2, pool, conv3_1
    [(256, False), (256, False), (256, False), (512, True)],  # slice4
]
_WEIGHTS = [1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0]
# torchvision's `features` indices of the convs above, in order: conv1_1
# .. conv3_4 and conv4_1 (19). The JAX package's `load_torch_vgg19_npz`
# stops at 16, so its tree lacks conv4_1 and the Flax module refuses it.
TORCHVISION_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19]


def conv_names() -> List[str]:
    """The convs' names, `s{slice}_c{conv}` as the Flax module names them."""
    return [f"s{si}_c{ci}" for si, convs in enumerate(_SLICES)
            for ci, _ in enumerate(convs)]


class Vgg19Features(nn.Module):
    """[N, 3, H, W] -> the 4 feature maps [relu1_1, relu2_1, relu3_1,
    relu4_1]."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleDict()
        self._plan = []
        cin = 3
        for si, convs in enumerate(_SLICES):
            for ci, (ch, pool_before) in enumerate(convs):
                name = f"s{si}_c{ci}"
                self.convs[name] = nn.Conv2d(cin, ch, 3, padding=1)
                self._plan.append((si, name, pool_before))
                cin = ch

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        for i, (si, name, pool_before) in enumerate(self._plan):
            if pool_before:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(self.convs[name](x))
            if i + 1 == len(self._plan) or self._plan[i + 1][0] != si:
                outs.append(x)
        return outs


def init_vgg(generator: Optional[torch.Generator] = None,
             device="cpu") -> Vgg19Features:
    """A frozen VGG trunk with Flax's default init drawn from `generator`."""
    model = init_flax_default_(Vgg19Features(), generator)
    return freeze(model.to(device))


def freeze(model: nn.Module) -> nn.Module:
    """A loss network: eval mode, no parameter takes a gradient."""
    return model.eval().requires_grad_(False)


def torchvision_state_dict(sd: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """A torchvision VGG19 state dict (`features.N.weight/bias`, OIHW; a
    `module.` prefix is dropped) -> the state dict of `Vgg19Features`."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    out = {}
    for name, idx in zip(conv_names(), TORCHVISION_CONV_IDX):
        out[f"convs.{name}.weight"] = torch.as_tensor(
            np.asarray(sd[f"features.{idx}.weight"], np.float32))
        out[f"convs.{name}.bias"] = torch.as_tensor(
            np.asarray(sd[f"features.{idx}.bias"], np.float32))
    return out


def flax_layout_state_dict(flat: Dict[str, np.ndarray]
                           ) -> Dict[str, torch.Tensor]:
    """The `{s0_c0.kernel [kh, kw, in, out], s0_c0.bias}` arrays of
    `pretrain.save_vgg_npz` -> the state dict of `Vgg19Features`."""
    out = {}
    for name in conv_names():
        out[f"convs.{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(flat[f"{name}.kernel"], np.float32).transpose(
                3, 2, 0, 1)))
        out[f"convs.{name}.bias"] = torch.from_numpy(
            np.asarray(flat[f"{name}.bias"], np.float32))
    return out


def load_vgg19(path: str, device="cpu") -> Vgg19Features:
    """A frozen VGG trunk from a torchvision VGG19 `.pth`, its `.npz`
    (`features.N.*`, as `convert_vgg` writes) or the Flax-layout `.npz` of
    `pretrain.save_vgg_npz`."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            raw = {k: z[k] for k in z.files}
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(raw, "state_dict"):
            raw = raw.state_dict()
    if any(k.startswith(("features.", "module.features.")) for k in raw):
        sd = torchvision_state_dict(raw)
    else:
        sd = flax_layout_state_dict(raw)
    model = Vgg19Features()
    model.load_state_dict(sd)
    return freeze(model.to(device))


def vgg_loss_map(model: Vgg19Features, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """Per-pixel multi-scale L1 feature distance (VGG.py:16-38).

    x, y: [N, H, W] single-channel range images (broadcast to 3ch).
    Returns [N, H, W] loss map; y's features take no gradient.
    """
    n, h, w = x.shape
    fx = model(x[:, None].expand(n, 3, h, w))
    with torch.no_grad():
        fy = model(y[:, None].expand(n, 3, h, w))
    loss = torch.zeros((n, h, w), dtype=x.dtype, device=x.device)
    for i in range(len(fx) - 1):
        a, b = fx[i], fy[i]
        if i > 0:
            a = resize_bilinear(a, (h, w))
            b = resize_bilinear(b, (h, w))
        loss = loss + _WEIGHTS[i] * (a - b).abs().mean(1)
    return loss
