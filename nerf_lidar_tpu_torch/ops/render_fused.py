"""Fused final-level compositing (port of the Pallas kernel
`nerf_lidar_tpu/ops/render_pallas.py:fused_composite`).

- `fused_composite_plain`: straightforward torch (the reference chain
  `compute_alpha_weights` + `volumetric_rendering`, plus `acc`);
- `fused_composite`: the wrapper the model calls. A CPU tensor takes the
  plain version; a CUDA tensor launches kernel K1 (`csrc/kernels.cu`,
  `composite`) or raises.

Both return dict(rgb [R,3], depth [R], acc [R], weights [R,S]
[, semantic [R,K]] [, intensity [R]]).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build
from . import render


def fused_composite_plain(density: torch.Tensor, tdist: torch.Tensor,
                          dirs: torch.Tensor, rgb: torch.Tensor,
                          semantic: Optional[torch.Tensor] = None,
                          intensity: Optional[torch.Tensor] = None,
                          opaque_background: bool = True,
                          bg_value: float = 1.0) -> Dict[str, torch.Tensor]:
    """density [R, S]; tdist [R, S+1]; dirs [R, 3]; rgb [R, S, 3];
    semantic [R, S, K] or None; intensity [R, S] or None."""
    weights, _, _ = render.compute_alpha_weights(
        density, tdist, dirs, opaque_background=opaque_background)
    out = render.volumetric_rendering(rgb, weights, tdist, bg_value,
                                      semantic=semantic, intensity=intensity)
    out["acc"] = weights.sum(dim=-1)
    out["weights"] = weights
    return out


def fused_composite(density: torch.Tensor, tdist: torch.Tensor,
                    dirs: torch.Tensor, rgb: torch.Tensor,
                    semantic: Optional[torch.Tensor] = None,
                    intensity: Optional[torch.Tensor] = None,
                    opaque_background: bool = True,
                    bg_value: float = 1.0) -> Dict[str, torch.Tensor]:
    """Same contract as `fused_composite_plain`; CUDA tensors run kernel K1."""
    if density.device.type == "cpu":
        return fused_composite_plain(density, tdist, dirs, rgb, semantic,
                                     intensity, opaque_background, bg_value)
    r, s = density.shape
    k = semantic.shape[-1] if semantic is not None else 0
    density, tdist, dirs, rgb = (t.contiguous()
                                 for t in (density, tdist, dirs, rgb))
    _build.require_cuda("density", density, (r, s))
    _build.require_cuda("tdist", tdist, (r, s + 1))
    _build.require_cuda("dirs", dirs, (r, 3))
    _build.require_cuda("rgb", rgb, (r, s, 3))
    if semantic is not None:
        semantic = semantic.contiguous()
        _build.require_cuda("semantic", semantic, (r, s, k))
    if intensity is not None:
        intensity = intensity.contiguous()
        _build.require_cuda("intensity", intensity, (r, s))

    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=density.device)
    out = dict(rgb=new(r, 3), depth=new(r), acc=new(r), weights=new(r, s))
    if semantic is not None:
        out["semantic"] = new(r, k)
    if intensity is not None:
        out["intensity"] = new(r)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.library()
    rc = lib.nl_composite(
        ptr(density), ptr(tdist), ptr(dirs), ptr(rgb), ptr(semantic),
        ptr(intensity), ptr(out["weights"]), ptr(out["rgb"]),
        ptr(out.get("semantic")), ptr(out.get("intensity")),
        ptr(out["depth"]), ptr(out["acc"]), r, s, k,
        int(opaque_background), float(bg_value), density.device.index,
        _build.stream_of(density))
    _build.check(lib, rc, "composite")
    fused_composite.launches += 1
    return out


fused_composite.launches = 0
