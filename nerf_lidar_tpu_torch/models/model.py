"""Scene model: hierarchical proposal sampling + ZipNeRF field (port of
`nerf_lidar_tpu/models/model.py:Model.__call__` for a static scene: no
dynamic objects, no GLO, no exposure, constant background).

The level loop is the reference's: ray warps, per-level dilation, anneal,
resampling (jittered in training), `cast_rays`, the level's MLP,
compositing. With `fused_final` the final level of an inference call
composites through `ops/render_fused.fused_composite` (kernel K1 on CUDA
tensors).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs import ModelConfig
from ..ops import coord, render, render_fused, stepfun
from .mlp import ZipMLP


def _bias(x, s):
    """Schlick's bias (annealing schedule)."""
    return (s * x) / ((s - 1) * x + 1)


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError on any scene-level feature not ported."""
    if cfg.instance_obj and cfg.num_objects > 0:
        raise NotImplementedError("dynamic objects (num_objects > 0) are "
                                  "not ported yet")
    if cfg.num_glo_features > 0:
        raise NotImplementedError("GLO embeddings are not ported")
    if cfg.learned_exposure_scaling:
        raise NotImplementedError("learned exposure scaling is not ported")
    if cfg.bg_intensity_range[0] != cfg.bg_intensity_range[1]:
        raise NotImplementedError("a non-constant background is not ported")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.nerf_mlp = ZipMLP(cfg.nerf_mlp, cfg.use_viewdirs, device=device)
        self.prop_mlps = nn.ModuleList(
            ZipMLP(cfg.prop_mlp_for_level(i), cfg.use_viewdirs, device=device)
            for i in range(len(cfg.num_prop_samples)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded fresh init of every MLP (see `ZipMLP.init_weights`)."""
        self.nerf_mlp.init_weights(generator)
        for mlp in self.prop_mlps:
            mlp.init_weights(generator)

    def forward(self, batch: Dict[str, torch.Tensor], train_frac: float = 1.0,
                fused_final: bool = False, use_kernels: bool = True,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[List[Dict[str, torch.Tensor]],
                           List[Dict[str, torch.Tensor]]]:
        """Render a batch of rays.

        batch: dict of [R, ...] tensors: origins, directions, viewdirs,
          radii [R,1], base_x, base_y, near [R,1], far [R,1].
        fused_final: composite the final level with `fused_composite`
          (never when `train`: K1 has no backward, and the reference trains
          through the plain chain).
        use_kernels: False sends the hash encode and the fused composite to
          their plain torch versions on every device (for comparisons).
        generator: the randomness of training (sample jitter, spiral phase,
          MLP noise), on the batch's device; None is the JAX `key=None`.
        Returns (renderings, ray_history): one dict per level each; the
        history holds the level's sdist, weights and tdist for the losses.
        """
        c = self.cfg
        _, s_to_t = coord.construct_ray_warps(
            c.raydist_fn, batch["near"], batch["far"], c.power_lambda)
        if c.near_anneal_rate is None:
            init_s_near = 0.0
        else:
            init_s_near = float(np.clip(
                1 - train_frac / c.near_anneal_rate, 0, c.near_anneal_init))
        init_s_far = 1.0
        sdist = torch.cat([torch.full_like(batch["near"], init_s_near),
                           torch.full_like(batch["far"], init_s_far)], dim=-1)
        weights = torch.ones_like(batch["near"])
        prod_num_samples = 1
        bg = float(c.bg_intensity_range[0])

        renderings, ray_history = [], []
        for i_level in range(c.num_levels):
            is_prop = i_level < c.num_levels - 1
            num_samples = (c.num_prop_samples[i_level] if is_prop
                           else c.num_nerf_samples)
            dilation = (c.dilation_bias + c.dilation_multiplier
                        * (init_s_far - init_s_near) / prod_num_samples)
            prod_num_samples *= num_samples
            use_dilation = c.dilation_bias > 0 or c.dilation_multiplier > 0
            if i_level > 0 and use_dilation:
                sdist, weights = stepfun.max_dilate_weights(
                    sdist, weights, dilation,
                    domain=(init_s_near, init_s_far), renormalize=True)
                sdist = sdist[..., 1:-1]
                weights = weights[..., 1:-1]

            anneal = (_bias(train_frac, c.anneal_slope)
                      if c.anneal_slope > 0 else 1.0)
            logits_resample = torch.where(
                sdist[..., 1:] > sdist[..., :-1],
                anneal * torch.log(weights + c.resample_padding),
                torch.full_like(weights, -math.inf))
            # One generator serves the level's sampling, spiral phase and MLP
            # noise in that order, as the JAX key splits three ways.
            sdist = stepfun.sample_intervals(
                sdist, logits_resample, num_samples,
                domain=(init_s_near, init_s_far), generator=generator,
                single_jitter=c.single_jitter)
            if c.stop_level_grad:
                sdist = sdist.detach()
            tdist = s_to_t(sdist)

            means, stds = render.cast_rays(
                tdist, batch["origins"], batch["directions"],
                batch["base_x"], batch["base_y"], batch["radii"],
                n=c.sample_n, m=c.sample_m, std_scale=c.std_scale,
                generator=generator)
            mlp = self.prop_mlps[i_level] if is_prop else self.nerf_mlp
            ray_results = mlp(
                means, stds,
                viewdirs=batch["viewdirs"] if c.use_viewdirs else None,
                use_kernels=use_kernels, generator=generator)

            is_final = not is_prop
            sem = ray_results["semantic"] if (is_final and c.use_semantic) \
                else None
            intensity = (ray_results["intensity"]
                         if (is_final and c.use_intensity) else None)
            if fused_final and is_final and not train:
                composite = (render_fused.fused_composite if use_kernels
                             else render_fused.fused_composite_plain)
                rendering = composite(
                    ray_results["density"], tdist, batch["directions"],
                    ray_results["rgb"], semantic=sem,
                    intensity=None if intensity is None else intensity[..., 0],
                    opaque_background=c.opaque_background, bg_value=bg)
                weights = rendering.pop("weights")
                rendering.pop("acc")
            else:
                weights, _, _ = render.compute_alpha_weights(
                    ray_results["density"], tdist, batch["directions"],
                    opaque_background=c.opaque_background)
                rendering = render.volumetric_rendering(
                    ray_results["rgb"], weights, tdist, bg, semantic=sem,
                    intensity=intensity, sem_detach=c.sem_detach)

            renderings.append(rendering)
            ray_history.append(dict(sdist=sdist, weights=weights,
                                    tdist=tdist))
        return renderings, ray_history
