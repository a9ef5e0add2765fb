"""Scene model: hierarchical proposal sampling + ZipNeRF field, with
dynamic objects (port of `nerf_lidar_tpu/models/model.py:Model.__call__`;
no GLO, no exposure, constant background).

The level loop is the reference's: ray warps, per-level dilation, anneal,
resampling (jittered in training), `cast_rays`, the level's MLP, the
dynamic objects composited into the level's predictions
(`models/objects.py`: per-ray poses from the tracks at the ray's
timestamp; a static sample budget in training only), compositing. With
`fused_final` the final level of an inference call composites through
`ops/render_fused.fused_composite` (kernel K1 on CUDA tensors), objects
included.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs import ModelConfig
from ..ops import coord, render, render_fused, stepfun
from . import objects as objlib
from .mlp import ZipMLP


def _bias(x, s):
    """Schlick's bias (annealing schedule)."""
    return (s * x) / ((s - 1) * x + 1)


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError on any scene-level feature not ported."""
    if cfg.num_glo_features > 0:
        raise NotImplementedError("GLO embeddings are not ported")
    if cfg.learned_exposure_scaling:
        raise NotImplementedError("learned exposure scaling is not ported")
    if cfg.bg_intensity_range[0] != cfg.bg_intensity_range[1]:
        raise NotImplementedError("a non-constant background is not ported")


def class_slots(obj_class_ids) -> Dict[int, List[int]]:
    """{class id: [slots]} from the static per-slot class list."""
    out: Dict[int, List[int]] = {}
    for slot, k in enumerate(obj_class_ids):
        out.setdefault(int(k), []).append(slot)
    return out


class Model(nn.Module):
    """With `instance_obj` and `num_objects` > 0 the model holds the object
    MLP (`obj_mlp`), or one per object class (`obj_mlp_cls{k}`, with the
    class id as its fixed semantic class), and with `latent_size` > 0 one
    latent per object slot (`obj_latents`): the Flax parameter names."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.nerf_mlp = ZipMLP(cfg.nerf_mlp, cfg.use_viewdirs, device=device)
        self.prop_mlps = nn.ModuleList(
            ZipMLP(cfg.prop_mlp_for_level(i), cfg.use_viewdirs, device=device)
            for i in range(len(cfg.num_prop_samples)))
        self.register_parameter("obj_latents", None)
        if not self.has_objects:
            return
        if cfg.obj_sem_ids and cfg.obj_mlp.fixed_semantic:
            # On the device once: a tensor made from the tuple at every
            # level would copy from the host and wait for the stream.
            self.register_buffer("obj_sem_ids", torch.tensor(
                cfg.obj_sem_ids, dtype=torch.long, device=device),
                persistent=False)
        lat = cfg.latent_size
        if cfg.obj_class_ids:
            if len(cfg.obj_class_ids) != cfg.num_objects:
                raise ValueError(f"obj_class_ids {cfg.obj_class_ids} must "
                                 f"name {cfg.num_objects} slots")
            for k in class_slots(cfg.obj_class_ids):
                mcfg = (dataclasses.replace(cfg.obj_mlp, class_type=k)
                        if cfg.obj_mlp.fixed_semantic else cfg.obj_mlp)
                setattr(self, f"obj_mlp_cls{k}", ZipMLP(
                    mcfg, device=device, latent_width=lat))
        else:
            self.obj_mlp = ZipMLP(cfg.obj_mlp, device=device,
                                  latent_width=lat)
        if lat > 0:
            self.obj_latents = nn.Parameter(torch.empty(
                (cfg.num_objects, lat), dtype=torch.float32, device=device))

    @property
    def has_objects(self) -> bool:
        return self.cfg.instance_obj and self.cfg.num_objects > 0

    def obj_mlps(self) -> List[ZipMLP]:
        """The object MLPs, shared or per class (in class order)."""
        if not self.has_objects:
            return []
        if self.cfg.obj_class_ids:
            return [getattr(self, f"obj_mlp_cls{k}")
                    for k in sorted(class_slots(self.cfg.obj_class_ids))]
        return [self.obj_mlp]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded fresh init of every MLP (see `ZipMLP.init_weights`) and
        of the object latents (normal, std 1, as Flax draws them)."""
        self.nerf_mlp.init_weights(generator)
        for mlp in (*self.prop_mlps, *self.obj_mlps()):
            mlp.init_weights(generator)
        if self.obj_latents is not None:
            cpu = torch.empty(self.obj_latents.shape)
            cpu.normal_(0.0, 1.0, generator=generator)
            self.obj_latents.copy_(cpu)

    def _composite_objects(self, ray_results, tdist, batch, obj_pose,
                           track_mask, is_prop: bool, train: bool,
                           use_kernels: bool):
        """The level's predictions with the objects composited in. The
        sample budget applies in training only: a render chunk is
        contiguous rays, one near object can cover more than any fixed
        share of it, and the overflow would fall back to the field."""
        c = self.cfg
        t_mids = 0.5 * (tdist[..., :-1] + tdist[..., 1:])
        pts_w = (t_mids[..., None] * batch["directions"][..., None, :]
                 + batch["origins"][..., None, :])
        groups = None
        if c.obj_class_ids:
            groups = [(getattr(self, f"obj_mlp_cls{k}"), tuple(slots))
                      for k, slots in sorted(
                          class_slots(c.obj_class_ids).items())]
        budget = None
        if c.obj_sample_frac > 0 and train:
            rs = int(np.prod(pts_w.shape[:-1]))
            budget = min(rs, int(-(-rs * c.obj_sample_frac // 128)) * 128)
        return objlib.composite_objects(
            None if groups else self.obj_mlp, self.obj_latents, pts_w,
            batch["viewdirs"], obj_pose, track_mask, ray_results,
            is_prop=is_prop, sym=c.symmetrize and train and not is_prop,
            class_groups=groups,
            obj_sem_ids=getattr(self, "obj_sem_ids", None),
            sample_budget=budget, use_kernels=use_kernels)

    def forward(self, batch: Dict[str, torch.Tensor], train_frac: float = 1.0,
                fused_final: bool = False, use_kernels: bool = True,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                tracks: Optional[torch.Tensor] = None,
                track_mask: Optional[torch.Tensor] = None
                ) -> Tuple[List[Dict[str, torch.Tensor]],
                           List[Dict[str, torch.Tensor]]]:
        """Render a batch of rays.

        batch: dict of [R, ...] tensors: origins, directions, viewdirs,
          radii [R,1], base_x, base_y, near [R,1], far [R,1]; timestamp
          [R] for dynamic objects.
        tracks: [num_objects, T, 9] padded track tensor (see
          `models/objects.py`) and track_mask [num_objects] its valid
          slots; without tracks (or timestamps) no object is composited.
        fused_final: composite the final level with `fused_composite`
          (never when `train`: K1 has no backward, and the reference trains
          through the plain chain).
        use_kernels: False sends the hash encode and the fused composite to
          their plain torch versions on every device (for comparisons).
        generator: the randomness of training (sample jitter, spiral phase,
          MLP noise), on the batch's device; None is the JAX `key=None`.
        Returns (renderings, ray_history): one dict per level each; the
        history holds the level's sdist, weights and tdist (and obj_mask)
        for the losses. With objects each rendering has "obj_mask" [R, S]
        (samples in a box), the final one "loss_sym" when symmetrised, and
        in training the final one also "obj_overflow" (summed over levels)
        and "obj_hit_frac" (the largest over levels).
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
        use_obj = (self.has_objects and tracks is not None
                   and "timestamp" in batch)
        obj_pose = (objlib.get_pose(batch["timestamp"], tracks) if use_obj
                    else None)

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
            if use_obj:
                ray_results = self._composite_objects(
                    ray_results, tdist, batch, obj_pose, track_mask,
                    is_prop, train, use_kernels)

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

            history = dict(sdist=sdist, weights=weights, tdist=tdist)
            if use_obj:
                rendering["obj_mask"] = ray_results["obj_mask"].any(-1)
                history["obj_mask"] = ray_results["obj_mask"]
                if "loss_sym" in ray_results:
                    rendering["loss_sym"] = ray_results["loss_sym"]
                if train and "obj_overflow" in ray_results:
                    # Stats of the train step: overflow summed over the
                    # levels, hit share the largest over them.
                    prev = renderings[-1] if renderings else {}
                    rendering["obj_overflow"] = (
                        prev.pop("obj_overflow", 0)
                        + ray_results["obj_overflow"])
                    hit = ray_results["obj_hit_frac"]
                    if "obj_hit_frac" in prev:
                        hit = torch.maximum(prev.pop("obj_hit_frac"), hit)
                    rendering["obj_hit_frac"] = hit
            renderings.append(rendering)
            ray_history.append(history)
        return renderings, ray_history
