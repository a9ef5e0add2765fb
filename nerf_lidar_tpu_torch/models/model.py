"""Scene model: hierarchical proposal sampling + ZipNeRF field, with
dynamic objects (port of `nerf_lidar_tpu/models/model.py:Model.__call__`).

The level loop is the reference's: ray warps, per-level dilation, anneal,
resampling (jittered in training), `cast_rays`, the level's MLP (the NeRF
MLP with the ray's GLO vector), the dynamic objects composited into the
level's predictions (`models/objects.py`: per-ray poses from the tracks at
the ray's timestamp; a static sample budget in training only), the RawNeRF
exposure scaling, the background (constant, or uniform in
`bg_intensity_range` per ray and channel in training and its midpoint
without a generator), compositing (the normals too). With `fused_final`
the final level of an inference call with a constant background
composites through `ops/render_fused.fused_composite` (kernel K1 on CUDA
tensors), objects included; K1 composites no normals, as the JAX fused
kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs import ModelConfig
from ..ops import coord, mathx, render, render_fused, stepfun
from . import objects as objlib
from .mlp import ZipMLP


def _bias(x, s):
    """Schlick's bias (annealing schedule)."""
    return (s * x) / ((s - 1) * x + 1)


class Embed(nn.Embedding):
    """nn.Embedding whose table starts uninitialised, as `Dense`: the
    model's `init_weights` or a converted state dict fills it (Flax
    `nn.Embed`, parameter `embedding` -> `weight`)."""

    def reset_parameters(self) -> None:
        pass


def class_slots(obj_class_ids) -> Dict[int, List[int]]:
    """{class id: [slots]} from the static per-slot class list."""
    out: Dict[int, List[int]] = {}
    for slot, k in enumerate(obj_class_ids):
        out.setdefault(int(k), []).append(slot)
    return out


class Model(nn.Module):
    """With `num_glo_features` > 0 the model holds one GLO vector per
    camera (`glo_vecs`), with `learned_exposure_scaling` an RGB scaling
    offset per exposure (`exposure_scaling_offsets`); with `instance_obj`
    and `num_objects` > 0 the object MLP (`obj_mlp`), or one per object
    class (`obj_mlp_cls{k}`, with the class id as its fixed semantic
    class), and with `latent_size` > 0 one latent per object slot
    (`obj_latents`): the Flax parameter names."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.nerf_mlp = ZipMLP(cfg.nerf_mlp, cfg.use_viewdirs, device=device,
                               glo_width=cfg.num_glo_features)
        self.prop_mlps = nn.ModuleList(
            ZipMLP(cfg.prop_mlp_for_level(i), cfg.use_viewdirs, device=device)
            for i in range(len(cfg.num_prop_samples)))
        if cfg.num_glo_features > 0:
            self.glo_vecs = Embed(cfg.num_glo_embeddings,
                                  cfg.num_glo_features, device=device)
        if cfg.learned_exposure_scaling:
            self.exposure_scaling_offsets = Embed(cfg.num_glo_embeddings, 3,
                                                  device=device)
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
        """Seeded fresh init of every MLP (see `ZipMLP.init_weights`), of
        the GLO vectors (normal, std 1 / sqrt(features): Flax's embedding
        init), the exposure offsets (zeros) and the object latents
        (normal, std 1, as Flax draws them)."""
        self.nerf_mlp.init_weights(generator)
        for mlp in (*self.prop_mlps, *self.obj_mlps()):
            mlp.init_weights(generator)
        if self.cfg.num_glo_features > 0:
            cpu = torch.empty(self.glo_vecs.weight.shape)
            cpu.normal_(0.0, self.cfg.num_glo_features ** -0.5,
                        generator=generator)
            self.glo_vecs.weight.copy_(cpu)
        if self.cfg.learned_exposure_scaling:
            self.exposure_scaling_offsets.weight.zero_()
        if self.obj_latents is not None:
            cpu = torch.empty(self.obj_latents.shape)
            cpu.normal_(0.0, 1.0, generator=generator)
            self.obj_latents.copy_(cpu)

    def _exposed(self, rgb: torch.Tensor, batch) -> torch.Tensor:
        """Per-sample colours [R, S, 3] at the rays' exposure (RawNeRF):
        times exposure_values, and with learned exposure scaling times 1 +
        the offset of exposure_idx, for indices > 0 (index 0 is the
        anchor)."""
        rgb = rgb * batch["exposure_values"][..., None, :]
        if self.cfg.learned_exposure_scaling and "exposure_idx" in batch:
            idx = batch["exposure_idx"][..., 0].long()
            scaling = 1.0 + (idx > 0).to(rgb.dtype)[..., None] * \
                self.exposure_scaling_offsets(idx)
            rgb = rgb * scaling[..., None, :]
        return rgb

    def _composite_objects(self, ray_results, tdist, batch, obj_pose,
                           track_mask, is_prop: bool, train: bool,
                           use_kernels: bool, mesh=None):
        """The level's predictions with the objects composited in. The
        sample budget applies in training only: a render chunk is
        contiguous rays, one near object can cover more than any fixed
        share of it, and the overflow would fall back to the field. Under
        a data mesh the budget is the global batch's."""
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
            rs = int(np.prod(pts_w.shape[:-1])) * (
                1 if mesh is None else mesh.data_size)
            budget = min(rs, int(-(-rs * c.obj_sample_frac // 128)) * 128)
        return objlib.composite_objects(
            None if groups else self.obj_mlp, self.obj_latents, pts_w,
            batch["viewdirs"], obj_pose, track_mask, ray_results,
            is_prop=is_prop, sym=c.symmetrize and train and not is_prop,
            class_groups=groups,
            obj_sem_ids=getattr(self, "obj_sem_ids", None),
            sample_budget=budget, use_kernels=use_kernels, mesh=mesh)

    def forward(self, batch: Dict[str, torch.Tensor], train_frac: float = 1.0,
                fused_final: bool = False, use_kernels: bool = True,
                train: bool = False, compute_extras: bool = False,
                generator: Optional[torch.Generator] = None,
                tracks: Optional[torch.Tensor] = None,
                track_mask: Optional[torch.Tensor] = None, mesh=None,
                zero_glo: bool = True
                ) -> Tuple[List[Dict[str, torch.Tensor]],
                           List[Dict[str, torch.Tensor]]]:
        """Render a batch of rays.

        batch: dict of [R, ...] tensors: origins, directions, viewdirs,
          radii [R,1], base_x, base_y, near [R,1], far [R,1]; timestamp
          [R] for dynamic objects; cam_idx [R,1] (int) for the GLO vectors
          (read unless `zero_glo`, which gives every ray the zero vector,
          as the JAX inference calls do); exposure_values [R,3] (and
          exposure_idx [R,1], int, with learned exposure scaling): every
          level's colours scaled by the view's exposure, and by 1 + the
          learned offset of its exposure index where that index is > 0.
        tracks: [num_objects, T, 9] padded track tensor (see
          `models/objects.py`) and track_mask [num_objects] its valid
          slots; without tracks (or timestamps) no object is composited.
        fused_final: composite the final level with `fused_composite`
          (never when `train`: K1 has no backward, and the reference trains
          through the plain chain; nor with `compute_extras`, whose
          statistics K1 does not compute).
        compute_extras: every level's rendering also holds acc,
          distance_mean and the distance percentiles
          (`render.volumetric_rendering`).
        use_kernels: False sends the hash encode and the fused composite to
          their plain torch versions on every device (for comparisons).
        generator: the randomness of training (sample jitter, spiral phase,
          MLP noise, a random background), on the batch's device, or a
          `mathx.ShardedGenerator` (one data shard's rows of the global
          batch's draws); None is the JAX `key=None`.
        mesh: a `parallel.DataMesh` when the batch is a data-parallel
          rank's rows of the global batch (training): the objects' sample
          budget, its stats and the symmetry term are then the global
          batch's (`models/objects.py`).
        Returns (renderings, ray_history): one dict per level each; the
        history holds the level's sdist, weights and tdist (and obj_mask,
        normals, normals_pred) for the losses; a level whose MLP makes
        normals composites them into its rendering. With objects each
        rendering has "obj_mask" [R, S]
        (samples in a box), the final one "loss_sym" when symmetrised, and
        in training the final one also "obj_overflow" (summed over levels)
        and "obj_hit_frac" (the largest over levels).
        """
        c = self.cfg
        glo_vec = None
        if c.num_glo_features > 0:
            glo_vec = (self.glo_vecs(batch["cam_idx"][..., 0].long())
                       if not zero_glo else batch["origins"].new_zeros(
                           batch["origins"].shape[:-1]
                           + (c.num_glo_features,)))
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
        lo, hi = (float(v) for v in c.bg_intensity_range)
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
                use_kernels=use_kernels, generator=generator,
                glo_vec=None if is_prop else glo_vec)
            if use_obj:
                ray_results = self._composite_objects(
                    ray_results, tdist, batch, obj_pose, track_mask,
                    is_prop, train, use_kernels, mesh)
            if "exposure_values" in batch:
                ray_results["rgb"] = self._exposed(ray_results["rgb"], batch)

            if lo == hi:
                bg = lo
            elif generator is None:
                bg = (lo + hi) / 2
            else:
                bg = lo + (hi - lo) * mathx.random_rows(
                    torch.rand, batch["near"].shape[:-1] + (3,), generator,
                    device=batch["near"].device)
            is_final = not is_prop
            sem = ray_results["semantic"] if (is_final and c.use_semantic) \
                else None
            intensity = (ray_results["intensity"]
                         if (is_final and c.use_intensity) else None)
            normals = {k: ray_results[k] for k in ("normals", "normals_pred")
                       if k in ray_results}
            if fused_final and is_final and not train and \
                    not compute_extras and isinstance(bg, float):
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
                    intensity=intensity, sem_detach=c.sem_detach,
                    t_far=batch["far"], compute_extras=compute_extras,
                    extras=normals)

            history = dict(sdist=sdist, weights=weights, tdist=tdist,
                           **normals)
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
