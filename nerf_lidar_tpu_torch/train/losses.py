"""Loss stack (port of `nerf_lidar_tpu/train/losses.py`).

Every loss is a masked mean over static shapes, as in the JAX package, so
the two compare term by term. Batch masks (from `data/batching.py`):
rgb_mask, depth_mask, sem_mask, lidar_mask, patch_mask, loss_mask.
With dynamic objects: the object tables' hash decay (unless
`obj_nodecay`), the latent regulariser, the symmetry term after
`sym_start`, and the proposal loss leaves object-covered samples out; the
budget's `_obj_overflow` / `_obj_hit_frac` ride along as stats.

Terms the port does not compute raise NotImplementedError when their
multipliers are non-zero: orientation, predicted normals and normal
supervision.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..configs import Config
from ..ops import grid as gridlib
from ..ops import mathx, stepfun


def check_ported(config: Config) -> None:
    """Raise NotImplementedError on a loss term this port does not compute."""
    unported = dict(
        orientation_loss_mult=config.orientation_loss_mult,
        orientation_coarse_loss_mult=config.orientation_coarse_loss_mult,
        predicted_normal_loss_mult=config.predicted_normal_loss_mult,
        predicted_normal_coarse_loss_mult=(
            config.predicted_normal_coarse_loss_mult),
        normal_supervision=config.normal_supervision)
    for name, value in unported.items():
        if value:
            raise NotImplementedError(f"{name}={value!r}: this loss term is "
                                      "not ported")
    if config.data_loss_type not in ("charb", "mse"):
        raise NotImplementedError(
            f"data_loss_type={config.data_loss_type!r} is not ported")


def _masked_mean(x, mask):
    mask = mask.to(x.dtype)
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_quantile(x, mask, q: float):
    """Quantile of x over mask entries: sort with the masked-out entries at
    the float maximum and index at q * (n_valid - 1), as the JAX version."""
    big = torch.finfo(x.dtype).max
    svals = torch.sort(torch.where(mask, x, big).reshape(-1)).values
    n_valid = mask.sum().to(torch.float32)
    idx = torch.clamp((q * (n_valid - 1)).to(torch.int64), 0,
                      svals.shape[0] - 1)
    return svals[idx]


def data_loss(batch, renderings, config: Config):
    """Charbonnier or MSE photometric loss over every level; returns (loss,
    [levels] MSEs for the PSNR stat)."""
    lossmult = batch["rgb_mask"][..., None].to(torch.float32).expand(
        batch["rgb"][..., :3].shape)
    if "lossmult" in batch:
        lossmult = lossmult * batch["lossmult"]
    denom = torch.clamp(lossmult.sum(), min=1.0)
    losses: List[torch.Tensor] = []
    mses: List[torch.Tensor] = []
    for rendering in renderings:
        resid_sq = (rendering["rgb"] - batch["rgb"][..., :3]) ** 2
        mses.append((lossmult * resid_sq).sum() / denom)
        if config.data_loss_type == "mse":
            dl = resid_sq
        else:
            dl = torch.sqrt(resid_sq + config.charb_padding**2)
        losses.append((lossmult * dl).sum() / denom)
    loss = (config.data_coarse_loss_mult * sum(losses[:-1])
            + config.data_loss_mult * losses[-1])
    return loss, torch.stack(mses)


def _schedule(step: int, config: Config, lo: float, hi: float) -> float:
    """The depth / semantic weight: lo until end_step, hi after; with pose
    refinement 0 inside (start_step, 0.6 end_step)."""
    if config.pose_refine and config.start_step < step < int(
            0.6 * config.end_step):
        return 0.0
    return hi if step > config.end_step else lo


def depth_loss(batch, renderings, config: Config, step: int):
    """log-L1 depth loss on rays below the 0.9 quantile of the error."""
    mask = batch["depth_mask"]
    abs_dist = torch.abs(renderings[-1]["depth"] - batch["depth"])
    thresh = masked_quantile(abs_dist.detach(), mask, 0.9)
    gated = mask & (abs_dist < thresh)
    loss = _masked_mean(torch.log(abs_dist + 1.0), gated)
    return config.depth_loss_mult * _schedule(step, config, 0.1, 0.4) * loss


def semantic_loss(batch, renderings, config: Config, step: int):
    """NLL over composited class probabilities."""
    sem = renderings[-1]["semantic"]
    labels = torch.clamp(batch["semantic"].long(), 0, sem.shape[-1] - 1)
    logp = torch.log(torch.gather(sem, -1, labels[..., None])[..., 0]
                     + 1e-6)
    loss = -_masked_mean(logp, batch["sem_mask"])
    m = config.semantic_loss_mult
    return _schedule(step, config, 0.2 * m, 0.8 * m) * loss


def intensity_loss(batch, renderings, config: Config):
    """MSE on LiDAR-return intensity."""
    pred = renderings[-1]["intensity"].reshape(-1)
    target = batch["intensity"].reshape(-1)
    mask = batch["lidar_mask"].reshape(-1)
    return 0.1 * config.intensity_loss_mult * _masked_mean(
        (pred - target) ** 2, mask)


def anti_interlevel_loss(ray_history, config: Config):
    """ZipNeRF anti-aliased interlevel loss."""
    last = ray_history[-1]
    c = last["sdist"].detach()
    w = last["weights"].detach()
    w_normalize = torch.clamp(w / (c[..., 1:] - c[..., :-1] + 1e-12),
                              max=10.0)
    loss_total = 0.0
    for i, ray_results in enumerate(ray_history[:-1]):
        cp = ray_results["sdist"]
        wp = ray_results["weights"]
        c_, w_ = stepfun.blur_stepfun(c, w_normalize, config.pulse_width[i])
        area = 0.5 * (w_[..., 1:] + w_[..., :-1]) * (c_[..., 1:]
                                                     - c_[..., :-1])
        cdf = torch.cat([torch.zeros_like(area[..., :1]),
                         torch.cumsum(area, dim=-1)], dim=-1)
        cdf_interp = mathx.sorted_interp_quad(cp, c_, w_, cdf)
        w_s = torch.diff(cdf_interp, dim=-1)
        per = torch.clamp(w_s - wp, min=0) ** 2 / (wp + 1e-5)
        if "obj_mask" in ray_results:
            # Object-covered samples take no proposal supervision.
            loss = _masked_mean(per, ~ray_results["obj_mask"].any(-1))
        else:
            loss = per.mean()
        loss_total = loss_total + loss
    return config.anti_interlevel_loss_mult * loss_total


def distortion_loss(ray_history, config: Config):
    last = ray_history[-1]
    return config.distortion_loss_mult * stepfun.lossfun_distortion(
        last["sdist"], last["weights"]).mean()


def hash_decay_loss(model, config: Config, use_kernels: bool = True):
    """Per-level mean of squared hash embeddings, summed over the grids
    (the object grids too, unless `obj_nodecay`).

    The per-level sum is a segment sum over the rows' level ids: kernel K3
    (`grid.scatter_add_rows`) on CUDA tables, `index_add` otherwise."""
    scatter = (gridlib.scatter_add_rows if use_kernels
               else gridlib.scatter_add_rows_plain)
    mlps = [model.nerf_mlp, *model.prop_mlps]
    if not config.obj_nodecay:
        mlps += model.obj_mlps()
    loss = 0.0
    for mlp in mlps:
        spec, table = mlp.spec, mlp.table
        sums = scatter(gridlib.level_ids(spec, table.device), table**2,
                       spec.num_levels)
        counts = torch.tensor(spec.rows_per_level, dtype=torch.float32,
                              device=table.device)[:, None]
        loss = loss + (sums / counts).mean()
    return config.hash_decay_mults * loss


def latent_reg(model, config: Config):
    """L2 regulariser on the per-object latents (0 without them)."""
    if model.obj_latents is None:
        return model.nerf_mlp.table.new_zeros(())
    return config.latent_reg * (model.obj_latents**2).mean()


def edge_aware_smoothness(rgb, disp, mask):
    """Edge-aware first-order smoothness over [P, ps, ps(, C)] patches."""
    disp = disp / (disp.mean(dim=(1, 2), keepdim=True) + 1e-7)
    gx = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
    gy = torch.abs(disp[:, :-1, :] - disp[:, 1:, :])
    if gx.ndim == 4:  # channelled quantity (semantic): sum channels
        gx = gx.sum(-1)
        gy = gy.sum(-1)
    rx = torch.abs(rgb[:, :, :-1] - rgb[:, :, 1:]).mean(-1)
    ry = torch.abs(rgb[:, :-1, :] - rgb[:, 1:, :]).mean(-1)
    mx = mask[:, :, :-1] * mask[:, :, 1:]
    my = mask[:, :-1, :] * mask[:, 1:, :]
    return (_masked_mean(gx * torch.exp(-rx), mx)
            + _masked_mean(gy * torch.exp(-ry), my))


def smoothness_losses(batch, renderings, config: Config,
                      num_patch_rays: int = 0):
    """Depth / semantic smoothness on the patch rays: the first
    num_patch_rays rays of the batch are [P, ps, ps] row-major patches."""
    ps = config.patch_size
    if ps <= 1 or num_patch_rays <= 0 or "loss_mask" not in batch:
        return {}
    shape = (num_patch_rays // (ps * ps), ps, ps)
    n = shape[0] * ps * ps
    mask = batch["loss_mask"][:n].reshape(shape).to(torch.float32)
    rgb = batch["rgb"][:n].reshape(shape + (-1,))
    dep = renderings[-1]["depth"][:n].reshape(shape)
    out = {"d_smo": 0.01 * edge_aware_smoothness(rgb, dep, mask)}
    if config.model.use_semantic:
        sem = renderings[-1]["semantic"][:n].reshape(shape + (-1,))
        out["s_smo"] = 0.01 * edge_aware_smoothness(rgb, sem, mask)
    return out


def compute_losses(model, batch, renderings, ray_history, config: Config,
                   step: int, num_patch_rays: int = 0,
                   use_kernels: bool = True) -> Dict[str, torch.Tensor]:
    """The loss dict; keys starting with '_' are stats, not losses."""
    check_ported(config)
    losses: Dict[str, torch.Tensor] = {}
    losses["data"], losses["_mses"] = data_loss(batch, renderings, config)
    for stat in ("obj_overflow", "obj_hit_frac"):
        if stat in renderings[-1]:
            losses[f"_{stat}"] = renderings[-1][stat]
    if config.depth_loss and "depth" in batch:
        losses["depth"] = depth_loss(batch, renderings, config, step)
    if config.model.use_semantic and "semantic" in batch:
        losses["sem"] = semantic_loss(batch, renderings, config, step)
    if config.model.use_intensity and "intensity" in batch:
        losses["int"] = intensity_loss(batch, renderings, config)
    if config.anti_interlevel_loss_mult > 0:
        losses["interlevel"] = anti_interlevel_loss(ray_history, config)
    if config.distortion_loss_mult > 0:
        losses["distortion"] = distortion_loss(ray_history, config)
    if config.hash_decay_mults > 0:
        losses["hash_decay"] = hash_decay_loss(model, config, use_kernels)
    if config.model.latent_size > 0:
        losses["latent_reg"] = latent_reg(model, config)
    if config.model.symmetrize and "loss_sym" in renderings[-1]:
        losses["sym"] = (config.sym_loss * renderings[-1]["loss_sym"]
                         if step > config.sym_start
                         else renderings[-1]["loss_sym"].new_zeros(()))
    losses.update(smoothness_losses(batch, renderings, config,
                                    num_patch_rays=num_patch_rays))
    return losses


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(v for k, v in losses.items() if not k.startswith("_"))
