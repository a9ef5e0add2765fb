"""Loss stack (port of `nerf_lidar_tpu/train/losses.py`).

Every loss is a masked mean over static shapes, as in the JAX package, so
the two compare term by term. Batch masks (from `data/batching.py`):
rgb_mask, depth_mask, sem_mask, lidar_mask, patch_mask, loss_mask.
With dynamic objects: the object tables' hash decay (unless
`obj_nodecay`), the latent regulariser, the symmetry term after
`sym_start`, and the proposal loss leaves object-covered samples out; the
budget's `_obj_overflow` / `_obj_hit_frac` ride along as stats.
Ref-NeRF's orientation and predicted-normal terms read every level's
normals from the ray history; normal supervision reads the final level's
composited normals; `data_loss_type='rawnerf'` clips the render at 1 and
weights the residual by the gradient of a log tone curve.

Under a data mesh (`parallel.DataMesh`, `mesh=`) each rank holds its rows
of the global batch, and every term is this rank's share of the global
term: the shares summed over the ranks give the one-process value, and so
do the gradients summed over the ranks (`train_step`). A masked mean
divides the rank's sum by the global count (`_count`), a plain mean and a
parameter-only term divide by the world size (`_share`); the terms that
read the batch as a whole, the depth error's 0.9 quantile and the 32 x 32
smoothness patches (the first `num_patch_rays` rays, which a shard boundary
may cut), run on the global batch's rows (`_global_rows`, one all_gather
with autograd) on every rank, each rank taking 1 / world of them. Ranks
that replicate a data shard (a multi-axis mesh) count it as often in the
counts and in the world size, so the shares still sum to the one-process
value. The objects' symmetry term comes as a share from the model
(`models/objects.py`), and their overflow and hit-share stats, global on
every rank, are shared like a parameter-only term.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..configs import Config
from ..ops import grid as gridlib
from ..ops import mathx, ref_utils, stepfun


def check_ported(config: Config) -> None:
    """Raise NotImplementedError on a data loss neither package has."""
    if config.data_loss_type not in ("charb", "mse", "rawnerf"):
        raise NotImplementedError(config.data_loss_type)


def _count(total, mesh=None):
    """clamp(total, 1) of a count over the batch, summed over the ranks
    under a mesh: the denominator of a masked mean's share."""
    if mesh is not None:
        total = mesh.all_reduce(total.detach().clone())
    return torch.clamp(total, min=1.0)


def _share(term, mesh=None):
    """This rank's share of a term that every rank computes in full (a
    parameter-only term, a term of the global rows), or of a mean over the
    rank's equal-size shard."""
    return term if mesh is None else term / mesh.world


def _masked_mean(x, mask, mesh=None):
    mask = mask.to(x.dtype)
    return (x * mask).sum() / _count(mask.sum(), mesh)


def _global_rows(batch, renderings, config: Config, mesh=None):
    """The per-ray values that the batch-wide terms read (final depth and
    semantic, the batch's depth, depth_mask, rgb and loss_mask), over the
    global batch: under a mesh gathered from every shard in one
    all_gather with autograd, else the rank's own."""
    cols = dict(depth=renderings[-1]["depth"], target=batch.get("depth"),
                depth_mask=batch.get("depth_mask"), rgb=batch["rgb"],
                loss_mask=batch.get("loss_mask"))
    if config.model.use_semantic:
        cols["semantic"] = renderings[-1]["semantic"]
    cols = {k: v for k, v in cols.items() if v is not None}
    if mesh is None:
        return cols
    n = renderings[-1]["depth"].shape[0]
    flat = {k: v.reshape(n, -1) for k, v in cols.items()}
    packed = mesh.all_gather_rows(torch.cat(
        [v.to(torch.float32) for v in flat.values()], dim=1))
    out, i = {}, 0
    for k, v in flat.items():
        part = packed[:, i:i + v.shape[1]]
        i += v.shape[1]
        part = part.reshape((-1,) + cols[k].shape[1:])
        out[k] = part > 0.5 if cols[k].dtype == torch.bool else part
    return out


def masked_quantile(x, mask, q: float):
    """Quantile of x over mask entries: sort with the masked-out entries at
    the float maximum and index at q * (n_valid - 1), as the JAX version."""
    big = torch.finfo(x.dtype).max
    svals = torch.sort(torch.where(mask, x, big).reshape(-1)).values
    n_valid = mask.sum().to(torch.float32)
    idx = torch.clamp((q * (n_valid - 1)).to(torch.int64), 0,
                      svals.shape[0] - 1)
    # A gather, not svals[idx]: indexing by a 0-dim tensor reads it on the
    # host, which waits for the device.
    return svals.gather(0, idx.reshape(1))[0]


def data_loss(batch, renderings, config: Config, mesh=None):
    """Charbonnier, MSE or RawNeRF photometric loss over every level;
    returns (loss, [levels] MSEs for the PSNR stat)."""
    lossmult = batch["rgb_mask"][..., None].to(torch.float32).expand(
        batch["rgb"][..., :3].shape)
    if "lossmult" in batch:
        lossmult = lossmult * batch["lossmult"]
    denom = _count(lossmult.sum(), mesh)
    losses: List[torch.Tensor] = []
    mses: List[torch.Tensor] = []
    for rendering in renderings:
        resid_sq = (rendering["rgb"] - batch["rgb"][..., :3]) ** 2
        mses.append((lossmult * resid_sq).sum() / denom)
        if config.data_loss_type == "mse":
            dl = resid_sq
        elif config.data_loss_type == "charb":
            dl = torch.sqrt(resid_sq + config.charb_padding**2)
        else:
            # RawNeRF: the render clipped at 1 (sensor saturation), the
            # residual weighted by the gradient of the log tone curve so
            # that dark linear-HDR regions count.
            rgb_clip = torch.clamp(rendering["rgb"], max=1.0)
            scaling_grad = 1.0 / (1e-3 + rgb_clip.detach())
            dl = (rgb_clip - batch["rgb"][..., :3]) ** 2 * scaling_grad**2
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


def depth_loss(batch, renderings, config: Config, step: int, rows=None,
               mesh=None):
    """log-L1 depth loss on rays below the 0.9 quantile of the error (over
    `rows`, the global batch's, by default the batch's own)."""
    mask = batch["depth_mask"]
    abs_dist = torch.abs(renderings[-1]["depth"] - batch["depth"])
    rows = rows or _global_rows(batch, renderings, config)
    thresh = masked_quantile(
        torch.abs(rows["depth"] - rows["target"]).detach(),
        rows["depth_mask"], 0.9)
    gated = mask & (abs_dist < thresh)
    loss = _masked_mean(torch.log(abs_dist + 1.0), gated, mesh)
    return config.depth_loss_mult * _schedule(step, config, 0.1, 0.4) * loss


def semantic_loss(batch, renderings, config: Config, step: int,
                  mesh=None):
    """NLL over composited class probabilities."""
    sem = renderings[-1]["semantic"]
    labels = torch.clamp(batch["semantic"].long(), 0, sem.shape[-1] - 1)
    logp = torch.log(torch.gather(sem, -1, labels[..., None])[..., 0]
                     + 1e-6)
    loss = -_masked_mean(logp, batch["sem_mask"], mesh)
    m = config.semantic_loss_mult
    return _schedule(step, config, 0.2 * m, 0.8 * m) * loss


def intensity_loss(batch, renderings, config: Config, mesh=None):
    """MSE on LiDAR-return intensity."""
    pred = renderings[-1]["intensity"].reshape(-1)
    target = batch["intensity"].reshape(-1)
    mask = batch["lidar_mask"].reshape(-1)
    return 0.1 * config.intensity_loss_mult * _masked_mean(
        (pred - target) ** 2, mask, mesh)


def anti_interlevel_loss(ray_history, config: Config, mesh=None):
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
            loss = _masked_mean(per, ~ray_results["obj_mask"].any(-1),
                                mesh)
        else:
            loss = _share(per.mean(), mesh)
        loss_total = loss_total + loss
    return config.anti_interlevel_loss_mult * loss_total


def distortion_loss(ray_history, config: Config, mesh=None):
    last = ray_history[-1]
    return config.distortion_loss_mult * _share(stepfun.lossfun_distortion(
        last["sdist"], last["weights"]).mean(), mesh)


def orientation_loss(batch, ray_history, config: Config, mesh=None):
    """Ref-NeRF orientation loss over the levels whose history holds
    `orientation_loss_target`."""
    total = batch["viewdirs"].new_zeros(())
    for i, rr in enumerate(ray_history):
        n = rr.get(config.orientation_loss_target)
        if n is None:
            continue
        mult = (config.orientation_coarse_loss_mult
                if i < len(ray_history) - 1 else config.orientation_loss_mult)
        total = total + mult * _share(ref_utils.orientation_loss(
            rr["weights"], n, batch["viewdirs"]), mesh)
    return total


def predicted_normal_loss(ray_history, config: Config, mesh=None):
    """Predicted normals against the (detached) density normals, over the
    levels that have both."""
    total = ray_history[-1]["weights"].new_zeros(())
    for i, rr in enumerate(ray_history):
        if rr.get("normals") is None or rr.get("normals_pred") is None:
            continue
        mult = (config.predicted_normal_coarse_loss_mult
                if i < len(ray_history) - 1
                else config.predicted_normal_loss_mult)
        total = total + mult * _share(ref_utils.predicted_normal_loss(
            rr["weights"], rr["normals"].detach(), rr["normals_pred"]), mesh)
    return total


def normal_supervision_loss(batch, renderings, config: Config, mesh=None):
    """Pseudo-normal supervision: L1 + (1 - cos) on non-sky rays (0 without
    rendered or given normals)."""
    if "normals" not in renderings[-1] or "normals" not in batch:
        return batch["rgb"].new_zeros(())
    mask = batch["rgb_mask"] & (batch["semantic"] != 10)
    pred, pseudo = renderings[-1]["normals"], batch["normals"]
    per_ray = (torch.abs(pred - pseudo).sum(-1)
               + (1 - torch.sum(pred * pseudo, dim=-1)))
    return 0.1 * _masked_mean(per_ray, mask, mesh)


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
        loss = loss + (sums / gridlib.level_rows(spec, table.device)).mean()
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
                      num_patch_rays: int = 0, rows=None, mesh=None):
    """Depth / semantic smoothness on the patch rays: the first
    num_patch_rays rays of the batch (of `rows`, the global batch's, by
    default the batch's own) are [P, ps, ps] row-major patches."""
    ps = config.patch_size
    if ps <= 1 or num_patch_rays <= 0 or "loss_mask" not in batch:
        return {}
    rows = rows or _global_rows(batch, renderings, config)
    shape = (num_patch_rays // (ps * ps), ps, ps)
    n = shape[0] * ps * ps
    mask = rows["loss_mask"][:n].reshape(shape).to(torch.float32)
    rgb = rows["rgb"][:n].reshape(shape + (-1,))
    dep = rows["depth"][:n].reshape(shape)
    out = {"d_smo": 0.01 * _share(edge_aware_smoothness(rgb, dep, mask),
                                  mesh)}
    if config.model.use_semantic:
        sem = rows["semantic"][:n].reshape(shape + (-1,))
        out["s_smo"] = 0.01 * _share(edge_aware_smoothness(rgb, sem, mask),
                                     mesh)
    return out


def compute_losses(model, batch, renderings, ray_history, config: Config,
                   step: int, num_patch_rays: int = 0,
                   use_kernels: bool = True, mesh=None
                   ) -> Dict[str, torch.Tensor]:
    """The loss dict; keys starting with '_' are stats, not losses. Under a
    data mesh, every entry is this rank's share (module docstring)."""
    check_ported(config)
    losses: Dict[str, torch.Tensor] = {}
    rows = None
    if mesh is not None and (
            (config.depth_loss and "depth" in batch) or (
                config.patch_size > 1 and num_patch_rays > 0
                and "loss_mask" in batch)):
        rows = _global_rows(batch, renderings, config, mesh)
    losses["data"], losses["_mses"] = data_loss(batch, renderings, config,
                                                mesh)
    for stat in ("obj_overflow", "obj_hit_frac"):
        if stat in renderings[-1]:
            # Global on every rank (models/objects.py): a share of it.
            v = renderings[-1][stat]
            losses[f"_{stat}"] = v if mesh is None else _share(v.float(),
                                                               mesh)
    if config.depth_loss and "depth" in batch:
        losses["depth"] = depth_loss(batch, renderings, config, step, rows,
                                     mesh)
    if config.model.use_semantic and "semantic" in batch:
        losses["sem"] = semantic_loss(batch, renderings, config, step, mesh)
    if config.model.use_intensity and "intensity" in batch:
        losses["int"] = intensity_loss(batch, renderings, config, mesh)
    if config.anti_interlevel_loss_mult > 0:
        losses["interlevel"] = anti_interlevel_loss(ray_history, config,
                                                    mesh)
    if config.distortion_loss_mult > 0:
        losses["distortion"] = distortion_loss(ray_history, config, mesh)
    if config.hash_decay_mults > 0:
        losses["hash_decay"] = _share(
            hash_decay_loss(model, config, use_kernels), mesh)
    if config.orientation_loss_mult > 0 or \
            config.orientation_coarse_loss_mult > 0:
        losses["orientation"] = orientation_loss(batch, ray_history, config,
                                                 mesh)
    if config.predicted_normal_loss_mult > 0 or \
            config.predicted_normal_coarse_loss_mult > 0:
        losses["predicted_normals"] = predicted_normal_loss(ray_history,
                                                            config, mesh)
    if config.normal_supervision and "normals" in batch:
        losses["normals"] = normal_supervision_loss(batch, renderings,
                                                    config, mesh)
    if config.model.latent_size > 0:
        losses["latent_reg"] = _share(latent_reg(model, config), mesh)
    if config.model.symmetrize and "loss_sym" in renderings[-1]:
        losses["sym"] = (config.sym_loss * renderings[-1]["loss_sym"]
                         if step > config.sym_start
                         else renderings[-1]["loss_sym"].new_zeros(()))
    losses.update(smoothness_losses(batch, renderings, config,
                                    num_patch_rays=num_patch_rays, rows=rows,
                                    mesh=mesh))
    return losses


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(v for k, v in losses.items() if not k.startswith("_"))
