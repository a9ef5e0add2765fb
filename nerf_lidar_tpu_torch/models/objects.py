"""Dynamic objects (vehicles): tracks, box transforms, compositing (port of
`nerf_lidar_tpu/models/objects.py`).

The track set is padded to a static `num_objects`. Track tensor layout:
tracks[N_obj, T, 9] rows = [cx, cy, cz, theta_z, w, l, h, time, track_id];
a row with wlh == 0 means "absent at this time" (a zero-size box never
intersects).

Compositing overwrites the field's prediction at every sample inside a box
with the object MLP's (the last intersecting object wins). Inference runs
it dense, every sample through the object MLP; training may cap the object
MLP's work at a static budget K of compacted samples
(`_composite_objects_compact`), with the same K, overflow rule and stats
as the JAX package, in tensor ops only (no host sync). The object MLPs'
encode is kernel H1 at n = 1 and stds = 0 on CUDA tensors (see
`ops/grid.py:hash_encode`); nothing here launches another kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import grid as gridlib
from ..ops import render as render_ops

_MIRROR = (1.0, -1.0, 1.0)


def rotate_z(p: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate points about +z by theta: a proper rotation, as the JAX
    package has it (the original code's `rotate_yaw_z` is a shear)."""
    c, s = torch.cos(theta), torch.sin(theta)
    x = c * p[..., 0] - s * p[..., 1]
    y = s * p[..., 0] + c * p[..., 1]
    z = torch.broadcast_to(p[..., 2], x.shape)
    return torch.stack([x, y, z], dim=-1)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-9)


def world2object(pts, dirs, center, theta_z, wlh):
    """World frame -> unit-box object frames (the box scaled to [-1, 1]^3).
    pts, dirs: [..., 3]; center / theta_z / wlh broadcast against pts'
    batch dims. Returns (pts_o, dirs_o normalised)."""
    t_w_o = rotate_z(-center, theta_z)
    inv_half = 1.0 / (wlh / 2.0 + 1e-9)
    pts_o = (rotate_z(pts, theta_z) + t_w_o) * inv_half
    dirs_o = rotate_z(dirs, theta_z) * inv_half
    return pts_o, _normalize(dirs_o)


def object2world(pts_o, dirs_o, center, theta_z, wlh):
    """Inverse of `world2object` (dirs_o may be None)."""
    half = wlh / 2.0 + 1e-9
    t_w_o = rotate_z(-center, theta_z)
    pts = rotate_z(pts_o * half - t_w_o, -theta_z)
    dirs = None
    if dirs_o is not None:
        dirs = _normalize(rotate_z(dirs_o * half, -theta_z))
    return pts, dirs


def box_pts(pts, viewdirs, obj_pose):
    """Every sample in every object's unit box, and its containment.
    pts: [R, S, 3]; viewdirs: [R, 3]; obj_pose: [R, N_obj, >=7] with
    [:3] centre, [3] theta_z, [4:7] wlh. Returns pts_o, dirs_o
    [R, S, N_obj, 3] and intersection [R, S, N_obj] bool."""
    center = obj_pose[:, None, :, :3]
    theta_z = obj_pose[:, None, :, 3]
    wlh = obj_pose[:, None, :, 4:7]
    p = pts[:, :, None, :]
    d = torch.broadcast_to(viewdirs[:, None, None, :], p.shape)
    pts_o, dirs_o = world2object(p, d, center, theta_z, wlh)
    valid_box = (wlh > 0).all(-1)
    inter = (pts_o.abs() < 1.0).all(-1) & valid_box
    return pts_o, dirs_o, inter


def ray_box_intersection(ray_o, ray_d):
    """Slab test against the unit box. ray_o / ray_d: [..., 3] in the box
    frame. Returns (t_near, t_far, hit)."""
    tiny = torch.where(ray_d < 0, -1e-12, 1e-12)
    inv_d = 1.0 / torch.where(ray_d.abs() < 1e-12, tiny, ray_d)
    t_min = (-1.0 - ray_o) * inv_d
    t_max = (1.0 - ray_o) * inv_d
    t_near = torch.minimum(t_min, t_max).amax(-1)
    t_far = torch.maximum(t_min, t_max).amin(-1)
    return t_near, t_far, (t_far > t_near) & (t_far > 0)


def get_pose(time: torch.Tensor, tracks: torch.Tensor) -> torch.Tensor:
    """Per-ray object poses: linear interpolation between each object's two
    track rows nearest in time. time: [R] or [R, 1]; tracks: [N_obj, T, F]
    with column -2 the timestamp. Returns [R, N_obj, F].

    The two rows come from a stable sort of |time - t|, so on a tie the
    lower row comes first, as `jax.lax.top_k` orders them."""
    if time.dim() == 2:
        time = time[..., 0]
    ttimes = tracks[:, :, -2]  # [N_obj, T]
    diff = (time[:, None, None] - ttimes[None]).abs()  # [R, N_obj, T]
    idx = torch.sort(diff, dim=-1, stable=True).indices[..., :2]
    tt = ttimes[None].expand(diff.shape)
    t1 = torch.gather(tt, -1, idx[..., 0:1])[..., 0]
    t2 = torch.gather(tt, -1, idx[..., 1:2])[..., 0]
    total = (t1 - t2).abs() + 1e-9
    w1 = torch.clamp((time[:, None] - t2).abs() / total, 0, 1)
    # Rows of the flattened [N_obj T, F] tracks through index_select
    # (`grid.select_rows`), whose backward adds into the rows (advanced
    # indexing's backward sorts the R N_obj indices, thousands per row, and
    # sums each row in turn).
    n_obj, t = tracks.shape[:2]
    rows = torch.arange(n_obj, device=tracks.device)[None] * t
    flat = tracks.reshape(n_obj * t, -1)

    def pick(i):
        return gridlib.select_rows(flat, (rows + i).reshape(-1)).reshape(
            i.shape + flat.shape[-1:])

    info1, info2 = pick(idx[..., 0]), pick(idx[..., 1])
    return w1[..., None] * info1 + (1.0 - w1)[..., None] * info2


def query_class(class_name: str) -> int:
    """Track class name -> semantic class id: human 11,
    truck / trailer / construction 14, bus 15, car 13, else 255 (no fixed
    label)."""
    if "human" in class_name:
        return 11
    if ("truck" in class_name or "trailer" in class_name
            or "construction" in class_name):
        return 14
    if "bus" in class_name:
        return 15
    if "car" in class_name:
        return 13
    return 255


def _add_column(tracks, col: int, delta: float):
    """A copy of tracks (numpy or torch) with `delta` added to a column."""
    out = tracks.clone() if isinstance(tracks, torch.Tensor) \
        else np.array(tracks)
    out[:, :, col] += delta
    return out


def simu_info(mode: str, tracks, angle: float = 0.0,
              lane_shift: float = 0.03):
    """Scene-edit modes: replay (unchanged), laneshift (+y shift), removal
    (no tracks), rotate (+15 degrees of yaw through `manipulate_tracks`).
    Returns (angle in degrees, tracks)."""
    if mode == "replay":
        return 0.0, tracks
    if mode == "laneshift":
        if tracks is not None:
            tracks = _add_column(tracks, 1, lane_shift)
        return 0.0, tracks
    if mode == "removal":
        return 0.0, None
    if mode == "rotate":
        return 15.0, tracks
    raise ValueError(mode)


def manipulate_tracks(tracks, angle_deg: float):
    """Rotate every box by angle_deg about z."""
    return _add_column(tracks, 3, np.deg2rad(angle_deg))


def edit_tracks(tracks, track_mask, classes, new_track,
                class_name="car_fusion"):
    """Append an inserted track ([T, F] or [K, T, F]); the model's
    num_objects must cover the new slots. Returns (tracks, track_mask,
    classes) as numpy arrays and a list."""
    nt = np.asarray(new_track)
    if nt.ndim == 2:
        nt = nt[None]
    tracks = np.concatenate([np.asarray(tracks), nt], axis=0)
    track_mask = np.concatenate(
        [np.asarray(track_mask), np.ones(len(nt), bool)])
    return tracks, track_mask, list(classes) + [class_name] * len(nt)


def _eval_obj_mlp(obj_mlp, obj_latents, pts_o, dirs_o,
                  use_kernels: bool = True):
    """One object-MLP evaluation over every (ray, sample, object) triple.
    pts_o / dirs_o: [R, S, N, 3]; obj_latents: [N_obj, Z] (all slots),
    [R, S, Z] (one latent a sample, N = 1) or None. Objects fold into the
    sample axis (n = 1 multisample, stds 0). Returns [R, S, N, ...]."""
    R, S, N = pts_o.shape[:3]
    p = pts_o.reshape(R, S * N, 1, 3)
    lat = None
    if obj_latents is not None:
        if obj_latents.dim() == 2:
            lat = obj_latents[None, None].expand((R, S) + obj_latents.shape)
        else:
            lat = obj_latents[:, :, None]
        lat = lat.reshape(R, S * N, -1)
    out = obj_mlp(p, p.new_zeros(p.shape[:-1]),
                  viewdirs=dirs_o.reshape(R, S * N, 3), latent=lat,
                  use_kernels=use_kernels)
    return {k: (v.reshape((R, S, N) + v.shape[2:]) if v is not None
                else None) for k, v in out.items()}


def _eval_obj_mlp_grouped(class_groups, obj_latents, pts_o, dirs_o,
                          use_kernels: bool = True):
    """Per-class object MLPs: class_groups is a list of (mlp, slots) with
    every slot in exactly one group; each group is one evaluation over its
    own [R, S, N_k] sub-tensor, and the outputs return to slot order."""
    parts, order = {}, []
    for mlp, slots in class_groups:
        idx = list(slots)
        order.extend(idx)
        lat = obj_latents[idx] if obj_latents is not None else None
        out = _eval_obj_mlp(mlp, lat, pts_o[:, :, idx], dirs_o[:, :, idx],
                            use_kernels)
        for k, v in out.items():
            parts.setdefault(k, []).append(v)
    inv = torch.as_tensor(np.argsort(np.asarray(order)),
                          device=pts_o.device)
    return {k: (None if any(v is None for v in vs)
                else torch.cat(vs, dim=2)[:, :, inv])
            for k, vs in parts.items()}


def _compact_flags(flag_flat: torch.Tensor, budget: int, offset=0,
                   slots: Optional[int] = None):
    """Static-shape stream compaction of a bool mask [N]. Returns
    (sample_ids [slots] — the indices of the set flags whose rank is below
    `budget`, 0 past them, valid [slots] bool, pos [N] — each element's
    rank among the set flags). A cumsum ranks the flags and a binary
    search in it finds slot j's flag, the first element whose count
    reaches j + 1; no host sync. (A scatter of the unset flags onto one
    spare slot would add its repeats in turn under torch's deterministic
    algorithms: ~90 ms a call.) offset: the set flags before this mask (a
    data-parallel rank's shard of the global batch: its ranks count from
    the earlier shards' flags); slots: the buffer's size, by default
    `budget`, at least the flags this mask can keep."""
    slots = budget if slots is None else slots
    count = torch.cumsum(flag_flat.long(), dim=0)
    pos = count - 1 + offset
    ranks = torch.arange(slots, device=flag_flat.device)
    valid = ranks < torch.clamp(
        torch.clamp(pos[-1] + 1, max=budget) - offset, min=0)
    found = torch.searchsorted(count, ranks + 1)
    return torch.where(valid, found, 0), valid, pos


def _sym_loss(outs, outs_sym, m, mesh=None):
    """Mean |stop_grad(raw) - mirrored| over density and rgb where m; under
    a data mesh, this rank's share of the global batch's mean (its sum over
    the count summed over the ranks)."""
    denom = m.sum()
    if mesh is not None:
        denom = mesh.all_reduce(denom.detach().clone())
    denom = torch.clamp(denom, min=1.0)
    loss = 0.0
    for k in ("density", "rgb"):
        diff = (outs[k].detach() - outs_sym[k]).abs()
        if diff.dim() == m.dim() + 1:
            diff = diff.mean(-1)
        loss = loss + (diff * m).sum() / denom
    return loss


def _label_semantic(results, obj_sem_ids, winner_slot, mask):
    """Per-slot fixed semantic labels: samples in `mask` take the one-hot of
    their winning slot's id; 255 (unlabeled) and ids past the head keep
    the MLP output."""
    sem = results.get("semantic")
    if obj_sem_ids is None or sem is None:
        return
    k = sem.shape[-1]
    sid = torch.as_tensor(obj_sem_ids, device=sem.device)[winner_slot]
    valid = mask & (sid != 255) & (sid < k)
    onehot = F.one_hot(torch.clamp(sid, 0, k - 1), k).to(sem.dtype)
    results["semantic"] = torch.where(valid[..., None], onehot, sem)


def composite_objects(obj_mlp, obj_latents: Optional[torch.Tensor],
                      pts_w: torch.Tensor, viewdirs: torch.Tensor,
                      obj_pose: torch.Tensor,
                      track_mask: Optional[torch.Tensor],
                      ray_results: Dict[str, torch.Tensor], is_prop: bool,
                      sym: bool = False, class_groups=None,
                      obj_sem_ids=None, sample_budget: Optional[int] = None,
                      use_kernels: bool = True,
                      mesh=None) -> Dict[str, torch.Tensor]:
    """Overwrite the field's predictions inside object boxes with the
    object MLP's.

    pts_w: [R, S, 3]; obj_pose: [R, N_obj, F]; obj_latents: [N_obj, Z] or
    None; track_mask: [N_obj] bool validity of the padded slots;
    class_groups: per-class MLPs (see `_eval_obj_mlp_grouped`), else the
    shared `obj_mlp`. obj_sem_ids: each slot's fixed semantic class (a
    sequence, or a long tensor on the device), 255 for none, or None.
    sym: also evaluate the y-mirrored object-frame points
    and return "loss_sym" (gradients through the mirrored branch only).
    sample_budget: the static cap K on the object MLP's samples (training),
    or None for the dense evaluation. Adds "obj_mask" [R, S, N_obj] (and,
    with a budget, "obj_overflow" and "obj_hit_frac").
    mesh: a `parallel.DataMesh` when pts_w is a data-parallel rank's rows
    of the global batch: the budget then caps the global batch's samples
    in order (the first K over all shards), the stats are the global
    batch's, and "loss_sym" is this rank's share.
    """
    if sample_budget is not None:
        # The dense test only picks the samples; without gradient, so that
        # autograd keeps no [R, S, N_obj, 3] tensor. The budgeted path
        # transforms its K points again, with gradient.
        with torch.no_grad():
            _, _, inter = box_pts(pts_w, viewdirs, obj_pose)
    else:
        pts_o, dirs_o, inter = box_pts(pts_w, viewdirs, obj_pose)
    if track_mask is not None:
        inter = inter & track_mask[None, None, :]
    # The last intersecting object wins: the largest intersecting slot id
    # (slot 0 where none intersects, as argmax of all -1 gives).
    ids = torch.arange(inter.shape[-1], device=inter.device)
    winner_slot = torch.where(inter, ids, -1).amax(-1).clamp(min=0)
    any_inter = inter.any(-1)

    if sample_budget is not None:
        return _composite_objects_compact(
            obj_mlp, obj_latents, pts_w, viewdirs, obj_pose, ray_results,
            is_prop, sym, class_groups, obj_sem_ids, int(sample_budget),
            inter, winner_slot, any_inter, use_kernels, mesh)

    winner_only = class_groups is None
    if winner_only:
        # Only the winner's output is composited: evaluate it alone.
        w_idx = winner_slot[..., None, None].expand(
            winner_slot.shape + (1, 3))
        pts_e = torch.gather(pts_o, 2, w_idx)  # [R, S, 1, 3]
        dirs_e = torch.gather(dirs_o, 2, w_idx)
        lat_e = (gridlib.select_rows(obj_latents, winner_slot.reshape(-1))
                 .reshape(winner_slot.shape + obj_latents.shape[1:])
                 if obj_latents is not None else None)

        def eval_all(p, d):
            return _eval_obj_mlp(obj_mlp, lat_e, p, d, use_kernels)
    else:
        pts_e, dirs_e = pts_o, dirs_o

        def eval_all(p, d):
            return _eval_obj_mlp_grouped(class_groups, obj_latents, p, d,
                                         use_kernels)

    outs = eval_all(pts_e, dirs_e)
    if is_prop:
        outs = {k: (v.detach() if v is not None else None)
                for k, v in outs.items()}

    results = dict(ray_results)
    if sym:
        mirror = pts_e.new_tensor(_MIRROR)
        outs_sym = eval_all(pts_e.detach() * mirror, dirs_e.detach() * mirror)
        # Winner-only evaluation constrains the winning (sample, object)
        # pairs, the dense one every intersecting pair.
        m = (any_inter[..., None] if winner_only else inter).float()
        results["loss_sym"] = _sym_loss(outs, outs_sym, m, mesh)

    # Winner-only outputs have N = 1: slot 0 is the winner.
    winner = torch.zeros_like(winner_slot) if winner_only else winner_slot
    for key in ("density", "rgb", "semantic", "intensity"):
        base, ov = results.get(key), outs.get(key)
        if base is None or ov is None:
            continue
        idx = winner[..., None]
        if ov.dim() == 4:
            idx = idx[..., None].expand(winner.shape + (1, ov.shape[-1]))
        picked = torch.gather(ov, 2, idx)[:, :, 0]
        m = any_inter if base.dim() == 2 else any_inter[..., None]
        results[key] = torch.where(m, picked, base)
    _label_semantic(results, obj_sem_ids, winner_slot, any_inter)
    results["obj_mask"] = inter
    return results


def _composite_objects_compact(obj_mlp, obj_latents, pts_w, viewdirs,
                               obj_pose, ray_results, is_prop, sym,
                               class_groups, obj_sem_ids, budget, inter,
                               winner_slot, any_inter, use_kernels,
                               mesh=None):
    """Budgeted compositing: the object MLP runs on K compacted samples, K =
    max(8, min(budget, R S)). The box transform is recomputed at the K
    winner points, with gradient, so the track refinement's gradient runs
    through the K points and one gather of the poses. Samples past the
    budget keep the field's prediction.

    The gathers with gradient are index_select (`grid.select_rows`) and
    index_copy: their backward adds or gathers rows, where advanced
    indexing's backward sorts its indices and sums each row's run in turn
    (K latent rows of one object, R S samples onto K slots); under torch's
    deterministic algorithms index_select's backward does so too, and
    `select_rows` sums it with K3's deterministic variant instead."""
    R, S = any_inter.shape
    rs = R * S
    flags = any_inter.reshape(rs)
    if mesh is None:
        total = rs
        budget = max(8, min(int(budget), total))
        sid, valid_k, pos = _compact_flags(flags, budget)
        n_hit = pos[-1] + 1
    else:
        # The global batch's first K samples in a box: this shard's ranks
        # count from the earlier shards' hits (one all_gather of counts).
        total = rs * mesh.data_size
        budget = max(8, min(int(budget), total))
        counts = mesh.all_gather_rows(flags.sum().reshape(1))
        sid, valid_k, pos = _compact_flags(
            flags, budget, counts[:mesh.data_index].sum(),
            max(8, min(budget, rs)))
        n_hit = counts.sum()
    r_idx = torch.div(sid, S, rounding_mode="floor")
    w_slot = winner_slot.reshape(rs)[sid]  # [K] winning slot
    n_obj = obj_pose.shape[1]
    pose_k = gridlib.select_rows(obj_pose.reshape(R * n_obj, -1),
                                 r_idx * n_obj + w_slot)  # [K, F]
    pts_ok, dirs_ok = world2object(gridlib.select_rows(pts_w.reshape(rs, 3),
                                                       sid),
                                   gridlib.select_rows(viewdirs, r_idx),
                                   pose_k[:, :3], pose_k[:, 3],
                                   pose_k[:, 4:7])
    # [1, K, 1, 3]: batch 1, K sample slots, one object each.
    pts_e, dirs_e = pts_ok[None, :, None], dirs_ok[None, :, None]
    lat_k = (gridlib.select_rows(obj_latents, w_slot)[None]
             if obj_latents is not None else None)

    if class_groups is None:
        def eval_all(p, d):
            return _eval_obj_mlp(obj_mlp, lat_k, p, d, use_kernels)
    else:
        # Every class MLP runs on the same K points; each point takes the
        # output of its winner's class.
        slot_to_group = np.full(max(max(s) for _, s in class_groups) + 1,
                                -1, np.int64)
        for g, (_, slots) in enumerate(class_groups):
            slot_to_group[list(slots)] = g
        grp_k = torch.as_tensor(slot_to_group, device=w_slot.device)[w_slot]

        def eval_all(p, d):
            merged = None
            for g, (mlp, _) in enumerate(class_groups):
                out = _eval_obj_mlp(mlp, lat_k, p, d, use_kernels)
                if len(class_groups) == 1:
                    return out
                merged = {k: (torch.where(
                    (grp_k == g).reshape((1, -1) + (1,) * (v.dim() - 2)), v,
                    0.0 if merged is None else merged[k])
                    if v is not None else None) for k, v in out.items()}
            return merged

    outs = eval_all(pts_e, dirs_e)
    if is_prop:
        outs = {k: (v.detach() if v is not None else None)
                for k, v in outs.items()}

    results = dict(ray_results)
    if sym:
        mirror = pts_e.new_tensor(_MIRROR)
        outs_sym = eval_all(pts_e.detach() * mirror, dirs_e.detach() * mirror)
        results["loss_sym"] = _sym_loss(outs, outs_sym,
                                        valid_k[None, :, None].float(), mesh)

    # Slot k's evaluation goes to sample sid[k] for the valid slots (the
    # first K samples in a box); padding slot k to dump row rs + k past the
    # R S samples (one dump row for all of them would repeat an index
    # thousands of times, which index_copy writes in turn under torch's
    # deterministic algorithms). Samples past the budget keep the field
    # prediction.
    ok = any_inter & (pos.reshape(R, S) < budget)
    k_slots = sid.shape[0]
    dest = torch.where(valid_k, sid,
                       rs + torch.arange(k_slots, device=sid.device))
    results["obj_overflow"] = torch.clamp(n_hit - budget, min=0)
    results["obj_hit_frac"] = n_hit.float() / total
    for key in ("density", "rgb", "semantic", "intensity"):
        base, ov = results.get(key), outs.get(key)
        if base is None or ov is None:
            continue
        flat = base.reshape((rs,) + base.shape[2:])
        flat = torch.cat([flat, flat[:1].expand((k_slots,) + flat.shape[1:])]
                         ).index_copy(0, dest, ov[0, :, 0])
        results[key] = flat[:rs].reshape(base.shape)
    _label_semantic(results, obj_sem_ids, winner_slot, ok)
    results["obj_mask"] = inter
    return results


@torch.no_grad()
def render_instance(model, track_id: int, height: int = 128,
                    width: int = 128, num_views: int = 8,
                    num_samples: int = 64, radius: float = 2.5,
                    use_kernels: bool = True) -> np.ndarray:
    """Render one object's field alone, orbiting its unit box: rays cast in
    the object frame, clipped to the box by the slab test, sampled
    uniformly between entry and exit, composited over white. Returns
    [num_views, H, W, 3] numpy."""
    from ..data import camera as camlib

    device = model.nerf_mlp.table.device
    cls_ids = model.cfg.obj_class_ids
    mlp = (getattr(model, f"obj_mlp_cls{int(cls_ids[track_id])}")
           if cls_ids else model.obj_mlp)
    lat = (model.obj_latents[track_id]
           if getattr(model, "obj_latents", None) is not None else None)
    frames = []
    for v in range(num_views):
        ang = 2 * np.pi * v / num_views
        eye = np.array([radius * np.cos(ang), radius * np.sin(ang), 1.2])
        rays = camlib.camera_rays(camlib.lookat_pose(eye, np.zeros(3)),
                                  height, width, focal=width * 0.8)
        o = torch.from_numpy(rays["origins"].reshape(-1, 3)).to(device)
        d = torch.from_numpy(rays["viewdirs"].reshape(-1, 3)).to(device)
        t_near, t_far, hit = ray_box_intersection(o, d)
        t_near = torch.clamp(t_near, min=0.0)
        t = torch.linspace(0.0, 1.0, num_samples + 1, device=device)
        tdist = t_near[:, None] + (t_far - t_near)[:, None] * t[None]
        t_mids = 0.5 * (tdist[:, :-1] + tdist[:, 1:])
        pts = o[:, None, :] + t_mids[..., None] * d[:, None, :]
        means = pts[..., None, :]  # n = 1 multisample
        lat_b = (None if lat is None
                 else lat.expand(pts.shape[:2] + lat.shape))
        out = mlp(means, means.new_zeros(means.shape[:-1]), viewdirs=d,
                  latent=lat_b, use_kernels=use_kernels)
        weights = render_ops.compute_alpha_weights(out["density"], tdist,
                                                   d)[0]
        weights = weights * hit[:, None]
        acc = weights.sum(-1)
        rgb = (weights[..., None] * out["rgb"]).sum(-2) + (1 - acc[..., None])
        frames.append(rgb.reshape(height, width, 3).cpu().numpy())
    return np.stack(frames)
