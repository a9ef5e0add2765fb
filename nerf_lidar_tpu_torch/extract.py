"""Mesh extraction from a trained field (port of `nerf_lidar_tpu/extract.py`).

The NeRF MLP's density on a dense lattice in contracted space (so that
resolution concentrates near the scene's core), an isosurface by marching
tetrahedra (`utils/marching.py`, host numpy), vertices mapped back to the
world by `inv_contract`, and optionally vertex colours from the field's
radiance. The model holds its weights, so no function takes `params`; each
takes `use_kernels` as the renderer does: the lattice and the colours go
through the hash-grid encode H1 on CUDA (n = 1 multisample, stds 0), or its
plain torch version with False. Every chunk is padded to the chunk size as
JAX pads it (zeros, or the last row repeated for rays and vertices).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .ops import coord
from .ops import render as render_ops
from .renderer import _pad_to as _pad_rows
from .utils import marching


def _device(model) -> torch.device:
    return model.nerf_mlp.table.device


@torch.no_grad()
def density_on_lattice(model, resolution: int = 128,
                       mesh_radius: float = 1.0, chunk: int = 65536,
                       std_value: float = 0.0, use_kernels: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Density on a [R, R, R] lattice of contracted coordinates in
    [-mesh_radius, mesh_radius]^3 (contracted space spans [-2, 2]): the NeRF
    MLP's density trunk at one multisample per point with std `std_value`,
    softplus(raw + density_bias).

    Returns (density grid [R, R, R], lattice coords in contracted space
    [R, R, R, 3]), host float32.
    """
    lin = np.linspace(-mesh_radius, mesh_radius, resolution,
                      dtype=np.float32)
    xs, ys, zs = np.meshgrid(lin, lin, lin, indexing="ij")
    pts_c = np.stack([xs, ys, zs], -1).reshape(-1, 3)
    device = _device(model)
    mlp = model.nerf_mlp
    n = pts_c.shape[0]
    n_pad = -(-n // chunk) * chunk
    out = torch.empty(n_pad, device=device)
    for i in range(0, n_pad, chunk):
        c = torch.zeros(chunk, 3, device=device)
        part = pts_c[i:i + chunk]
        c[:len(part)] = torch.from_numpy(part).to(device)
        # World points for the MLP (it contracts them itself); the padding
        # is the origin, as JAX pads the world points with zeros.
        means = coord.inv_contract(c)[:, None, None, :]  # [N, 1, 1, 3]
        stds = torch.full(means.shape[:-1], std_value, device=device)
        raw = mlp.predict_density(means, stds, use_kernels=use_kernels)[0]
        out[i:i + chunk] = F.softplus(raw[:, 0] + mlp.cfg.density_bias)
    grid = out[:n].cpu().numpy().reshape(resolution, resolution, resolution)
    return grid, pts_c.reshape(resolution, resolution, resolution, 3)


@torch.no_grad()
def rgb_at_points(model, pts_w: np.ndarray, chunk: int = 32768,
                  viewdir=(0.0, 0.0, -1.0), use_kernels: bool = True
                  ) -> np.ndarray:
    """Radiance at points seen from one fixed direction (the simple vertex
    colouring; `rgb_by_projection` is the reference's). [N, 3] in [0, 1]."""
    vd = np.asarray(viewdir, np.float32)
    vd = vd / np.linalg.norm(vd)
    device = _device(model)
    n = pts_w.shape[0]
    n_pad = -(-n // chunk) * chunk
    pts_pad = np.concatenate(
        [pts_w.astype(np.float32), np.zeros((n_pad - n, 3), np.float32)])
    dirs = torch.from_numpy(vd).to(device).expand(chunk, 3)
    out = []
    for i in range(0, n_pad, chunk):
        means = torch.from_numpy(pts_pad[i:i + chunk]).to(device)[
            :, None, None, :]
        rgb = model.nerf_mlp(means, means.new_zeros(means.shape[:-1]),
                             viewdirs=dirs, use_kernels=use_kernels)["rgb"]
        out.append(rgb[:, 0])
    return np.clip(torch.cat(out)[:n].cpu().numpy(), 0, 1)


@torch.no_grad()
def build_visibility_grid(model, scene_data, resolution: int = 128,
                          mesh_radius: float = 1.0,
                          weight_thresh: float = 0.005,
                          pixel_stride: int = 8, chunk: int = 8192,
                          use_kernels: bool = True) -> np.ndarray:
    """The contracted-space voxels that the training views' high-weight
    samples pass through: every sample of the final level with weight above
    `weight_thresh` marks the 8 voxels of its trilinear footprint (the JAX
    package's stand-in for the reference's grid_sample backward). Rays of
    every `pixel_stride`-th pixel, rendered without the fused compositor.
    Returns a bool [R, R, R] grid over [-mesh_radius, mesh_radius]^3."""
    from .data import camera as camlib

    device = _device(model)
    grid = np.zeros((resolution,) * 3, bool)
    s = scene_data
    for v in range(s.num_views):
        x, y = np.meshgrid(np.arange(0, s.width, pixel_stride),
                           np.arange(0, s.height, pixel_stride))
        x, y = x.reshape(-1), y.reshape(-1)
        pixtocam = s.pixtocam if s.pixtocam.ndim == 2 else s.pixtocam[v]
        rays = camlib.pixels_to_rays(x, y, pixtocam, s.camtoworlds[v],
                                     distortion_params=s.distortion_params,
                                     camtype=s.camtype,
                                     pixtocam_ndc=s.pixtocam_ndc)
        n = x.shape[0]
        rays["near"] = np.full((n, 1), s.near, np.float32)
        rays["far"] = np.full((n, 1), s.far, np.float32)
        n_pad = -(-n // chunk) * chunk
        rays = {k: _pad_rows(np.asarray(val, np.float32), n_pad)
                for k, val in rays.items()}
        for i in range(0, n_pad, chunk):
            b = {k: torch.from_numpy(val[i:i + chunk]).to(device)
                 for k, val in rays.items()}
            _, history = model(b, train_frac=1.0, use_kernels=use_kernels)
            last = history[-1]
            t_mid = 0.5 * (last["tdist"][..., :-1] + last["tdist"][..., 1:])
            pts = (b["origins"][:, None]
                   + t_mid[..., None] * b["directions"][:, None])
            pts = coord.contract(pts)[last["weights"] > weight_thresh]
            pts = pts.cpu().numpy()
            # Points outside the cube are dropped, not clamped onto its
            # border voxels (which would mark the whole shell visible).
            pts = pts[np.all(np.abs(pts) <= mesh_radius, axis=-1)]
            if pts.size == 0:
                continue
            f = (pts + mesh_radius) / (2 * mesh_radius) * (resolution - 1)
            lo = np.floor(f).astype(np.int64)
            for corner in ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                           (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)):
                q = np.clip(lo + corner, 0, resolution - 1)
                grid[q[:, 0], q[:, 1], q[:, 2]] = True
    return grid


def auto_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (host numpy, as JAX computes them)."""
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    n = np.zeros_like(verts)
    for i in range(3):
        np.add.at(n, faces[:, i], fn)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(norm > 1e-20, n / np.maximum(norm, 1e-20),
                 np.array([0.0, 0.0, 1.0]))
    return n.astype(np.float32)


@torch.no_grad()
def rgb_by_projection(model, verts: np.ndarray, faces: np.ndarray,
                      chunk: int = 32768, eps: float = 0.005,
                      seg_len: float = 0.01, num_samples: int = 8,
                      use_kernels: bool = True) -> np.ndarray:
    """Projection-based vertex colours (the reference's): volume-render a
    short segment that enters each vertex along its inward normal through
    the NeRF MLP (`num_samples` samples over `seg_len`, starting `eps`
    outside), normalised by its accumulated alpha; NaN (no alpha) -> 1.
    [V, 3] in [0, 1]."""
    normals = auto_normals(verts, faces)
    viewdirs = -normals
    origins = (verts - eps * viewdirs).astype(np.float32)
    device = _device(model)
    n = verts.shape[0]
    n_pad = -(-n // chunk) * chunk
    o_all = _pad_rows(origins, n_pad)
    d_all = _pad_rows(viewdirs.astype(np.float32), n_pad)
    t = torch.linspace(0.0, seg_len, num_samples + 1, device=device)
    out = []
    for i in range(0, n_pad, chunk):
        o = torch.from_numpy(o_all[i:i + chunk]).to(device)
        d = torch.from_numpy(d_all[i:i + chunk]).to(device)
        tdist = t.expand(o.shape[0], num_samples + 1)
        t_mid = 0.5 * (tdist[:, :-1] + tdist[:, 1:])
        means = (o[:, None] + t_mid[..., None] * d[:, None])[..., None, :]
        res = model.nerf_mlp(means, means.new_zeros(means.shape[:-1]),
                             viewdirs=d, use_kernels=use_kernels)
        weights = render_ops.compute_alpha_weights(res["density"], tdist,
                                                   d)[0]
        acc = weights.sum(-1)
        rgb = (weights[..., None] * res["rgb"]).sum(-2)
        rgb = rgb / torch.clamp(acc[..., None], min=1e-5)
        out.append(torch.nan_to_num(torch.clamp(rgb, 0.0, 1.0), nan=1.0))
    return torch.cat(out)[:n].cpu().numpy()


def extract_mesh(model, resolution: int = 128,
                 isosurface_threshold: float = 20.0,
                 mesh_radius: float = 1.0, mesh_max_radius: float = 10.0,
                 vertex_color: bool = True,
                 color_mode: str = "projection",
                 visibility_grid: Optional[np.ndarray] = None,
                 out_path: Optional[str] = None,
                 clean: bool = False, decimate_target: int = 0,
                 use_kernels: bool = True):
    """The pipeline: density lattice -> visibility culling (an optional
    bool [Rv, Rv, Rv] `build_visibility_grid` over the same cube zeroes the
    density outside it) -> marching tetrahedra in contracted space ->
    welded vertices to the world by `inv_contract` -> the far-field shell
    (beyond `mesh_max_radius`) dropped -> `clean` / `decimate_target` ->
    vertex colours (projection or one fixed view) -> PLY.
    Returns (verts_world [V, 3], faces [F, 3], colors [V, 3] or None)."""
    grid, _ = density_on_lattice(model, resolution, mesh_radius,
                                 use_kernels=use_kernels)
    if visibility_grid is not None:
        grid = grid * _sample_mask(visibility_grid, resolution)
    spacing = 2 * mesh_radius / (resolution - 1)
    verts_c, faces = marching.marching_tetrahedra(
        grid, isosurface_threshold,
        origin=(-mesh_radius,) * 3, spacing=(spacing,) * 3)
    verts_c, faces = marching.weld_vertices(verts_c, faces)
    if len(verts_c) == 0:
        return verts_c, faces, None
    verts_w = coord.inv_contract(torch.from_numpy(
        verts_c.astype(np.float32))).numpy()
    keep = np.linalg.norm(verts_w, axis=-1) <= mesh_max_radius
    remap = np.cumsum(keep) - 1
    faces = faces[keep[faces].all(axis=1)]
    faces = remap[faces]
    verts_w = verts_w[keep]
    if clean and len(faces):
        verts_w, faces = marching.clean_mesh(verts_w, faces)
    if decimate_target > 0 and len(faces) > decimate_target:
        verts_w, faces = marching.decimate_mesh(verts_w, faces,
                                                decimate_target)
    verts_w = np.asarray(verts_w, np.float32)
    colors = None
    if vertex_color and len(verts_w):
        if color_mode == "projection" and len(faces):
            colors = rgb_by_projection(model, verts_w, faces,
                                       use_kernels=use_kernels)
        else:
            colors = rgb_at_points(model, verts_w, use_kernels=use_kernels)
    if out_path and len(verts_w):
        marching.write_ply(out_path, verts_w, faces, colors)
    return verts_w, faces, colors


def _sample_mask(vis: np.ndarray, resolution: int) -> np.ndarray:
    """Nearest-sample a bool visibility grid onto the density lattice."""
    rv = vis.shape[0]
    idx = np.clip(np.round(np.linspace(0, rv - 1, resolution)).astype(
        np.int64), 0, rv - 1)
    return vis[np.ix_(idx, idx, idx)].astype(np.float32)
