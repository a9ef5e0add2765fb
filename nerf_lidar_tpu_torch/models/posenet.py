"""Learnable pose and track refinement (port of
`nerf_lidar_tpu/models/posenet.py`).

`LearnPose` holds per-camera-image (+ per-LiDAR) so(3) axis-angle and
translation deltas, applied to a ray batch by `apply_pose_refinement`;
`TrackOpt` holds per-(object, timestamp) yaw and translation deltas added
to the track tensor. Both start at zero, so they begin as the identity;
their step windows and learning rates live in `train/train_step.py`.
Parameter names are the Flax ones (`r`, `t`, `opt_r`, `opt_t`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn


def vec2skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrices."""
    zero = torch.zeros_like(v[..., :1])
    r0 = torch.cat([zero, -v[..., 2:3], v[..., 1:2]], dim=-1)
    r1 = torch.cat([v[..., 2:3], zero, -v[..., 0:1]], dim=-1)
    r2 = torch.cat([-v[..., 1:2], v[..., 0:1], zero], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def so3_exp(r: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3] (Rodrigues).

    The angle is sqrt(|r|^2 + 1e-15), as in the JAX package, so that the
    gradient at the zero init is finite and the same in both packages."""
    skew = vec2skew(r)
    norm = torch.sqrt((r**2).sum(-1) + 1e-15)[..., None, None]
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(skew.shape)
    return (eye + (torch.sin(norm) / norm) * skew
            + ((1 - torch.cos(norm)) / norm**2) * (skew @ skew))


class LearnPose(nn.Module):
    """Per-camera-image (+ per-LiDAR-frame) learnable pose deltas.

    learn_R / learn_t gate whether the rotation / translation deltas take
    effect; a disabled component is pinned to identity / zero, and its
    parameter still exists, so checkpoints keep one layout."""

    def __init__(self, num_cams: int, num_lidars: int = 0,
                 t_ratio: float = 0.25, learn_R: bool = True,
                 learn_t: bool = True, device=None):
        super().__init__()
        n = num_cams + num_lidars
        self.r = nn.Parameter(torch.zeros(n, 3, device=device))
        self.t = nn.Parameter(torch.zeros(n, 3, device=device))
        self.t_ratio, self.learn_R, self.learn_t = t_ratio, learn_R, learn_t

    def forward(self, cam_id: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """cam_id: [N] int. Returns (R [N, 3, 3], t [N, 3])."""
        cam_id = cam_id.long()
        r = self.r[cam_id] if self.learn_R else torch.zeros_like(
            self.r[cam_id])
        t = (self.t[cam_id] * self.t_ratio if self.learn_t
             else torch.zeros_like(self.t[cam_id]))
        return so3_exp(r), t


def apply_pose_refinement(R: torch.Tensor, t: torch.Tensor,
                          batch: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """Rotate / translate a ray batch by per-ray deltas. R: [N, 3, 3],
    t: [N, 3]. origins += t; direction-like fields are row-rotated,
    v'_j = sum_i v_i R[:, i, j]."""
    out = dict(batch)
    out["origins"] = batch["origins"] + t
    for key in ("directions", "viewdirs", "base_x", "base_y", "normals"):
        if key in batch:
            out[key] = torch.einsum("ni,nij->nj", batch[key], R)
    return out


class TrackOpt(nn.Module):
    """Learnable per-(object, timestamp) yaw and translation deltas."""

    def __init__(self, num_objects: int, num_timestamps: int, device=None):
        super().__init__()
        self.opt_r = nn.Parameter(torch.zeros(num_objects, num_timestamps, 1,
                                              device=device))
        self.opt_t = nn.Parameter(torch.zeros(num_objects, num_timestamps, 3,
                                              device=device))

    def forward(self, raw_tracks: torch.Tensor) -> torch.Tensor:
        """raw_tracks: [N_obj, T, F] (the layout of `models/objects.py`).
        Returns the refined tracks: centre += opt_t, theta_z += opt_r."""
        return torch.cat([raw_tracks[..., :3] + self.opt_t,
                          raw_tracks[..., 3:4] + self.opt_r,
                          raw_tracks[..., 4:]], dim=-1)
