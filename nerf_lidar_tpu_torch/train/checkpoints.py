"""Checkpoints of the port's training (counterpart of
`nerf_lidar_tpu/train/checkpoints.py`).

Each save writes two files into the experiment directory:
- `checkpoint_<step>.pt`: `torch.save` of {model, optimizer, step} and the
  pose / track refiners' parameters (`posenet`, `tracknet`) when training
  has them (the optimizer holds their groups), which `restore_checkpoint`
  resumes from;
- `params_<step>.npz`: the model alone as a Flax param tree in the flat
  '/'-keyed layout of `convert.load_npz_params`, which the port's
  `render_lidar --params` and the JAX `Model.apply` both read (as the JAX
  `restore_model_params` peels the model from a refinement run's tree).
The newest `keep` saves at or below `step` stay; older ones, and any from a
newer (rewound) history, are deleted, as the JAX package prunes.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

from .. import convert

_CKPT = re.compile(r"checkpoint_(\d+)\.pt$")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match,
                                               os.listdir(directory)) if m)


def params_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"params_{step}.npz")


def _refiners(posenet, tracknet):
    return {k: m for k, m in (("posenet", posenet), ("tracknet", tracknet))
            if m is not None}


def save_checkpoint(directory: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, step: int,
                    keep: int = 1, posenet: Optional[torch.nn.Module] = None,
                    tracknet: Optional[torch.nn.Module] = None
                    ) -> Tuple[str, str]:
    """Write checkpoint_<step>.pt and params_<step>.npz, then prune.
    Returns both paths."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"checkpoint_{step}.pt")
    tmp = f"{path}.tmp"
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "step": step,
                **{k: m.state_dict()
                   for k, m in _refiners(posenet, tracknet).items()}}, tmp)
    os.replace(tmp, path)
    npz = convert.save_npz_params(
        params_path(directory, step),
        convert.state_dict_to_flax(model.state_dict()))
    steps = _steps(directory)
    alive = [s for s in steps if s <= step][-keep:]
    for s in steps:
        if s not in alive:
            os.remove(os.path.join(directory, f"checkpoint_{s}.pt"))
            if os.path.exists(params_path(directory, s)):
                os.remove(params_path(directory, s))
    return path, npz


def latest_checkpoint(directory: str) -> Optional[str]:
    steps = _steps(directory)
    return (os.path.join(directory, f"checkpoint_{steps[-1]}.pt")
            if steps else None)


def restore_checkpoint(directory: str, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       posenet: Optional[torch.nn.Module] = None,
                       tracknet: Optional[torch.nn.Module] = None) -> int:
    """Load the newest checkpoint into model, optimizer and the refiners
    given; returns its step, or 0 (and leaves all unchanged) when there is
    none."""
    path = latest_checkpoint(directory)
    if path is None:
        return 0
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device)
    model.load_state_dict(state["model"])
    for key, module in _refiners(posenet, tracknet).items():
        module.load_state_dict(state[key])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])
