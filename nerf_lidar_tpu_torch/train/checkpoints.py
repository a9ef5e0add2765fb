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

The JAX package's own checkpoints (`checkpoint_<step>.ckpt`, Flax msgpack of
its train state) are read too: `list_checkpoints`, `latest_checkpoint` and
`checkpoint_step` find them as the JAX functions do (natural sort), and
`restore_model_params` takes the model's Flax param tree from the newest
of either layout, decoded by the port's own `utils/msgpack.py`.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional, Tuple

import torch

from .. import convert
from ..utils import msgpack


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def list_checkpoints(directory: str, prefix: str = "checkpoint_",
                     suffix: str = ".ckpt") -> List[str]:
    """Names of `<prefix>*<suffix>` files in `directory`, natural-sorted
    (the JAX `list_checkpoints`, which knows only `.ckpt`)."""
    if not os.path.isdir(directory):
        return []
    names = [f for f in os.listdir(directory)
             if f.startswith(prefix) and f.endswith(suffix)]
    return sorted(names, key=_natural_key)


def latest_checkpoint(directory: str, prefix: str = "checkpoint_",
                      suffix: str = ".ckpt") -> Optional[str]:
    names = list_checkpoints(directory, prefix, suffix)
    return os.path.join(directory, names[-1]) if names else None


def checkpoint_step(path: str) -> int:
    """The step in a `..._<step>.{ckpt,pt,npz}` name, or -1."""
    m = re.search(r"(\d+)\.(ckpt|pt|npz)$", path)
    return int(m.group(1)) if m else -1


def _steps(directory: str) -> List[int]:
    return sorted(checkpoint_step(n)
                  for n in list_checkpoints(directory, suffix=".pt"))


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


def restore_checkpoint(directory: str, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       posenet: Optional[torch.nn.Module] = None,
                       tracknet: Optional[torch.nn.Module] = None) -> int:
    """Load the newest checkpoint into model, optimizer and the refiners
    given; returns its step, or 0 (and leaves all unchanged) when there is
    none."""
    path = latest_checkpoint(directory, suffix=".pt")
    if path is None:
        return 0
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device)
    model.load_state_dict(state["model"])
    for key, module in _refiners(posenet, tracknet).items():
        module.load_state_dict(state[key])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def newest_params(directory: str) -> Tuple[Optional[str], int]:
    """(path, step) of the newest model weights in `directory`: the port's
    `params_<step>.npz` or the JAX package's `checkpoint_<step>.ckpt`,
    whichever has the higher step; on a tie the port's own file. (None, 0)
    when there is neither."""
    found = [(checkpoint_step(n), 1, n)
             for n in list_checkpoints(directory, "params_", ".npz")]
    found += [(checkpoint_step(n), 0, n) for n in list_checkpoints(directory)]
    if not found:
        return None, 0
    step, _, name = max(found)
    return os.path.join(directory, name), step


def read_params(path: str) -> dict:
    """The model's Flax param tree from one file: the port's flat `.npz`,
    or a JAX msgpack `.ckpt` of a train state, whose `params` holds the
    model's variables directly (a plain run) or under "model" beside
    "posenet" / "tracknet" (a refinement run), as the JAX
    `restore_model_params` peels them."""
    if path.endswith(".npz"):
        return convert.load_npz_params(path)
    if not path.endswith(".ckpt"):
        raise ValueError(f"{path}: weights are a params_<step>.npz or a "
                         "JAX checkpoint_<step>.ckpt")
    params = msgpack.read_file(path)["params"]
    if isinstance(params, dict) and "model" in params:
        params = params["model"]
    return params


def restore_model_params(directory_or_path: str
                         ) -> Tuple[Optional[Any], int]:
    """The model's Flax param tree and its step (the JAX
    `restore_model_params`), from a file (`.npz` or `.ckpt`) or from the
    newest weights in a directory (`newest_params`: the higher step of the
    port's `params_<step>.npz` and the JAX `checkpoint_<step>.ckpt`, the
    port's file on a tie). (None, 0) when there is nothing to restore."""
    path = directory_or_path
    if os.path.isdir(path):
        path = newest_params(path)[0]
    if path is None or not os.path.exists(path):
        return None, 0
    return read_params(path), checkpoint_step(path)
