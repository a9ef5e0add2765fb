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
`AsyncCheckpointer` writes the same two files on a background thread from a
device-side snapshot, so that training goes on while they are written.

The JAX package's own checkpoints (`checkpoint_<step>.ckpt`, Flax msgpack of
its train state) are read too: `list_checkpoints`, `latest_checkpoint` and
`checkpoint_step` find them as the JAX functions do (natural sort), and
`restore_model_params` takes the model's Flax param tree from the newest
of either layout, decoded by the port's own `utils/msgpack.py`.
`restore_checkpoint` resumes training from the newer of the port's newest
`.pt` and the JAX package's newest `.ckpt` (the port's on a tie): from a
`.ckpt`, the model's and the refiners' params and each optax Adam group's
`mu` / `nu` / `count`, as torch Adam's `exp_avg` / `exp_avg_sq` / `step`
(both apply the same bias correction and add eps after the square root,
so the next update is the same).

`save_obj_mlp_params` / `restore_obj_mlp_params` carry one object MLP's
subtree (e.g. `obj_mlp_cls2`) between scenes in the JAX package's file
format (Flax `to_bytes` of the subtree).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
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


def _train_state(model, optimizer, step: int, posenet, tracknet) -> dict:
    """What checkpoint_<step>.pt holds (live tensors)."""
    return {"model": model.state_dict(),
            "optimizer": optimizer.state_dict(), "step": step,
            **{k: m.state_dict()
               for k, m in _refiners(posenet, tracknet).items()}}


def save_checkpoint(directory: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, step: int,
                    keep: int = 1, posenet: Optional[torch.nn.Module] = None,
                    tracknet: Optional[torch.nn.Module] = None
                    ) -> Tuple[str, str]:
    """Write checkpoint_<step>.pt and params_<step>.npz, then prune.
    Returns both paths."""
    return _write(directory, _train_state(model, optimizer, step, posenet,
                                          tracknet), step, keep)


def _write(directory: str, state: dict, step: int, keep: int
           ) -> Tuple[str, str]:
    """`state` (`_train_state`) into checkpoint_<step>.pt through a
    temporary file and an atomic rename, its model into
    params_<step>.npz; then prune to the newest `keep` saves."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"checkpoint_{step}.pt")
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    npz = convert.save_npz_params(
        params_path(directory, step),
        convert.state_dict_to_flax(state["model"]))
    steps = _steps(directory)
    alive = [s for s in steps if s <= step][-keep:]
    for s in steps:
        if s not in alive:
            os.remove(os.path.join(directory, f"checkpoint_{s}.pt"))
            if os.path.exists(params_path(directory, s)):
                os.remove(params_path(directory, s))
    return path, npz


def _map_tensors(tree, fn):
    """`tree` (dicts, lists, tuples of tensors and plain values) with fn
    applied to every tensor; a state dict's `_metadata` is kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        out = type(tree)((k, _map_tensors(v, fn)) for k, v in tree.items())
        if hasattr(tree, "_metadata"):
            out._metadata = tree._metadata
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


class AsyncCheckpointer:
    """Non-blocking checkpoint writer (the JAX `AsyncCheckpointer`).

    `save` snapshots the train state with device-side clones enqueued on
    the current stream, the one the next `optimizer.step()` runs on, so
    the in-place update cannot reach the snapshot; then a background
    thread waits for the clones (an event), copies them to pinned host
    memory on its own stream (never the default stream, in front of the
    training kernels) and writes the files as `save_checkpoint` does. One
    save is in flight at a time: `save` and `wait` join the previous one
    first, which bounds the extra device memory to one copy of the state
    and keeps the pruning in order. `wait` raises the writer's error."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stream = None
        self.paths: Tuple[Optional[str], Optional[str]] = (None, None)

    def save(self, directory: str, model: torch.nn.Module,
             optimizer: torch.optim.Optimizer, step: int, keep: int = 1,
             posenet: Optional[torch.nn.Module] = None,
             tracknet: Optional[torch.nn.Module] = None) -> None:
        self.wait()
        snapshot = _map_tensors(
            _train_state(model, optimizer, step, posenet, tracknet),
            lambda t: t.detach().clone())
        device = next(model.parameters()).device
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)

        def write():
            try:
                state = snapshot
                if event is not None:
                    with torch.cuda.stream(self._stream):
                        self._stream.wait_event(event)
                        state = _map_tensors(snapshot, lambda t: t.to(
                            "cpu", non_blocking=True))
                    self._stream.synchronize()
                self.paths = _write(directory, state, step, keep)
            except BaseException as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True,
                                        name=f"ckpt-{step}")
        self._thread.start()

    def wait(self) -> Tuple[Optional[str], Optional[str]]:
        """Join the save in flight, if any; raise its error here. Returns
        the paths of the last save written."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e
        return self.paths


def newest_checkpoint(directory: str) -> Tuple[Optional[str], int]:
    """(path, step) of the newest train state in `directory`: the port's
    `checkpoint_<step>.pt` or the JAX package's `checkpoint_<step>.ckpt`,
    whichever has the higher step; on a tie the port's own file. (None, 0)
    when there is neither."""
    found = [(checkpoint_step(n), 1, n)
             for n in list_checkpoints(directory, suffix=".pt")]
    found += [(checkpoint_step(n), 0, n) for n in list_checkpoints(directory)]
    if not found:
        return None, 0
    step, _, name = max(found)
    return os.path.join(directory, name), step


def _adam_state(tree) -> dict:
    """The one optax `scale_by_adam` state ({count, mu, nu}) inside an
    optax state tree (a chain of clips, Adam and its schedule)."""
    found = []

    def walk(t):
        if isinstance(t, dict):
            if {"count", "mu", "nu"} <= set(t):
                found.append(t)
                return
            for v in t.values():
                walk(v)

    walk(tree)
    if len(found) != 1:
        raise ValueError(f"{len(found)} Adam states where one was expected")
    return found[0]


def _jax_groups(params, opt_state) -> dict:
    """{group: (params, Adam state)} of a JAX train state: one group
    ("model") with the model's variables as params, or with refinement the
    `optax.multi_transform` groups, each Adam's moments peeled to its own
    group (the other groups' leaves are masked out)."""
    if not (isinstance(params, dict) and "model" in params):
        return {"model": (params, _adam_state(opt_state))}
    inner = opt_state["inner_states"]
    if set(inner) != set(params):
        raise ValueError(f"optimizer groups {sorted(inner)} do not match "
                         f"the params' {sorted(params)}")
    out = {}
    for g in params:
        adam = _adam_state(inner[g])
        out[g] = (params[g], dict(count=adam["count"], mu=adam["mu"][g],
                                  nu=adam["nu"][g]))
    return out


def _module_leaves(tree: dict, module: torch.nn.Module, model_cfg=None
                   ) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor} of `module` from its Flax tree: the scene
    model's variables through `convert` (every leaf used, every parameter
    filled, the shapes equal), or a refiner's {"params": {name: ...}}."""
    if model_cfg is not None:
        have = set(convert.flatten_params(tree.get("params", tree)))
        want = {convert.flax_path(k) for k in module.state_dict()}
        if have != want:
            raise ValueError(
                f"model leaves differ: only in the checkpoint "
                f"{sorted(have - want)[:5]}, only in the config "
                f"{sorted(want - have)[:5]}")
        return convert.flax_to_state_dict(tree, model_cfg)
    leaves = tree["params"]
    names = dict(module.named_parameters())
    if set(leaves) != set(names):
        raise ValueError(f"leaves {sorted(leaves)} do not match "
                         f"{sorted(names)}")
    out = {}
    for name, p in names.items():
        value = np.asarray(leaves[name], np.float32)
        if value.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {value.shape} does not match "
                             f"{tuple(p.shape)}")
        out[name] = torch.from_numpy(value.copy())
    return out


def _restore_jax_state(path: str, model, optimizer, posenet, tracknet
                       ) -> None:
    """A JAX train state into the model, the refiners and torch Adam: each
    group's params, and its Adam `mu`, `nu`, `count` as `exp_avg`,
    `exp_avg_sq`, `step`."""
    raw = msgpack.read_file(path)
    groups = _jax_groups(raw["params"], raw["opt_state"])
    modules = dict(model=model, posenet=posenet, tracknet=tracknet)
    names = [g.get("name", "model") for g in optimizer.param_groups]
    if sorted(names) != sorted(groups):
        raise ValueError(f"the checkpoint trains the groups "
                         f"{sorted(groups)}, this config {sorted(names)}")
    state = optimizer.state_dict()
    moments = {}
    # Each group holds its module's parameters in `named_parameters` order
    # (`train_step.make_optimizer`).
    for group, pg in zip(names, state["param_groups"]):
        module = modules[group]
        cfg = model.cfg if group == "model" else None
        tree, adam = groups[group]
        params = _module_leaves(tree, module, cfg)
        mu = _module_leaves(adam["mu"], module, cfg)
        nu = _module_leaves(adam["nu"], module, cfg)
        count = float(np.asarray(adam["count"]))
        with torch.no_grad():
            for idx, (name, p) in zip(pg["params"],
                                      module.named_parameters()):
                p.copy_(params[name])
                moments[idx] = dict(step=torch.tensor(count),
                                    exp_avg=mu[name], exp_avg_sq=nu[name])
    state["state"] = moments
    optimizer.load_state_dict(state)


def restore_checkpoint(directory: str, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       posenet: Optional[torch.nn.Module] = None,
                       tracknet: Optional[torch.nn.Module] = None) -> int:
    """Load the newest train state of `directory` (`newest_checkpoint`: the
    port's `.pt` or the JAX package's `.ckpt`) into model, optimizer and
    the refiners given; returns its step, or 0 (and leaves all unchanged)
    when there is none. A `.ckpt` whose tree does not match (other groups,
    leaves or shapes) raises ValueError naming the file and its step."""
    path, step = newest_checkpoint(directory)
    if path is None:
        return 0
    if path.endswith(".ckpt"):
        try:
            _restore_jax_state(path, model, optimizer, posenet, tracknet)
        except (KeyError, ValueError) as e:
            raise ValueError(f"{path} (step {step}) does not match this "
                             f"config: {e}") from e
        return step
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


def save_obj_mlp_params(model: torch.nn.Module, name: str, path: str) -> str:
    """One object MLP's subtree of the model's Flax tree (e.g.
    'obj_mlp_cls2') into a file, in the bytes the JAX
    `save_obj_mlp_params` writes (Flax `to_bytes`), so that a per-class
    object field trained in one scene can be transplanted into another
    (`train --obj_ckpt`) by either package. KeyError if the model has no
    such subtree."""
    sub = {k: v for k, v in model.state_dict().items()
           if convert.flax_module_of(k) == name}
    return msgpack.write_file(path,
                              convert.state_dict_to_flax(sub)["params"][name])


def restore_obj_mlp_params(model: torch.nn.Module, name: str,
                           path: str) -> None:
    """Load subtree `name` of the model from `path` (the inverse of
    `save_obj_mlp_params`, or the JAX package's file): KeyError, as in JAX,
    if the model has no such subtree; the structure and shapes must
    match."""
    names = convert.flax_module_names(model)
    if name not in names:
        raise KeyError(f"model has no obj MLP subtree '{name}'; have "
                       f"{names}")
    convert.load_flax_subtree(model, name, msgpack.read_file(path))
