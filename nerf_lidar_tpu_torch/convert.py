"""Weights carried across from the JAX package.

`flax_to_state_dict` maps the `{'params': {'nerf_mlp': ..., 'prop_mlps_0':
..., ...}}` tree that the JAX `Model.init` returns (leaves as numpy arrays)
onto the port `Model`'s state dict: a Dense `kernel [in, out]` becomes a
Linear `weight [out, in]`, `bias` and `table` are copied as they are, and
`density_layers_3` becomes `density_layers.3`. Every Flax leaf must be used
and every torch parameter filled, or it raises.

`load_npz_params` reads the same tree from a flat `.npz` keyed by
'/'-joined Flax paths (`params/nerf_mlp/table`, ...), which is what the
CLI's `--params` takes; `save_npz_params` writes that layout.
`state_dict_to_flax` is the inverse of `flax_to_state_dict`, so a field
the port trains loads in both packages.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch

from .configs import ModelConfig
from .models.model import Model

_LIST_LAYER = re.compile(r"(density_layers|sem_layers|intensity_layers|"
                         r"view_layers)_(\d+)")
_PROP_MLP = re.compile(r"prop_mlps_(\d+)")


def flatten_params(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {'a/b/c': array}."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            flat.update(flatten_params(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def unflatten_params(flat: Dict[str, np.ndarray]) -> dict:
    """{'a/b/c': array} -> nested dict."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def load_npz_params(path: str) -> dict:
    """Read a Flax param tree saved as a flat '/'-keyed .npz."""
    with np.load(path) as z:
        return unflatten_params({k: z[k] for k in z.files})


def save_npz_params(path: str, params: dict) -> str:
    """Write a Flax param tree as a flat '/'-keyed .npz (written under a
    temporary name, then renamed, so a cut write leaves no file)."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flatten_params(params))
    os.replace(tmp, path)
    return path


def _torch_name(flax_path: str) -> str:
    """'nerf_mlp/density_layers_0/kernel' -> 'nerf_mlp.density_layers.0.weight'."""
    parts = flax_path.split("/")
    module = parts[0]
    m = _PROP_MLP.fullmatch(module)
    if m:
        module = f"prop_mlps.{m.group(1)}"
    elif module != "nerf_mlp":
        raise KeyError(f"Flax module {parts[0]!r} is not ported")
    if parts[1:] == ["table"]:
        return f"{module}.table"
    if len(parts) != 3 or parts[2] not in ("kernel", "bias"):
        raise KeyError(f"unexpected Flax leaf {flax_path!r}")
    m = _LIST_LAYER.fullmatch(parts[1])
    layer = f"{m.group(1)}.{m.group(2)}" if m else parts[1]
    return f"{module}.{layer}.{'weight' if parts[2] == 'kernel' else 'bias'}"


def flax_to_state_dict(params: dict, model_cfg: ModelConfig
                       ) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) -> state dict of `Model(model_cfg)`."""
    tree = params["params"] if "params" in params else params
    expected = Model(model_cfg, device="meta").state_dict()
    out = {}
    for path, value in flatten_params(tree).items():
        name = _torch_name(path)
        if name not in expected:
            raise KeyError(f"Flax leaf {path!r} -> {name!r} has no torch "
                           "parameter")
        value = np.array(value, np.float32)
        if path.endswith("/kernel"):
            value = value.T
        if tuple(value.shape) != tuple(expected[name].shape):
            raise ValueError(f"{path}: shape {value.shape} does not match "
                             f"{name} {tuple(expected[name].shape)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(value))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"torch parameters with no Flax leaf: {missing}")
    return out


def _flax_path(torch_name: str) -> str:
    """'nerf_mlp.density_layers.0.weight' -> 'nerf_mlp/density_layers_0/kernel'
    (the inverse of `_torch_name`)."""
    parts = torch_name.split(".")
    if parts[0] == "prop_mlps":
        module, rest = f"prop_mlps_{parts[1]}", parts[2:]
    else:
        module, rest = parts[0], parts[1:]
    if rest == ["table"]:
        return f"{module}/table"
    *layer, leaf = rest
    return "/".join([module, "_".join(layer),
                     "kernel" if leaf == "weight" else leaf])


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """State dict of the port's `Model` -> {'params': Flax tree} with numpy
    leaves (Linear weights transposed back to Dense kernels)."""
    flat = {}
    for name, value in state_dict.items():
        v = value.detach().cpu().numpy()
        path = _flax_path(name)
        flat[path] = np.ascontiguousarray(v.T if path.endswith("/kernel")
                                          else v)
    return {"params": unflatten_params(flat)}
