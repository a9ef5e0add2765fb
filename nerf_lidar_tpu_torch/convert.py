"""Weights carried across from the JAX package.

`flax_to_state_dict` maps the `{'params': {'nerf_mlp': ..., 'prop_mlps_0':
..., ...}}` tree that the JAX `Model.init` returns (leaves as numpy arrays)
onto the port `Model`'s state dict: a Dense `kernel [in, out]` becomes a
Linear `weight [out, in]`, `bias` and `table` are copied as they are, and
`density_layers_3` becomes `density_layers.3`; the GLO vectors and the
exposure offsets (Flax `nn.Embed`, `glo_vecs/embedding`,
`exposure_scaling_offsets/embedding`) become `glo_vecs.weight` /
`exposure_scaling_offsets.weight`. Every Flax leaf must be used and every
torch parameter filled, or it raises.

The object MLPs keep their Flax names (`obj_mlp`, `obj_mlp_cls{k}`), as
does `obj_latents`. A model built without objects (a scene rendered with
`--obj_mode removal`) ignores a tree's object leaves, as the JAX
`restore_model_params` + `Model.apply` do.

`load_npz_params` reads the same tree from a flat `.npz` keyed by
'/'-joined Flax paths (`params/nerf_mlp/table`, ...), which is what the
CLI's `--params` takes; `save_npz_params` writes that layout.
`state_dict_to_flax` is the inverse of `flax_to_state_dict`, so a field
the port trains loads in both packages.

`refiners_to_flax` / `load_refiners` carry the pose and track refinement
(`LearnPose` {r, t}, `TrackOpt` {opt_r, opt_t}), and `train_params_to_flax`
builds the combined {model, posenet?, tracknet?} tree of the JAX
`create_train_state`.

The ray-drop networks (`raydrop/`): `unet_to_flax` / `unet_from_flax`
carry the U-Net's `params` and `batch_stats` (Conv kernels [kh, kw, in,
out] <-> weights [out, in, kh, kw]; a Flax `ConvTranspose` kernel is
torch's `conv_transpose2d` weight [in, out, kh, kw] flipped in both spatial
axes; BatchNorm scale / bias / mean / var <-> weight / bias / running_mean
/ running_var), `vgg_to_flax` / `vgg_from_flax` the VGG19 trunk and
`darknet_to_flax` / `darknet_from_flax` Darknet-53.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch

from .configs import ModelConfig
from .models.model import Model
from .raydrop import darknet as dk_lib
from .raydrop import vgg as vgg_lib

_LIST_LAYER = re.compile(r"(density_layers|sem_layers|intensity_layers|"
                         r"view_layers|glo_layers)_(\d+)")
# Flax `nn.Embed` modules of the scene model: `<name>/embedding` <->
# `<name>.weight` (the same [num, features] layout).
_EMBEDS = ("glo_vecs", "exposure_scaling_offsets")
_PROP_MLP = re.compile(r"prop_mlps_(\d+)")
_OBJ_MLP = re.compile(r"obj_mlp(_cls\d+)?")


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
    if parts == ["obj_latents"]:
        return module
    if module in _EMBEDS and parts[1:] == ["embedding"]:
        return f"{module}.weight"
    m = _PROP_MLP.fullmatch(module)
    if m:
        module = f"prop_mlps.{m.group(1)}"
    elif module != "nerf_mlp" and not _OBJ_MLP.fullmatch(module):
        raise KeyError(f"Flax module {parts[0]!r} is not ported")
    if parts[1:] == ["table"]:
        return f"{module}.table"
    if len(parts) != 3 or parts[2] not in ("kernel", "bias"):
        raise KeyError(f"unexpected Flax leaf {flax_path!r}")
    m = _LIST_LAYER.fullmatch(parts[1])
    layer = f"{m.group(1)}.{m.group(2)}" if m else parts[1]
    return f"{module}.{layer}.{'weight' if parts[2] == 'kernel' else 'bias'}"


def _is_object_leaf(flax_path: str) -> bool:
    return flax_path == "obj_latents" or bool(
        _OBJ_MLP.fullmatch(flax_path.split("/")[0]))


def _leaf(path: str, value, expected: Dict[str, torch.Tensor]):
    """(torch name, float32 tensor) of one Flax leaf of the scene model: a
    Dense kernel transposed; KeyError if no tensor of `expected` takes it,
    ValueError if the shapes differ."""
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
    return name, torch.from_numpy(np.ascontiguousarray(value))


def flax_to_state_dict(params: dict, model_cfg: ModelConfig
                       ) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) -> state dict of `Model(model_cfg)`.
    A model without objects skips the tree's object leaves."""
    tree = params["params"] if "params" in params else params
    model = Model(model_cfg, device="meta")
    expected = model.state_dict()
    out = dict(_leaf(path, value, expected)
               for path, value in flatten_params(tree).items()
               if model.has_objects or not _is_object_leaf(path))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"torch parameters with no Flax leaf: {missing}")
    return out


def flax_path(torch_name: str) -> str:
    """'nerf_mlp.density_layers.0.weight' -> 'nerf_mlp/density_layers_0/kernel'
    (the inverse of `_torch_name`)."""
    parts = torch_name.split(".")
    if parts == ["obj_latents"]:
        return torch_name
    if parts[0] in _EMBEDS:
        return f"{parts[0]}/embedding"
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
        path = flax_path(name)
        flat[path] = np.ascontiguousarray(v.T if path.endswith("/kernel")
                                          else v)
    return {"params": unflatten_params(flat)}


def flax_module_of(torch_name: str) -> str:
    """The top-level Flax name of a parameter ('prop_mlps.0.table' ->
    'prop_mlps_0')."""
    return flax_path(torch_name).split("/")[0]


def flax_module_names(model: Model) -> list:
    """The top-level Flax names of the model's parameters (`nerf_mlp`,
    `prop_mlps_0`, `obj_mlp_cls2`, `obj_latents`, ...), sorted."""
    return sorted({flax_module_of(k) for k in model.state_dict()})


@torch.no_grad()
def load_flax_subtree(model: Model, name: str, subtree: dict) -> None:
    """Copy the Flax subtree of one top-level module (`name`, e.g.
    `obj_mlp_cls2`) into the model's parameters: every leaf used, every
    parameter of that module filled, the shapes equal, or it raises."""
    params = {k: p for k, p in model.named_parameters()
              if flax_module_of(k) == name}
    got = dict(_leaf(path, value, params)
               for path, value in flatten_params({name: subtree}).items())
    if set(got) != set(params):
        raise KeyError(f"parameters of {name} with no Flax leaf: "
                       f"{sorted(set(params) - set(got))}")
    for tname, value in got.items():
        params[tname].copy_(value)


def refiners_to_flax(posenet=None, tracknet=None) -> dict:
    """{"posenet": {"params": {r, t}}, "tracknet": {"params": {opt_r,
    opt_t}}} (numpy leaves) of the refiners given."""
    out = {}
    for key, module in (("posenet", posenet), ("tracknet", tracknet)):
        if module is not None:
            out[key] = {"params": {k: v.detach().cpu().numpy()
                                   for k, v in module.state_dict().items()}}
    return out


@torch.no_grad()
def load_refiners(tree: dict, posenet=None, tracknet=None) -> None:
    """Copy the refiners' Flax params (a `refiners_to_flax` /
    `create_train_state` tree) into the modules given."""
    for key, module in (("posenet", posenet), ("tracknet", tracknet)):
        if module is None:
            continue
        leaves = tree[key]["params"]
        for name, p in module.named_parameters():
            value = np.asarray(leaves[name], np.float32)
            if value.shape != tuple(p.shape):
                raise ValueError(f"{key}/{name}: shape {value.shape} does "
                                 f"not match {tuple(p.shape)}")
            p.copy_(torch.from_numpy(value))


def train_params_to_flax(model: Model, posenet=None, tracknet=None) -> dict:
    """The params tree of the JAX `create_train_state`: {"model": ...,
    "posenet"?, "tracknet"?} with refinement, the model's tree alone
    without."""
    tree = state_dict_to_flax(model.state_dict())
    refiners = refiners_to_flax(posenet, tracknet)
    return {"model": tree, **refiners} if refiners else tree


# ------------------------------------------------------------- ray-drop
def _double_conv(tname: str, fpath: str):
    return [(f"{tname}.conv1", f"{fpath}/Conv_0"),
            (f"{tname}.bn1", f"{fpath}/BatchNorm_0"),
            (f"{tname}.conv2", f"{fpath}/Conv_1"),
            (f"{tname}.bn2", f"{fpath}/BatchNorm_1")]


def _unet_pairs(model):
    """(torch module name, Flax module path) of every leaf module of a
    `raydrop.unet.UNet`, in the Flax `UNet`'s automatic names."""
    pairs = _double_conv("inc", "DoubleConv_0")
    for k in range(4):
        pairs += _double_conv(f"down{k + 1}.conv", f"Down_{k}/DoubleConv_0")
        if model.bilinear:
            pairs += _double_conv(f"up{k + 1}.up", f"Up_{k}/DoubleConv_0")
            pairs += _double_conv(f"up{k + 1}.conv", f"Up_{k}/DoubleConv_1")
        else:
            pairs.append((f"up{k + 1}.up", f"Up_{k}/ConvTranspose_0"))
            pairs += _double_conv(f"up{k + 1}.conv", f"Up_{k}/DoubleConv_0")
    pairs.append(("outc", "Conv_0"))
    if model.regression:
        pairs.append(("regc", "Conv_1"))
    return pairs


def _vgg_pairs():
    return [(f"convs.{n}", n) for n in vgg_lib.conv_names()]


def _darknet_pairs():
    pairs = [("conv1", "conv1"), ("bn1", "bn1")]
    for si, blocks in enumerate(dk_lib._BLOCKS_53):
        t = f"enc{si + 1}"
        pairs += [(f"{t}.conv", f"enc{si}_down"), (f"{t}.bn", f"enc{si}_bn")]
        for bi in range(blocks):
            pairs += _double_conv(f"{t}.residual_{bi}", f"enc{si}_res{bi}")
    return pairs


def _leaves(module: torch.nn.Module):
    """(collection, Flax leaf, torch attribute, to Flax, from Flax) of one
    conv or BatchNorm module."""
    if isinstance(module, torch.nn.ConvTranspose2d):
        k = ("params", "kernel", "weight",
             lambda w: w.transpose(2, 3, 0, 1)[::-1, ::-1],
             lambda k: k[::-1, ::-1].transpose(2, 3, 0, 1))
    elif isinstance(module, torch.nn.Conv2d):
        k = ("params", "kernel", "weight", lambda w: w.transpose(2, 3, 1, 0),
             lambda k: k.transpose(3, 2, 0, 1))
    elif isinstance(module, torch.nn.BatchNorm2d):
        same = lambda v: v  # noqa: E731
        return [("params", "scale", "weight", same, same),
                ("params", "bias", "bias", same, same),
                ("batch_stats", "mean", "running_mean", same, same),
                ("batch_stats", "var", "running_var", same, same)]
    else:
        raise TypeError(f"no Flax layout for {type(module).__name__}")
    out = [k]
    if module.bias is not None:
        out.append(("params", "bias", "bias", lambda v: v, lambda v: v))
    return out


def _to_flax(model: torch.nn.Module, pairs) -> dict:
    flat = {}
    for tname, fpath in pairs:
        module = model.get_submodule(tname)
        for coll, fleaf, attr, to_f, _ in _leaves(module):
            v = getattr(module, attr).detach().cpu().numpy()
            flat[f"{coll}/{fpath}/{fleaf}"] = np.ascontiguousarray(to_f(v))
    return unflatten_params(flat)


def _from_flax(tree: dict, model: torch.nn.Module, pairs
               ) -> Dict[str, torch.Tensor]:
    """Every Flax leaf must be used and every torch tensor of the state
    dict (but `num_batches_tracked`) filled, or it raises."""
    flat = flatten_params(tree)
    expected = model.state_dict()
    out, used = {}, set()
    for tname, fpath in pairs:
        for coll, fleaf, attr, _, from_f in _leaves(
                model.get_submodule(tname)):
            key = f"{coll}/{fpath}/{fleaf}"
            name = f"{tname}.{attr}"
            value = np.array(from_f(np.asarray(flat[key], np.float32)),
                             np.float32, order="C")
            if tuple(value.shape) != tuple(expected[name].shape):
                raise ValueError(f"{key}: shape {value.shape} does not "
                                 f"match {name} "
                                 f"{tuple(expected[name].shape)}")
            out[name] = torch.from_numpy(value)
            used.add(key)
    unused = sorted(set(flat) - used)
    missing = sorted(k for k in set(expected) - set(out)
                     if not k.endswith("num_batches_tracked"))
    if unused or missing:
        raise KeyError(f"Flax leaves not used: {unused[:5]}; torch tensors "
                       f"not filled: {missing[:5]}")
    for k in expected:
        if k.endswith("num_batches_tracked"):
            out[k] = expected[k]
    return out


def unet_to_flax(model) -> dict:
    """`raydrop.unet.UNet` -> {'params': ..., 'batch_stats': ...} of the
    Flax `UNet` (numpy leaves)."""
    return _to_flax(model, _unet_pairs(model))


def unet_from_flax(tree: dict, model) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} of the Flax `UNet` -> the state dict of
    `model` (a `raydrop.unet.UNet` of the same shape)."""
    return _from_flax(tree, model, _unet_pairs(model))


def vgg_to_flax(model) -> dict:
    """`raydrop.vgg.Vgg19Features` -> {'params': {s0_c0: ...}}."""
    return _to_flax(model, _vgg_pairs())


def vgg_from_flax(tree: dict, model) -> Dict[str, torch.Tensor]:
    return _from_flax(tree, model, _vgg_pairs())


def darknet_to_flax(model) -> dict:
    """`raydrop.darknet.DarknetBackbone` -> {'params', 'batch_stats'} of
    the Flax `DarknetBackbone`."""
    return _to_flax(model, _darknet_pairs())


def darknet_from_flax(tree: dict, model) -> Dict[str, torch.Tensor]:
    return _from_flax(tree, model, _darknet_pairs())
