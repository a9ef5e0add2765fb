"""The ZipNeRF MLP family (port of `nerf_lidar_tpu/models/mlp.py:ZipMLP`):
the NeRF, proposal and object MLPs.

Per call: contract the multisample Gaussians (not for object MLPs, whose
points are already in their unit box) -> hash-grid encode with erf
downweighting, or without it (`re_weights=False`: object MLPs, stds taken
as 0, where H1's weight is exactly 1) (kernel H1 on CUDA, its backward
kernel in training) -> density trunk (+ the object latent's first half
with `split_latent`; + density noise in training) -> softplus; for the
NeRF level also the semantic head (v3 separate layers, v4 in-density
channels, or a fixed one-hot class for object MLPs), the intensity head
and the view-dependent RGB branch (posenc viewdirs, the latent's second
half, the skip concat, sigmoid, padding).

Parameter names follow the Flax module (`table`, `density_layers_{i}` ->
`density_layers.{i}`, ...), so `convert.flax_to_state_dict` is a rename and
a transpose. Config flags this port does not implement raise
NotImplementedError instead of computing something else.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import MLPConfig
from ..ops import coord
from ..ops import grid as gridlib

# MLPConfig flags this port does not implement, each with its ported value.
_PORTED_VALUES = dict(
    use_directional_enc=False, use_reflections=False,
    enable_pred_normals=False, enable_pred_roughness=False,
    use_n_dot_v=False, use_diffuse_color=False, use_specular_tint=False,
    disable_density_normals=True, num_glo_features=0,
    scale_featurization=False, ms_coarse_res_cutoff=0,
    compute_dtype="float32")


def check_ported(cfg: MLPConfig) -> None:
    """Raise NotImplementedError on any flag this port does not implement."""
    for name, ported in _PORTED_VALUES.items():
        if getattr(cfg, name) != ported:
            raise NotImplementedError(
                f"MLPConfig.{name}={getattr(cfg, name)!r} is not ported "
                f"(only {ported!r})")
    g = cfg.grid
    if g.encoder != "hash" or g.interp != "linear" or not g.diff_inputs:
        raise NotImplementedError(
            f"grid encoder={g.encoder!r} interp={g.interp!r} "
            f"diff_inputs={g.diff_inputs} is not ported (only 'hash', "
            "'linear', diff_inputs=True)")
    if cfg.warp_fn not in (None, "contract"):
        raise NotImplementedError(f"warp_fn={cfg.warp_fn!r} is not ported")


class Dense(nn.Linear):
    """nn.Linear whose parameters start uninitialised: `init_weights` or a
    converted state dict fills them, never the global RNG."""

    def reset_parameters(self) -> None:
        pass


def _fill_(param: torch.Tensor, sample) -> None:
    """Draw `param` on the CPU with `sample(cpu_tensor)` and copy it in, so
    one CPU generator gives the same weights on every device."""
    cpu = torch.empty(param.shape, dtype=param.dtype)
    sample(cpu)
    param.copy_(cpu)


def _lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    """Flax lecun_normal: truncated normal (+-2 std), variance 1/fan_in."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    _fill_(w, lambda t: nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                              generator=g))


def _kaiming_uniform_(w: torch.Tensor, g: torch.Generator) -> None:
    """Flax kaiming_uniform: uniform(+-sqrt(6/fan_in))."""
    limit = math.sqrt(6.0 / w.shape[1])
    _fill_(w, lambda t: nn.init.uniform_(t, -limit, limit, generator=g))


def latent_split(cfg: MLPConfig, latent_width: int):
    """(density, view) slices of a `latent_width`-wide latent, as the JAX
    MLP takes them: with `split_latent` the first `cfg.latent_size // 2`
    channels go to the density trunk and the rest to the view branch (so
    an MLP whose own latent_size is 0, as the presets' object MLPs, feeds
    the whole model latent to the view branch); else all to the trunk."""
    if not cfg.split_latent:
        return slice(0, latent_width), slice(0, 0)
    half = cfg.latent_size // 2
    return slice(0, half), slice(half, None)


def _width(sl: slice, n: int) -> int:
    return len(range(n)[sl])


class ZipMLP(nn.Module):
    """latent_width: the width of the per-sample latent the caller passes
    (the model's object latents), 0 for none."""

    def __init__(self, cfg: MLPConfig, use_viewdirs: bool = True,
                 device=None, latent_width: int = 0):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.latent_width = latent_width
        self.spec = gridlib.spec_for(cfg.grid)
        self.table = nn.Parameter(torch.empty(
            (self.spec.total_rows, self.spec.level_dim), dtype=torch.float32,
            device=device))

        dens_lat, view_lat = (_width(sl, latent_width)
                              for sl in latent_split(cfg, latent_width))
        width_out = 1 if cfg.disable_rgb else cfg.bottleneck_width
        if cfg.obj_mode:
            trunk = (32,)
        elif cfg.complex_decoder:
            trunk = (128, 128, 128)
        else:
            trunk = (64,)
        dims = (self.spec.output_dim + dens_lat, *trunk, width_out)
        self.density_layers = nn.ModuleList(
            Dense(a, b, device=device) for a, b in zip(dims[:-1], dims[1:]))
        if cfg.disable_rgb:
            return

        w = cfg.bottleneck_width
        if cfg.use_semantic and not cfg.no_sem_layer \
                and not cfg.fixed_semantic:
            self.sem_layers = nn.ModuleList(
                [Dense(w, 64, device=device),
                 Dense(64, cfg.class_num, device=device)])
        if cfg.use_intensity:
            self.intensity_layers = nn.ModuleList(
                [Dense(w, 64, device=device), Dense(64, 1, device=device)])
        in_w = w + (3 + 6 * cfg.deg_view if use_viewdirs else 0) + view_lat
        h_w, view = in_w, []
        for i in range(cfg.net_depth_viewdirs):
            view.append(Dense(h_w, cfg.net_width_viewdirs, device=device))
            h_w = cfg.net_width_viewdirs + (in_w if i == cfg.skip_layer_dir
                                            else 0)
        self.view_layers = nn.ModuleList(view)
        self.rgb_layer = Dense(h_w, cfg.num_rgb_channels, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The Flax init: table uniform(+-1e-4), Dense lecun-normal, view
        layers kaiming-uniform, zero biases (0.1 on the density output with
        `density_init`)."""
        _fill_(self.table, lambda t: nn.init.uniform_(t, -1e-4, 1e-4,
                                                      generator=generator))
        for name, layer in self.named_modules():
            if not isinstance(layer, Dense):
                continue
            if name.startswith("view_layers"):
                _kaiming_uniform_(layer.weight, generator)
            else:
                _lecun_normal_(layer.weight, generator)
            layer.bias.zero_()
        if self.cfg.density_init:
            self.density_layers[-1].bias.fill_(0.1)

    def _encode(self, means, stds, use_kernels: bool) -> torch.Tensor:
        """Contract + hash-encode + erf-downweight the multisample cloud.
        means: [..., n, 3] world coords; stds: [..., n]. Returns [..., F]."""
        if self.cfg.warp_fn is not None:
            means, stds = coord.track_linearize(self.cfg.warp_fn, means, stds)
            bound = 2.0  # contraction lands in [-2, 2]
            means = means / bound
            stds = stds / bound
        x01 = (means + 1.0) / 2.0
        if not self.cfg.re_weights:
            # No erf downweighting: at stds = 0 the weight is exactly 1, so
            # the encode is the mean of the n points' plain encodings.
            stds = torch.zeros_like(stds)
        if use_kernels:
            return gridlib.hash_encode_multisample(self.table, x01, stds,
                                                   self.spec)
        return gridlib.hash_encode_multisample_plain(self.table, x01, stds,
                                                     self.spec)[0]

    def forward(self, means: torch.Tensor, stds: torch.Tensor,
                viewdirs: Optional[torch.Tensor] = None,
                latent: Optional[torch.Tensor] = None,
                use_kernels: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Optional[torch.Tensor]]:
        """means: [..., S, n, 3], stds: [..., S, n]; viewdirs: [..., 3] per
        ray or [..., S, 3] per sample; latent: [..., S, latent_width] or
        None; generator: draws the density and bottleneck noise (training),
        or None for none. Returns dict(density [..., S], rgb [..., S, 3],
        semantic [..., S, K] or None, intensity [..., S, 1] or None)."""
        c = self.cfg
        x = self._encode(means, stds, use_kernels)
        dens_lat, view_lat = latent_split(c, self.latent_width)
        if latent is not None:
            x = torch.cat([x, latent[..., dens_lat]], dim=-1)
        for i, layer in enumerate(self.density_layers):
            x = layer(x)
            if i != len(self.density_layers) - 1:
                x = F.relu(x)
        raw_density = x[..., 0]
        if generator is not None and c.density_noise > 0:
            raw_density = raw_density + c.density_noise * torch.randn(
                raw_density.shape, generator=generator,
                device=raw_density.device)
        density = F.softplus(raw_density + c.density_bias)
        out = dict(density=density, rgb=None, semantic=None, intensity=None)
        if c.disable_rgb:
            out["rgb"] = density.new_zeros(density.shape + (3,))
            return out

        if c.use_semantic and c.fixed_semantic:
            # A constant class, which takes no gradient (none for 255; an
            # id past the head is dropped, as JAX's scatter drops it).
            sem = x.new_zeros(x.shape[:-1] + (c.class_num,))
            if 0 <= c.class_type < c.class_num:
                sem[..., c.class_type] = 1.0
            out["semantic"] = sem
        elif c.use_semantic:
            if c.no_sem_layer:
                sem = x[..., 1:1 + c.class_num]  # v4: in-density channels
            else:
                sem = self.sem_layers[1](F.relu(self.sem_layers[0](x)))
            out["semantic"] = torch.softmax(sem, dim=-1)
        if c.use_intensity:
            out["intensity"] = self.intensity_layers[1](
                F.relu(self.intensity_layers[0](x)))

        bottleneck = x
        if generator is not None and c.bottleneck_noise > 0:
            bottleneck = bottleneck + c.bottleneck_noise * torch.randn(
                bottleneck.shape, generator=generator, device=x.device)

        def per_sample(v):
            """A per-ray [..., D] or per-sample [..., S, D] field as
            [..., S, D]."""
            if v.dim() != x.dim():
                v = v[..., None, :]
            return v.expand(x.shape[:-1] + v.shape[-1:])

        parts = [bottleneck]
        if viewdirs is not None:
            parts.append(per_sample(coord.pos_enc(
                viewdirs, min_deg=0, max_deg=c.deg_view,
                append_identity=True)))
        if latent is not None and c.split_latent:
            parts.append(per_sample(latent[..., view_lat]))
        h = inputs = torch.cat(parts, dim=-1)
        for i, layer in enumerate(self.view_layers):
            h = F.relu(layer(h))
            if i == c.skip_layer_dir:
                h = torch.cat([h, inputs], dim=-1)
        rgb = torch.sigmoid(c.rgb_premultiplier * self.rgb_layer(h)
                            + c.rgb_bias)
        out["rgb"] = rgb * (1 + 2 * c.rgb_padding) - c.rgb_padding
        return out
