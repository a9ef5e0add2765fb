"""The ZipNeRF MLP family (port of `nerf_lidar_tpu/models/mlp.py:ZipMLP`):
the NeRF, proposal and object MLPs.

Per call: contract the multisample Gaussians (not for object MLPs, whose
points are already in their unit box) -> hash-grid encode with erf
downweighting (levels at or below `ms_coarse_res_cutoff` at the
multisample mean), or without it (`re_weights=False`: object MLPs, stds
taken as 0, where H1's weight is exactly 1) (kernel H1 on CUDA, its
backward kernel in training) -> with the spectral encoder
(`encoder='dense_fourier'`) the Fourier features of `ops/fourier.py`
appended -> with `scale_featurization` the mean erf weight of each level
scaled by the level's root-mean-square embedding (detached; the level sums
through K3, as the hash decay) -> density trunk (+ the object latent's
first half with `split_latent`; + density noise in training) -> softplus;
with density normals (`disable_density_normals=False`) the density
trunk again at the six points +-`normal_eps` along each axis (six more H1
calls), central differences, normalised; the predicted-normal head. For
the NeRF level also the semantic head (v3 separate layers, v4
in-density channels, or a fixed one-hot class for object MLPs), the
intensity head and the view-dependent RGB branch: the GLO scale and shift
of the bottleneck, the direction encoding (posenc, or the IDE of
`ops/ref_utils.py` with the predicted roughness) of the view or
reflection direction, n . v, the latent's second half, the skip concat,
sigmoid, the diffuse-plus-specular tone map, padding.

`compute_dtype='bfloat16'` is the JAX mixed-precision policy: parameters
stay float32 and every Dense casts its input, weight and bias to bfloat16
per call (flax `Dense(dtype=bfloat16)`), so the trunk, the heads' hidden
layers and the RGB branch run in bfloat16; the encode, the raw density
and its softplus, every head's output (softmax, sigmoid, intensity) and
the compositing stay float32.

Parameter names follow the Flax module (`table`, `density_layers_{i}` ->
`density_layers.{i}`, `normal_layer`, `glo_layers_{i}`, ...), so
`convert.flax_to_state_dict` is a rename and a transpose. A layer exists
where the Flax module creates its parameters, i.e. where it is called: the
GLO layers only on the MLP given GLO vectors (`glo_width`). Config flags
this port does not implement raise NotImplementedError instead of
computing something else.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import MLPConfig
from ..ops import coord, mathx, ref_utils
from ..ops import fourier as fourierlib
from ..ops import grid as gridlib
from ..utils.image import linear_to_srgb

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_ported(cfg: MLPConfig) -> None:
    """Raise NotImplementedError on any flag this port does not implement."""
    if cfg.compute_dtype not in _DTYPES:
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r} is not ported")
    if cfg.warp_fn not in (None, "contract"):
        raise NotImplementedError(f"warp_fn={cfg.warp_fn!r} is not ported")


class Dense(nn.Linear):
    """nn.Linear whose parameters start uninitialised: `init_weights` or a
    converted state dict fills them, never the global RNG. With a
    `dtype` other than float32 it computes as flax `Dense(dtype=...)`:
    input, weight and bias cast to it per call, the product rounded to it
    before the bias is added (the parameters stay float32)."""

    def __init__(self, *args, dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        pass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        return (torch.matmul(x.to(dt), self.weight.to(dt).t())
                + self.bias.to(dt))


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


def _l2_normalize(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=eps)


def _per_sample(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-ray [..., D] or per-sample [..., S, D] field as [..., S, D]
    (the sample axis of `like` [..., S, W])."""
    if v.dim() != like.dim():
        v = v[..., None, :]
    return v.expand(like.shape[:-1] + v.shape[-1:])


class ZipMLP(nn.Module):
    """latent_width: the width of the per-sample latent the caller passes
    (the model's object latents), 0 for none; glo_width: the width of the
    GLO vectors the caller passes (the model's `num_glo_features` for the
    NeRF MLP), 0 for none."""

    def __init__(self, cfg: MLPConfig, use_viewdirs: bool = True,
                 device=None, latent_width: int = 0, glo_width: int = 0):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.latent_width = latent_width
        self.spec = gridlib.spec_for(cfg.grid)
        self.table = nn.Parameter(torch.empty(
            (self.spec.total_rows, self.spec.level_dim), dtype=torch.float32,
            device=device))
        dt = _DTYPES[cfg.compute_dtype]
        feat_w = self.spec.output_dim
        self.register_buffer("fourier_freqs", None, persistent=False)
        if cfg.grid.encoder == "dense_fourier":
            # The JAX MLP draws the matrix at every init from PRNGKey(7) and
            # never stores it: a buffer outside the state dict.
            self.fourier_freqs = torch.from_numpy(
                fourierlib.make_frequency_matrix(
                    7, cfg.grid.fourier_freqs,
                    float(self.spec.desired_resolution),
                    float(cfg.grid.desired_resolution))).to(device)
            feat_w += 2 * cfg.grid.fourier_freqs
        if cfg.scale_featurization:
            feat_w += self.spec.num_levels

        dens_lat, view_lat = (_width(sl, latent_width)
                              for sl in latent_split(cfg, latent_width))
        width_out = 1 if cfg.disable_rgb else cfg.bottleneck_width
        if cfg.obj_mode:
            trunk = (32,)
        elif cfg.complex_decoder:
            trunk = (128, 128, 128)
        else:
            trunk = (64,)
        dims = (feat_w + dens_lat, *trunk, width_out)
        self.density_layers = nn.ModuleList(
            Dense(a, b, device=device, dtype=dt)
            for a, b in zip(dims[:-1], dims[1:]))
        if cfg.enable_pred_normals:
            self.normal_layer = Dense(width_out, 3, device=device, dtype=dt)
        self.ide = (ref_utils.generate_ide_fn(cfg.deg_view, device)
                    if cfg.use_directional_enc else None)
        if cfg.disable_rgb:
            return

        w = cfg.bottleneck_width
        if glo_width > 0 and cfg.num_glo_features > 0:
            glo_dims = (glo_width,
                        *[cfg.net_width_glo] * (cfg.net_depth_glo - 1),
                        2 * w)
            self.glo_layers = nn.ModuleList(
                Dense(a, b, device=device, dtype=dt)
                for a, b in zip(glo_dims[:-1], glo_dims[1:]))
        for flag, name, out_w in (
                (cfg.use_diffuse_color, "diffuse_layer", cfg.num_rgb_channels),
                (cfg.use_specular_tint, "specular_layer", 3),
                (cfg.enable_pred_roughness, "roughness_layer", 1)):
            if flag:
                setattr(self, name, Dense(w, out_w, device=device, dtype=dt))
        if cfg.use_semantic and not cfg.no_sem_layer \
                and not cfg.fixed_semantic:
            self.sem_layers = nn.ModuleList(
                [Dense(w, 64, device=device, dtype=dt),
                 Dense(64, cfg.class_num, device=device, dtype=dt)])
        if cfg.use_intensity:
            self.intensity_layers = nn.ModuleList(
                [Dense(w, 64, device=device, dtype=dt),
                 Dense(64, 1, device=device, dtype=dt)])
        dir_w = 0
        if use_viewdirs:
            dir_w = (ref_utils.ide_width(cfg.deg_view) if self.ide is not None
                     else 3 + 6 * cfg.deg_view) + int(cfg.use_n_dot_v)
        in_w = w + dir_w + view_lat
        h_w, view = in_w, []
        for i in range(cfg.net_depth_viewdirs):
            view.append(Dense(h_w, cfg.net_width_viewdirs, device=device,
                              dtype=dt))
            h_w = cfg.net_width_viewdirs + (in_w if i == cfg.skip_layer_dir
                                            else 0)
        self.view_layers = nn.ModuleList(view)
        self.rgb_layer = Dense(h_w, cfg.num_rgb_channels, device=device,
                               dtype=dt)

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

    def _level_rms(self, use_kernels: bool) -> torch.Tensor:
        """[L] root of 1e-8 + each level's mean squared embedding, detached:
        the level sums of table**2 over the rows' level ids (kernel K3 on
        CUDA tables, as the hash decay)."""
        spec, table = self.spec, self.table
        scatter = (gridlib.scatter_add_rows if use_kernels
                   else gridlib.scatter_add_rows_plain)
        with torch.no_grad():
            sums = scatter(gridlib.level_ids(spec, table.device), table**2,
                           spec.num_levels).sum(-1)
            mean = sums / gridlib.level_rows(spec, table.device)[:, 0]
        return torch.sqrt(1e-8 + mean)

    def _encode(self, means, stds, use_kernels: bool) -> torch.Tensor:
        """Contract + hash-encode + erf-downweight the multisample cloud
        (+ the Fourier features of a spectral grid, + the scale
        featurization). means: [..., n, 3] world coords; stds: [..., n].
        Returns [..., F]."""
        c = self.cfg
        if c.warp_fn is not None:
            means, stds = coord.track_linearize(c.warp_fn, means, stds)
            bound = 2.0  # contraction lands in [-2, 2]
            means = means / bound
            stds = stds / bound
        x01 = (means + 1.0) / 2.0
        cutoff, enc_stds = c.ms_coarse_res_cutoff, stds
        if not c.re_weights:
            # No erf downweighting (the JAX `hash_encode`, which has no
            # coarse cutoff): at stds = 0 the weight is exactly 1, so the
            # encode is the mean of the n points' plain encodings.
            cutoff, enc_stds = 0, torch.zeros_like(stds)
        if use_kernels:
            feats = gridlib.hash_encode_multisample(self.table, x01, enc_stds,
                                                    self.spec, cutoff)
        else:
            feats = gridlib.hash_encode_multisample_plain(
                self.table, x01, enc_stds, self.spec, cutoff)[0]
        if self.fourier_freqs is not None:
            enc = (fourierlib.fourier_encode_pooled if c.grid.fourier_pooled
                   else fourierlib.fourier_encode)
            feats = torch.cat([feats, enc(x01, stds, self.fourier_freqs)],
                              dim=-1)
        if c.scale_featurization:
            weights = (gridlib.erf_weights(stds, self.spec) if c.re_weights
                       else stds.new_ones(stds.shape
                                          + (self.spec.num_levels,)))
            feats = torch.cat([feats, (2 * weights.mean(dim=-2) - 1)
                               * self._level_rms(use_kernels)], dim=-1)
        return feats

    def predict_density(self, means: torch.Tensor, stds: torch.Tensor,
                        latent: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        use_kernels: bool = True):
        """The density trunk: encode (+ the latent's density slice) ->
        density layers. Returns (raw density [..., S] in float32, before
        the bias and softplus, with density noise when `generator` is
        given; the trunk's output x [..., W], the bottleneck)."""
        c = self.cfg
        x = self._encode(means, stds, use_kernels)
        if latent is not None:
            dens_lat = latent_split(c, self.latent_width)[0]
            x = torch.cat([x, latent[..., dens_lat]], dim=-1)
        for i, layer in enumerate(self.density_layers):
            x = layer(x)
            if i != len(self.density_layers) - 1:
                x = F.relu(x)
        raw_density = x[..., 0].float()
        if generator is not None and c.density_noise > 0:
            raw_density = raw_density + c.density_noise * mathx.random_rows(
                torch.randn, raw_density.shape, generator,
                device=raw_density.device)
        return raw_density, x

    def finite_difference_normals(self, means: torch.Tensor,
                                  stds: torch.Tensor,
                                  use_kernels: bool = True) -> torch.Tensor:
        """Density normals by central differences of the raw density over
        the multisample means, one trunk call per offset +-normal_eps along
        each axis (as the JAX MLP makes them), normalised, NaN -> 0."""
        eps = self.cfg.normal_eps
        grads = []
        for d in range(3):
            offs = means.new_zeros(3)
            offs[d] = eps
            pos = self.predict_density(torch.clamp(means + offs, -1e6, 1e6),
                                       stds, use_kernels=use_kernels)[0]
            neg = self.predict_density(torch.clamp(means - offs, -1e6, 1e6),
                                       stds, use_kernels=use_kernels)[0]
            grads.append(0.5 * (pos - neg) / eps)
        return torch.nan_to_num(_l2_normalize(-torch.stack(grads, dim=-1)))

    def _dir_enc(self, dirs: torch.Tensor,
                 roughness: Optional[torch.Tensor]) -> torch.Tensor:
        """The IDE (roughness as kappa^-1, 0 without it) or posenc."""
        if self.ide is not None:
            if roughness is None:
                roughness = torch.zeros_like(dirs[..., :1])
            return self.ide(dirs, roughness)
        return coord.pos_enc(dirs, min_deg=0, max_deg=self.cfg.deg_view,
                             append_identity=True)

    def forward(self, means: torch.Tensor, stds: torch.Tensor,
                viewdirs: Optional[torch.Tensor] = None,
                latent: Optional[torch.Tensor] = None,
                use_kernels: bool = True,
                generator: Optional[torch.Generator] = None,
                glo_vec: Optional[torch.Tensor] = None
                ) -> Dict[str, Optional[torch.Tensor]]:
        """means: [..., S, n, 3], stds: [..., S, n]; viewdirs: [..., 3] per
        ray or [..., S, 3] per sample; latent: [..., S, latent_width] or
        None; glo_vec: [..., glo_width] per ray or None; generator: draws
        the density and bottleneck noise (training), or None for none.
        Returns dict(density [..., S], rgb [..., S, 3], semantic
        [..., S, K] or None, intensity [..., S, 1] or None), and where the
        config makes them normals (density normals) / grad_pred and
        normals_pred (the predicted-normal head) [..., S, 3], roughness
        [..., S, 1]."""
        c = self.cfg
        raw_density, x = self.predict_density(means, stds, latent,
                                              generator, use_kernels)
        view_lat = latent_split(c, self.latent_width)[1]
        density = F.softplus(raw_density + c.density_bias)
        out = dict(density=density, rgb=None, semantic=None, intensity=None)
        normals = None
        if not c.disable_density_normals:
            normals = out["normals"] = self.finite_difference_normals(
                means, stds, use_kernels)
        if c.enable_pred_normals:
            grad_pred = out["grad_pred"] = self.normal_layer(x).float()
            normals = out["normals_pred"] = -_l2_normalize(grad_pred)
        if c.disable_rgb:
            out["rgb"] = density.new_zeros(density.shape + (3,))
            return out

        if c.use_semantic and c.fixed_semantic:
            # A constant class, which takes no gradient (none for 255; an
            # id past the head is dropped, as JAX's scatter drops it).
            sem = x.new_zeros(x.shape[:-1] + (c.class_num,),
                              dtype=torch.float32)
            if 0 <= c.class_type < c.class_num:
                sem[..., c.class_type] = 1.0
            out["semantic"] = sem
        elif c.use_semantic:
            if c.no_sem_layer:
                sem = x[..., 1:1 + c.class_num]  # v4: in-density channels
            else:
                sem = self.sem_layers[1](F.relu(self.sem_layers[0](x)))
            out["semantic"] = torch.softmax(sem.float(), dim=-1)
        if c.use_intensity:
            out["intensity"] = self.intensity_layers[1](
                F.relu(self.intensity_layers[0](x))).float()

        bottleneck = x
        if generator is not None and c.bottleneck_noise > 0:
            bottleneck = bottleneck + c.bottleneck_noise * mathx.random_rows(
                torch.randn, bottleneck.shape, generator, device=x.device)
        if glo_vec is not None and hasattr(self, "glo_layers"):
            g = glo_vec
            for i, layer in enumerate(self.glo_layers):
                g = layer(g)
                if i != len(self.glo_layers) - 1:
                    g = F.relu(g)
            scale, shift = torch.chunk(_per_sample(g, bottleneck), 2, dim=-1)
            bottleneck = bottleneck * torch.exp(scale) + shift

        roughness = tint = raw_rgb_diffuse = None
        if c.use_diffuse_color:
            raw_rgb_diffuse = self.diffuse_layer(x)
        if c.use_specular_tint:
            tint = torch.sigmoid(self.specular_layer(x))
        if c.enable_pred_roughness:
            roughness = out["roughness"] = F.softplus(
                self.roughness_layer(x) + c.roughness_bias)

        parts = [bottleneck]
        if viewdirs is not None:
            if c.use_reflections:
                # Reflect the direction towards the camera about the
                # per-sample normals.
                parts.append(self._dir_enc(ref_utils.reflect(
                    -_per_sample(viewdirs, x), normals), roughness))
            else:
                per_sample_rough = roughness is not None and \
                    self.ide is not None
                parts.append(_per_sample(self._dir_enc(
                    viewdirs[..., None, :] if per_sample_rough else viewdirs,
                    roughness), x))
            if c.use_n_dot_v:
                parts.append(torch.sum(normals * _per_sample(viewdirs, x),
                                       dim=-1, keepdim=True))
        if latent is not None and c.split_latent:
            parts.append(_per_sample(latent[..., view_lat], x))
        h = inputs = torch.cat(parts, dim=-1)
        for i, layer in enumerate(self.view_layers):
            h = F.relu(layer(h))
            if i == c.skip_layer_dir:
                h = torch.cat([h, inputs], dim=-1)
        rgb = torch.sigmoid(c.rgb_premultiplier * self.rgb_layer(h).float()
                            + c.rgb_bias)
        if c.use_diffuse_color:
            # Diffuse plus specular, tone mapped.
            diffuse_linear = torch.sigmoid(raw_rgb_diffuse - math.log(3.0))
            specular_linear = tint * rgb if c.use_specular_tint \
                else 0.5 * rgb
            rgb = torch.clamp(linear_to_srgb(specular_linear
                                             + diffuse_linear), 0.0, 1.0)
        out["rgb"] = rgb * (1 + 2 * c.rgb_padding) - c.rgb_padding
        return out
