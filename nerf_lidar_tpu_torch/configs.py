# Copy of nerf_lidar_tpu/configs.py (see tests/test_torch_host.py).
"""Configuration tree for nerf_lidar_tpu.

Replaces the reference's gin-on-class-attributes system (reference
internal/configs.py:22-229, models.py class attributes) with frozen
dataclasses: hashable (so jit can close over them), serializable, and
overridable from TOML/JSON or --key=value CLI flags. The "per-MLP config
block" concept is kept: `ModelConfig` holds one `MLPConfig` per MLP role
(nerf / prop levels / obj), mirroring gin's NerfMLP/PropMLP/ObjMLP aliases.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Hash-grid encoder knobs (reference models.py:825-830, grid.py:96-156)."""
    level_dim: int = 4
    base_resolution: int = 16
    desired_resolution: int = 8192
    log2_hashmap_size: int = 21
    level_interval: int = 2  # resolution multiplier between levels
    interp: str = "linear"  # 'linear' (8-corner) | 'tetra' (4-corner)
    # False = custom-VJP encode: backward is a recomputed-index scatter-add
    # only, and positions/stds get ZERO gradients (requires pose_refine off;
    # see ops/grid.py). True = reference-exact autodiff.
    diff_inputs: bool = True
    # 'hash' = multiresolution hash grid (reference gridencoder).
    # 'dense_fourier' = matmul-resident field: dense tiled grid up to
    # fourier_dense_res + IPE-damped random Fourier features spanning
    # [fourier_dense_res, desired_resolution] (ops/fourier.py) — no hashed
    # tables, no gather/scatter on the high-res band.
    encoder: str = "hash"
    fourier_freqs: int = 128
    fourier_dense_res: int = 32
    # Collapse the multisample cloud to one Gaussian for the Fourier band
    # (exact mip-NeRF IPE; 1/n the sin/cos work — ops/fourier.py
    # fourier_encode_pooled). The dense band keeps the cloud.
    fourier_pooled: bool = False

    @property
    def num_levels(self) -> int:
        import numpy as np
        return int(np.log(self.desired_resolution / self.base_resolution)
                   / np.log(self.level_interval)) + 1


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """One MLP role (reference models.py:796-846 class attributes)."""
    grid: GridConfig = GridConfig()
    bottleneck_width: int = 256
    net_depth_viewdirs: int = 2
    net_width_viewdirs: int = 256
    skip_layer_dir: int = 0
    num_rgb_channels: int = 3
    deg_view: int = 4
    use_directional_enc: bool = False  # IDE instead of posenc dirs
    use_reflections: bool = False  # encode reflection dirs (ref-NeRF)
    enable_pred_normals: bool = False  # predicted-normal head
    enable_pred_roughness: bool = False
    roughness_bias: float = -1.0
    use_n_dot_v: bool = False
    use_diffuse_color: bool = False
    use_specular_tint: bool = False
    normal_eps: float = 1e-2  # finite-difference step for density normals
    bottleneck_noise: float = 0.0
    density_bias: float = -1.0
    density_noise: float = 0.0
    rgb_premultiplier: float = 1.0
    rgb_bias: float = 0.0
    rgb_padding: float = 0.001
    disable_density_normals: bool = True
    disable_rgb: bool = False
    warp_fn: Optional[str] = "contract"
    num_glo_features: int = 0
    num_glo_embeddings: int = 1000
    net_width_glo: int = 128
    net_depth_glo: int = 2
    scale_featurization: bool = False
    class_num: int = 19
    use_semantic: bool = False
    use_intensity: bool = False
    no_sem_layer: bool = True  # if False, use a separate 64-wide sem head
    density_init: bool = False  # +0.1 bias init on density output
    re_weights: bool = True  # erf multisample downweighting
    # TPU gather optimization: levels with resolution <= cutoff encode the
    # multisample mean point (exact when the cloud fits one cell). 0 = off.
    ms_coarse_res_cutoff: int = 0
    fixed_semantic: bool = False  # emit a constant one-hot class
    class_type: int = 255
    obj_mode: bool = False  # 32-wide density trunk for obj MLPs
    complex_decoder: bool = False
    latent_size: int = 0
    split_latent: bool = False
    # Mixed precision (the TPU analog of the reference's autocast forward +
    # half-precision embeddings, train.py:269 / grid.py:43-44): 'bfloat16'
    # runs every MLP matmul and its activations in bf16 (params stay f32 —
    # flax Dense casts per-call), halving activation HBM traffic and
    # putting the MXU in its native dtype. Numerics that are
    # precision-sensitive stay f32: sample positions, the encode, raw
    # density -> softplus, and all compositing (exp/cumsum in render.py).
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Scene-level model (reference models.py:31-59 class attributes)."""
    num_prop_samples: Tuple[int, ...] = (64, 64)
    num_nerf_samples: int = 32
    bg_intensity_range: Tuple[float, float] = (1.0, 1.0)
    anneal_slope: float = 10.0
    stop_level_grad: bool = True
    use_viewdirs: bool = True
    raydist_fn: Optional[str] = "power_transformation"
    single_jitter: bool = True
    dilation_multiplier: float = 0.5
    dilation_bias: float = 0.0025
    num_glo_features: int = 0
    num_glo_embeddings: int = 1000
    near_anneal_rate: Optional[float] = None
    near_anneal_init: float = 0.95
    resample_padding: float = 0.0
    opaque_background: bool = True
    power_lambda: float = -1.5
    std_scale: float = 0.35
    prop_desired_grid_size: Tuple[int, ...] = (512, 2048)
    sample_n: int = 7  # multisamples per frustum
    sample_m: int = 3  # spiral turns
    use_semantic: bool = True
    use_intensity: bool = False
    sem_detach: bool = True
    # Dynamic objects.
    instance_obj: bool = False
    num_objects: int = 0  # static upper bound on tracked objects
    # Rematerialize MLP activations in backward: the encode/MLP activations
    # at batch x samples x 7 multisamples dominate HBM; recompute is cheap.
    remat: bool = True
    latent_size: int = 0
    symmetrize: bool = False
    # RawNeRF learned exposure compensation (reference models.py:86-91,
    # configs.py:48): per-capture rgb scaling offsets, anchored at idx 0.
    learned_exposure_scaling: bool = False
    # Per-class obj MLPs (reference models.py:93-174 registers one
    # `obj_mlp_{class_id}` per object class + per-track latents): slot k of
    # the padded track tensor uses the MLP of class obj_class_ids[k].
    # Empty tuple = one shared obj MLP for all slots.
    obj_class_ids: Tuple[int, ...] = ()
    # Per-slot SEMANTIC class ids (objects.query_class of each track's
    # class name; 255 = unlabeled). With a fixed-semantic obj MLP, object
    # samples render one-hot(obj_sem_ids[slot]) — the reference builds
    # each obj MLP with class_type = query_class(...) (models.py:105-121).
    # The CLI fills this from the scene's track_classes.
    obj_sem_ids: Tuple[int, ...] = ()
    # Static obj-MLP sample budget as a fraction of R*S per level: box
    # intersections are sparse, so the obj encode/MLP runs only on the
    # first K = frac*R*S compacted intersecting samples (overflow keeps
    # the field prediction; objects.py _composite_objects_compact).
    # Measured round 5: the dense eval made objects 3.6x the stripped
    # step because every sample paid the obj hash encode. <= 0 disables
    # (dense reference-shaped evaluation). 0.125 is sized from measured
    # ray-box hit fractions (exp/profile_recipe/obj_frac.json: mean 2.8%
    # of rays hit a box on the at-scale scene, but a 32x32 patch landing
    # on a vehicle pushes the worst batch to 23%, and resampling
    # concentrates a hitting ray's samples near the box surface) — the
    # obj_overflow train stat is the tripwire if a scene exceeds it, and
    # the obj_hit_frac train stat (max level utilization) is the
    # data-driven floor: keep frac >= 2x its observed max. speed_variant
    # ships 0.0625, measured safe on the bench scene (obj_budget_sweep).
    # Train-only: inference always runs the dense path (models/model.py).
    obj_sample_frac: float = 0.125
    # MLP blocks (gin alias analog).
    nerf_mlp: MLPConfig = MLPConfig(
        use_semantic=True, no_sem_layer=False, disable_density_normals=True)
    prop_mlp: MLPConfig = MLPConfig(
        disable_rgb=True, disable_density_normals=True,
        use_semantic=False, grid=GridConfig(level_dim=1))
    obj_mlp: MLPConfig = MLPConfig(
        use_semantic=True, fixed_semantic=True, disable_density_normals=True,
        warp_fn=None, re_weights=False, bottleneck_width=64,
        net_width_viewdirs=32, deg_view=2, density_init=True, split_latent=True,
        grid=GridConfig(level_dim=2, desired_resolution=1024))

    @property
    def num_levels(self) -> int:
        return len(self.num_prop_samples) + 1

    def prop_mlp_for_level(self, level: int) -> MLPConfig:
        grid = _replace(self.prop_mlp.grid,
                        desired_resolution=self.prop_desired_grid_size[level])
        return _replace(self.prop_mlp, grid=grid)


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level experiment config (reference internal/configs.py:24-211)."""
    exp_name: str = "exp"
    data_dir: Optional[str] = None
    dataset_loader: str = "nusc"
    seed: int = 0

    # Batching.
    batch_size: int = 16384
    patch_size: int = 32
    lidar_supervision: bool = False
    lidar_batch_ratio: int = 4
    # Depth supervision from LiDAR rays only — camera-depth rows drop out
    # of the depth loss (reference configs.py `only_lidar_supervison`,
    # train.py:321-322).
    only_lidar_supervision: bool = False
    # Road-ray augmentation (reference configs.py aug_road +
    # datasets.py:536-564 `_augment`): append pixel_rays // 4 extra rays
    # that re-view road-surface hit points from perturbed origins.
    aug_road: bool = False
    aug_delta: float = 0.1
    factor: int = 1
    # LLFF/COLMAP captures (dataset_loader='llff', data/llff.py): test-split
    # stride and the forward-facing NDC mode (reference configs.py llffhold
    # + forward_facing).
    llffhold: int = 8
    forward_facing: bool = False
    # DTU rectified scans (dataset_loader='dtu', data/tat_dtu.py): fixed
    # lighting condition (7 = 'max' composite) and test-split stride
    # (reference waymo_zipnerf_dataset.py:944-951 / multinerf defaults).
    dtu_light_cond: int = 2
    dtuhold: int = 8
    # RawNeRF: train on demosaicked linear raw mosaics from <scene>/raw/
    # with per-view exposure scaling (reference configs.py rawnerf_mode +
    # exposure_percentile; utils/raw.py).
    rawnerf_mode: bool = False
    # Supervise only the Bayer-observed channel of each demosaicked pixel
    # (reference configs.py:137 + datasets.py:739-741): emitted as a
    # per-ray-per-channel lossmult by the batcher.
    apply_bayer_mask: bool = False
    exposure_percentile: float = 97.0
    # Cameras per frame in the scene dir: 1 (front only) or 6 (full ring,
    # reference configs.py:167 + configs/nuscenes_multi.gin).
    sensor_num: int = 6
    semantic_dilate: bool = True

    near: float = 0.1
    far: float = 10.0
    render_chunk_size: int = 16384
    # Pallas fused final-level compositing on inference paths: None =
    # backend auto (on for real TPU). Per-preset measured knob, not a
    # global truth — the speed field's sweep is working-set-bound and
    # the plain XLA chain beats the fused kernel there (0.219 vs
    # 0.276 s/sweep, exp/sweep_bench_r5d.log), while the quality field
    # is dispatch-bound and fused + a larger chunk wins (3.17 -> 2.10
    # s/sweep at chunk 17600, exp/chip_session_r5b.log).
    render_fused: Optional[bool] = None

    # Train loop.
    max_steps: int = 25000
    checkpoint_every: int = 5000
    checkpoint_keep: int = 1
    print_every: int = 100
    train_render_every: int = 500
    data_loss_type: str = "charb"
    charb_padding: float = 0.001
    data_loss_mult: float = 1.0
    data_coarse_loss_mult: float = 0.0
    anti_interlevel_loss_mult: float = 0.01
    pulse_width: Tuple[float, ...] = (0.03, 0.003)
    distortion_loss_mult: float = 0.005
    hash_decay_mults: float = 0.1
    obj_nodecay: bool = True
    depth_loss: bool = True
    depth_loss_mult: float = 1.0
    semantic_loss_mult: float = 0.05
    intensity_loss_mult: float = 1.0
    normal_supervision: bool = False
    orientation_loss_mult: float = 0.0
    orientation_coarse_loss_mult: float = 0.0
    orientation_loss_target: str = "normals_pred"
    predicted_normal_loss_mult: float = 0.0
    predicted_normal_coarse_loss_mult: float = 0.0
    latent_reg: float = 0.01
    sym_loss: float = 1.0
    sym_start: int = 5000

    lr_init: float = 0.01
    lr_final: float = 0.001
    lr_delay_steps: int = 5000
    lr_delay_mult: float = 1e-8
    adam_beta1: float = 0.9
    adam_beta2: float = 0.99
    adam_eps: float = 1e-15
    grad_max_norm: float = 0.0
    grad_max_val: float = 0.0

    # Pose refinement (reference posenet_v2.py, train.py:188-268).
    pose_refine: bool = False
    learn_R: bool = True
    learn_t: bool = False
    t_ratio: float = 0.25
    pn_lr_init: float = 4e-5
    pn_lr_final: float = 2e-6
    start_step: int = 10000
    end_step: int = 20000
    track_refine: bool = False
    track_start_opt: int = 5000
    tn_lr_init: float = 1e-4
    tn_lr_final: float = 1e-5

    # Parallelism.
    mesh_shape: Tuple[int, ...] = (-1,)  # 1-D data mesh by default
    mesh_axes: Tuple[str, ...] = ("data",)

    model: ModelConfig = ModelConfig()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_dict(d: dict) -> "Config":
        """Rebuild a Config from a `to_json` snapshot dict (exact-resume:
        `cli train --config_json exp/<name>/config.json` re-runs with the
        identical config, no flag reconstruction)."""
        return _build_dataclass(Config, d)

    def validate(self) -> None:
        """Reject silently-wrong knob combinations.

        diff_inputs=False makes the encode's backward a scatter-only custom
        VJP with ZERO gradients to positions/stds, which is only sound when
        nothing upstream of the encode is trainable: pose refinement rotates
        ray origins/dirs (reference train.py:199-243) and autograd density
        normals differentiate density w.r.t. positions (models.py:1075-1094).
        """
        mlps = {"nerf_mlp": self.model.nerf_mlp, "prop_mlp": self.model.prop_mlp}
        for name, m in mlps.items():
            if m.grid.diff_inputs:
                continue
            if self.pose_refine:
                raise ValueError(
                    f"{name}.grid.diff_inputs=False requires pose_refine "
                    "off: pose deltas need position gradients through the "
                    "hash encode.")
            if not m.disable_density_normals:
                raise ValueError(
                    f"{name}.grid.diff_inputs=False requires "
                    "disable_density_normals: autograd normals need "
                    "position gradients through the hash encode.")
        if not self.model.obj_mlp.grid.diff_inputs and (
                self.track_refine or self.pose_refine):
            raise ValueError(
                "obj_mlp.grid.diff_inputs=False requires track_refine and "
                "pose_refine off: track deltas move object-frame sample "
                "positions through the encode.")
        if self.normal_supervision and (
                self.model.nerf_mlp.disable_density_normals
                and not self.model.nerf_mlp.enable_pred_normals):
            raise ValueError(
                "normal_supervision=True supervises renderings[-1]"
                "['normals'] (reference train.py:358-363), so the NeRF MLP "
                "must produce normals: set nerf_mlp."
                "disable_density_normals=False or enable_pred_normals=True.")
        if (self.model.instance_obj and self.model.use_semantic
                and self.model.obj_mlp.class_num
                != self.model.nerf_mlp.class_num):
            raise ValueError(
                f"obj_mlp.class_num={self.model.obj_mlp.class_num} must "
                f"match nerf_mlp.class_num={self.model.nerf_mlp.class_num}: "
                "object semantics composite into the field's class "
                "probabilities.")


def _build_dataclass(cls, d: dict):
    """Recursively build a frozen-dataclass tree from an asdict() dict;
    JSON lists become the tuples the fields declare. Unknown keys are
    rejected (a snapshot from a different code version should fail loudly,
    not half-apply)."""
    import typing
    hints = typing.get_type_hints(cls)
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: "
                         f"{sorted(unknown)}")
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = hints[f.name]
        if dataclasses.is_dataclass(t) and isinstance(v, dict):
            v = _build_dataclass(t, v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def nuscenes_single() -> Config:
    """Analog of configs/nuscenes_single.gin (front camera only)."""
    return Config(
        dataset_loader="nusc", near=0.1, far=10.0, patch_size=32,
        lidar_supervision=True, lidar_batch_ratio=4, sensor_num=1,
        model=ModelConfig(
            raydist_fn="power_transformation", opaque_background=True,
            use_semantic=True, instance_obj=True, latent_size=128,
        ),
        track_refine=True, track_start_opt=5000, latent_reg=0.01,
        learn_R=True, learn_t=False,
    )


def nuscenes_multi() -> Config:
    """Analog of configs/nuscenes_multi.gin: the full 6-camera ring
    (interleaved frames, front-hood masks handled by the loader,
    data/nuscenes.py:78-110) with the same losses/refinement recipe."""
    base = nuscenes_single()
    return dataclasses.replace(base, sensor_num=6,
                               start_step=0, end_step=5000)


def nuscenes_single_fast() -> Config:
    """TPU-throughput variant of nuscenes_single.

    Measured v5e levers (experiments/gather_bench*.py): table gathers run
    ~182M idx/s at <= 2^17 rows but fall off a cliff to ~45M above (the
    cliff is row-count-, not byte-, indexed: 2^17 x C64 at 32 MB still runs
    fast), and scatter-add (the backward) runs ~55M idx/s at <= 2^17 vs
    15.6M at 2^19 — both independent of row width up to C=128. So this
    config (a) caps every table at 2^17 rows and repacks capacity into
    channel width (4 x C16 NeRF levels instead of 10 x C4), (b) uses tetra
    (4-corner) interpolation, (c) collapses coarse-level multisamples to
    their mean point (exact within a cell), and (d) switches the encode to
    the custom-VJP scatter-only backward (diff_inputs=False: no gather
    replay, no saved multisample intermediates — valid because pose_refine
    is off and density normals are finite-difference-free here). Same
    heads, losses, and training recipe as nuscenes_single.
    """
    return fast_variant(nuscenes_single())


def nuscenes_multi_fast() -> Config:
    """TPU-throughput variant of nuscenes_multi (see nuscenes_single_fast)."""
    return fast_variant(nuscenes_multi())


def fast_variant(base: Config) -> Config:
    """Apply the measured TPU fast-field design to any base config."""
    nerf_grid = GridConfig(level_dim=16, base_resolution=16,
                           desired_resolution=8192, log2_hashmap_size=17,
                           level_interval=8, interp="tetra",
                           diff_inputs=False)
    prop_grid = GridConfig(level_dim=4, base_resolution=16,
                           desired_resolution=512, log2_hashmap_size=17,
                           level_interval=6, interp="tetra",
                           diff_inputs=False)
    obj_grid = dataclasses.replace(base.model.obj_mlp.grid,
                                   log2_hashmap_size=17)
    model = dataclasses.replace(
        base.model,
        nerf_mlp=dataclasses.replace(base.model.nerf_mlp, grid=nerf_grid,
                                     ms_coarse_res_cutoff=1024),
        prop_mlp=dataclasses.replace(base.model.prop_mlp, grid=prop_grid,
                                     ms_coarse_res_cutoff=1024),
        obj_mlp=dataclasses.replace(base.model.obj_mlp, grid=obj_grid),
    )
    # Hash quality field is dispatch-bound on sweeps: fused compositing
    # + a 17,600-ray chunk measured 1.51x over chunk 8,800
    # (exp/chip_session_r5b.log, VERDICT r4 #6 decomposition).
    return dataclasses.replace(base, model=model, render_fused=True,
                               render_chunk_size=17600)


def mxu_variant(base: Config) -> Config:
    """Matmul-resident field: dense tiled band + IPE-damped Fourier features.

    Replaces every hashed table with MXU work (ops/fourier.py): the dense
    band stays below the measured v5e gather cliff (<= 2^17 rows, so dense
    res <= 48), and the [48, 8192] band rides random Fourier features with
    analytic anti-aliasing. Prototype of the gather-free TPU field
    (ROADMAP round-2 item 1); quality/throughput measured in
    experiments/field_shootout.py.
    """
    # fourier_pooled: single-Gaussian IPE for the spectral band — measured
    # +30% rays/s at +0.2 dB vs per-multisample encoding on the 400-step
    # oracle (exp/field_shootout/results.json mxu_pooled vs mxu).
    nerf_grid = GridConfig(level_dim=16, base_resolution=16,
                           desired_resolution=8192, level_interval=2,
                           interp="tetra", diff_inputs=False,
                           encoder="dense_fourier", fourier_freqs=256,
                           fourier_dense_res=48, fourier_pooled=True)
    prop_grid = GridConfig(level_dim=4, base_resolution=16,
                           desired_resolution=512, level_interval=2,
                           interp="tetra", diff_inputs=False,
                           encoder="dense_fourier", fourier_freqs=96,
                           fourier_dense_res=48, fourier_pooled=True)
    # The per-object fields stay hashed (objects are small and few) but at
    # the <= 2^17 row cap — the same measured gather/scatter cliff and
    # checkpoint-size rationale as fast_variant.
    obj_grid = dataclasses.replace(base.model.obj_mlp.grid,
                                   log2_hashmap_size=17)
    model = dataclasses.replace(
        base.model,
        nerf_mlp=dataclasses.replace(base.model.nerf_mlp, grid=nerf_grid,
                                     ms_coarse_res_cutoff=1024),
        prop_mlp=dataclasses.replace(base.model.prop_mlp, grid=prop_grid,
                                     ms_coarse_res_cutoff=1024),
        obj_mlp=dataclasses.replace(base.model.obj_mlp, grid=obj_grid),
    )
    return dataclasses.replace(base, model=model)


def spectral_obj_variant(base: Config) -> Config:
    """Per-object fields on the gather-free spectral encoder.

    mxu_variant kept the obj fields hashed ("objects are small and few"),
    but once the main field is spectral the obj encode is the train step's
    ONLY hashed gather/scatter — exp/profile_recipe (round 5) measures the
    compacted objects rung at +63% step time (60.6k -> 37.1k rays/s), table
    traffic plus the diff_inputs input-grad replay that track refinement
    forces through the hash backward. A unit-box vehicle field does not
    need hashing: a 32^3 dense band (direct-indexed, far below the v5e
    2^17-row gather cliff) plus an IPE-damped Fourier bank spanning
    [32, 1024] cycles/box carries the hashed capacity as matmul work, and
    the position gradients track refinement needs cost one extra matmul
    instead of a gather replay. Composable with any field variant.
    """
    og = dataclasses.replace(
        base.model.obj_mlp.grid, encoder="dense_fourier",
        fourier_freqs=96, fourier_dense_res=32, fourier_pooled=True,
        interp="tetra")
    return dataclasses.replace(base, model=dataclasses.replace(
        base.model,
        obj_mlp=dataclasses.replace(base.model.obj_mlp, grid=og)))


def bf16_variant(base: Config) -> Config:
    """Run every MLP's matmuls/activations in bfloat16 (params f32; encode,
    density softplus, and compositing stay f32 — see MLPConfig.compute_dtype).
    Composable with any field: bf16_variant(nuscenes_single_mxu())."""
    m = base.model
    model = dataclasses.replace(
        m,
        nerf_mlp=dataclasses.replace(m.nerf_mlp, compute_dtype="bfloat16"),
        prop_mlp=dataclasses.replace(m.prop_mlp, compute_dtype="bfloat16"),
        obj_mlp=dataclasses.replace(m.obj_mlp, compute_dtype="bfloat16"))
    return dataclasses.replace(base, model=model)


def speed_variant(base: Config) -> Config:
    """Round-4 flagship levers on top of the spectral field:

    (a) ONE 64-sample proposal level — the reference's two 64-sample
        levels exist to keep CUDA sample counts low; on TPU the second
        level's extra resample + MLP launch costs more than it saves
        (mxu_prop1_64: 60.8k rays/s vs mxu's 35.4k at -0.11 dB);
    (b) bf16 matmuls (f32 params/encode/compositing);
    (c) a 512-frequency Fourier bank — pooled IPE made the bank nearly
        free, and the extra capacity buys +0.5 dB.

    Measured on the 400-step oracle (exp/field_shootout/results.json):
    mxu_speed_f512 60,908 rays/s @ 29.55 dB vs mxu 35,448 @ 29.08 —
    1.7x the throughput at +0.5 dB."""
    cfg = bf16_variant(base)
    m = cfg.model
    nerf = dataclasses.replace(
        m.nerf_mlp,
        grid=dataclasses.replace(m.nerf_mlp.grid, fourier_freqs=512))
    # The speed field's sweep is working-set-bound, not dispatch-bound:
    # plain XLA compositing beats the Pallas fused kernel (0.219 vs
    # 0.276 s/sweep) and the chunk ladder inverts (8,800 beats 17,600;
    # exp/sweep_bench_r5d.log).
    # Compacted-obj budget at 2x the scene-measured worst-case
    # utilization (max obj_hit_frac 0.031 over the bench scene,
    # exp/profile_recipe/obj_budget_sweep.json): full recipe 39.5k vs
    # 33.3k rays/s at the 0.125 ModelConfig default, zero overflow.
    # Sizing rule for new scenes: watch the obj_hit_frac train stat and
    # keep frac >= 2x its observed max (obj_overflow is the tripwire).
    return dataclasses.replace(
        cfg, render_fused=False, render_chunk_size=8800,
        model=dataclasses.replace(m, nerf_mlp=nerf,
                                  num_prop_samples=(64,),
                                  prop_desired_grid_size=(2048,),
                                  obj_sample_frac=0.0625))


def nuscenes_single_mxu() -> Config:
    """nuscenes_single recipe on the matmul-resident field."""
    return mxu_variant(nuscenes_single())


def nuscenes_multi_mxu() -> Config:
    """nuscenes_multi (6-camera ring) on the matmul-resident field."""
    return mxu_variant(nuscenes_multi())


def nuscenes_single_speed() -> Config:
    """nuscenes_single_mxu + speed_variant — the round-4 flagship."""
    return speed_variant(nuscenes_single_mxu())


def nuscenes_multi_speed() -> Config:
    """nuscenes_multi_mxu + speed_variant — the round-4 at-scale flagship."""
    return speed_variant(nuscenes_multi_mxu())


def tiny_debug() -> Config:
    """A small config for CPU tests: tiny grids, few samples."""
    tiny_grid = GridConfig(level_dim=2, base_resolution=4,
                           desired_resolution=64, log2_hashmap_size=12)
    nerf = MLPConfig(grid=tiny_grid, bottleneck_width=32,
                     net_width_viewdirs=32, use_semantic=True,
                     no_sem_layer=False, class_num=5)
    prop = MLPConfig(grid=GridConfig(level_dim=1, base_resolution=4,
                                     desired_resolution=32,
                                     log2_hashmap_size=10),
                     disable_rgb=True, use_semantic=False)
    model = ModelConfig(
        num_prop_samples=(8,), num_nerf_samples=8, sample_n=3, sample_m=1,
        prop_desired_grid_size=(32,), use_semantic=True,
        nerf_mlp=nerf, prop_mlp=prop)
    return Config(batch_size=64, patch_size=8, max_steps=50,
                  lr_delay_steps=5, model=model, render_chunk_size=256)
