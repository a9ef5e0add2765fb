"""Command-line entry of the port (counterpart of `nerf_lidar_tpu/cli.py`).

  python -m nerf_lidar_tpu_torch.cli train --config nuscenes_single \
      --set dataset_loader=synthetic --exp_name myscene --steps 1000
  python -m nerf_lidar_tpu_torch.cli render_lidar --config nuscenes_single \
      --exp_name myscene --mode simu --num_sweeps 10 \
      --params exp/myscene/params_1000.npz

The ray-drop stage turns rendered sweeps into labelled SemanticKITTI
clouds:

  python -m nerf_lidar_tpu_torch.cli raydrop_features \
      --pair scene_dir:exp/myscene/lidar_replay --out exp/feats.npy
  python -m nerf_lidar_tpu_torch.cli raydrop_train --features exp/feats.npy \
      --exp_name rd --epochs 100
  python -m nerf_lidar_tpu_torch.cli raydrop_drop \
      --ckpt exp/rd/raydrop_00100.pt \
      --simulation_path exp/myscene/lidar_replay --out exp/kitti --place_car

(`raydrop_val_vis`, `points_vis`, `convert_vgg` and `convert_rangenet` as
in the JAX CLI; `convert_*` load the weights into the port's modules.)

Evaluation of a field (`params_<step>.npz`, or the JAX package's
`checkpoint_<step>.ckpt`, given by `--params` or the newest in
exp/<name>/):

  python -m nerf_lidar_tpu_torch.cli eval --config nuscenes_single \
      --set dataset_loader=nusc --data_dir scene --exp_name myscene
  python -m nerf_lidar_tpu_torch.cli lidar_eval ... --max_rays 0
  python -m nerf_lidar_tpu_torch.cli render ... --path test --num_frames 1

`eval` scores the test views (PSNR, SSIM, colour-corrected PSNR; `--follow`
polls for new checkpoints), `lidar_eval` replays the scene's real LiDAR
returns (depth errors, Chamfer, mIoU), `render` writes colour / depth /
acc / semantic panels of test or ellipse-path views.

On a scene with dynamic-object tracks (`bboxes.json`; `data/synth_nusc.py`
writes one) and a config with `instance_obj`, `train` fits the object
MLPs and latents beside the field (with the tracknet under
`track_refine`, the posenet under `pose_refine`), and `render_lidar`
composites the vehicles into the sweeps, edited by `--obj_mode` and
`--insert_track`. `render_video --mode laneshift` renders the edited scene's
training views as panels, `render_instance --track_id 0` orbits one
object's field, and `train --obj_ckpt obj_mlp=car.ckpt` starts from an
object MLP saved by `train/checkpoints.save_obj_mlp_params` (or by the JAX
package). `extract --resolution 256 --clean --decimate 100000` writes the
static field's mesh to exp/<name>/mesh.ply.

`train` resumes from the newest train state in exp/<name>/: the port's
checkpoint_<step>.pt or the JAX package's checkpoint_<step>.ckpt (its
params and Adam moments), the port's on a tie.

Data parallel over several GPUs, one process each (`parallel/`): launch
the entries with torchrun, e.g.

  python -m torch.distributed.run --nproc_per_node 4 \
      -m nerf_lidar_tpu_torch.cli train --config nuscenes_single ...

and across hosts with `train --multihost` (each host's batches seeded
`seed + GROUP_RANK`). Each rank trains on its rows of the global batch and
the ranks take the one-process step; `render_lidar`, `eval`, `lidar_eval`,
`render` and `render_video` split every chunk over the ranks. Rank 0
alone writes files and prints.

Config, overrides and scene loading (`build_config`, `apply_overrides`,
`load_scene_for`, `exp_dir`) are copies of the JAX CLI's helpers over the
port's own `configs` and `data` modules, so a preset and a `--set` mean the
same thing in both packages (`tests/test_torch_host.py`). `train` writes
the weights as a Flax param tree in a flat .npz (see `convert.py`), which
`render_lidar --params` and the JAX package both read; the entries that
render can also start from a seeded fresh init for debugging
(`--allow_fresh`). `train` logs to exp/<name>/metrics.jsonl, renders a test
view every `train_render_every` steps (train_renders/rgb_<step>.png and
`test_psnr`), and `--trace_dir` writes a torch.profiler Chrome trace of
steps [trace_start, trace_stop].
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from . import configs, convert, parallel
from .data import png
from .data.batching import RayBatcher
from .lidar import sensor
from .lidar.render import render_sweeps_to_dir
from .models import objects as objlib
from .models import posenet as posenet_lib
from .models.model import Model
from .ops import grid
from .renderer import ChunkRenderer, render_view
from .train import checkpoints, train_step
from .train.prefetch import BatchPrefetcher
from .utils import image as image_lib
from .utils.logging import MetricsLogger, Timer

CONFIGS = ["nuscenes_single", "nuscenes_single_fast", "nuscenes_multi",
           "nuscenes_multi_fast", "nuscenes_single_mxu",
           "nuscenes_multi_mxu", "nuscenes_single_speed",
           "nuscenes_multi_speed", "tiny_debug", "default"]


# Copied from nerf_lidar_tpu/cli.py (`_coerce` .. `build_config`,
# `_obj_sem_ids`, `load_scene_for`, `exp_dir`, `_pad_obj_latents`).
def _coerce(cur, val: str):
    if isinstance(cur, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(cur, int):
        return int(val)
    if isinstance(cur, float):
        return float(val)
    if isinstance(cur, tuple):
        parts = [p for p in val.strip("()[] ").split(",") if p]
        elem = cur[0] if cur else 0
        return tuple(type(elem)(p) for p in parts)
    if cur is None:
        for t in (int, float):
            try:
                return t(val)
            except ValueError:
                pass
        return val
    return type(cur)(val)


def apply_overrides(cfg, overrides: List[str]):
    """--set a.b.c=value on nested frozen dataclasses."""
    for ov in overrides or []:
        key, val = ov.split("=", 1)
        parts = key.split(".")
        cfg = _set_path(cfg, parts, val)
    return cfg


def _set_path(obj, parts: List[str], val: str):
    name = parts[0]
    cur = getattr(obj, name)
    if len(parts) == 1:
        return dataclasses.replace(obj, **{name: _coerce(cur, val)})
    return dataclasses.replace(obj, **{name: _set_path(cur, parts[1:], val)})


def build_config(args) -> configs.Config:
    if getattr(args, "config_json", None):
        with open(args.config_json) as f:
            base = configs.Config.from_dict(json.load(f))
        cfg = apply_overrides(base, args.set)
        if args.data_dir:
            cfg = dataclasses.replace(cfg, data_dir=args.data_dir)
        if args.exp_name:
            cfg = dataclasses.replace(cfg, exp_name=args.exp_name)
        return cfg
    base = {
        "nuscenes_single": configs.nuscenes_single,
        "nuscenes_single_fast": configs.nuscenes_single_fast,
        "nuscenes_multi": configs.nuscenes_multi,
        "nuscenes_multi_fast": configs.nuscenes_multi_fast,
        "nuscenes_single_mxu": configs.nuscenes_single_mxu,
        "nuscenes_multi_mxu": configs.nuscenes_multi_mxu,
        "nuscenes_single_speed": configs.nuscenes_single_speed,
        "nuscenes_multi_speed": configs.nuscenes_multi_speed,
        "tiny_debug": configs.tiny_debug,
        "default": configs.Config,
    }[args.config]()
    cfg = apply_overrides(base, args.set)
    if args.data_dir:
        cfg = dataclasses.replace(cfg, data_dir=args.data_dir)
    if args.exp_name:
        cfg = dataclasses.replace(cfg, exp_name=args.exp_name)
    return cfg


def _obj_sem_ids(classes, n: int):
    """Per-slot semantic class ids from the scene's track class names
    (objects.query_class), padded to the model's num_objects with 255
    (= unlabeled slot)."""
    ids = [objlib.query_class(c) for c in classes][:n]
    return tuple(ids + [255] * (n - len(ids)))


def load_scene_for(cfg: configs.Config, split: str = "train"):
    """Dataset registry: {synthetic, nusc/waymo, llff/blender/colmap,
    tat_nerfpp/tat_fvs/dtu}. The llff loader shards the train images over
    the hosts (`parallel.host_index` / `host_count`, the JAX process index
    and count: every rank of a host loads the host's share)."""
    if cfg.dataset_loader in ("llff", "blender", "colmap"):
        from .data import llff
        return llff.load_scene(
            cfg.data_dir, split=split, factor=max(cfg.factor, 1),
            llffhold=cfg.llffhold, forward_facing=cfg.forward_facing,
            rawnerf_mode=cfg.rawnerf_mode,
            exposure_percentile=cfg.exposure_percentile,
            process_index=parallel.host_index(),
            process_count=parallel.host_count())
    if cfg.dataset_loader in ("tat_nerfpp", "tat_fvs", "dtu"):
        from .data import tat_dtu
        if cfg.dataset_loader == "tat_nerfpp":
            return tat_dtu.load_tat_nerfpp(cfg.data_dir, split=split)
        if cfg.dataset_loader == "tat_fvs":
            return tat_dtu.load_tat_fvs(cfg.data_dir, split=split,
                                        factor=max(cfg.factor, 0),
                                        llffhold=cfg.llffhold)
        return tat_dtu.load_dtu(cfg.data_dir, split=split,
                                factor=max(cfg.factor, 1),
                                dtu_light_cond=cfg.dtu_light_cond,
                                dtuhold=cfg.dtuhold)
    if cfg.dataset_loader == "synthetic" or cfg.data_dir is None:
        from .data import synthetic
        from .lidar.transforms import SceneFrame
        _, data, _ = synthetic.make_scene_data(far=min(cfg.far, 12.0))
        return types.SimpleNamespace(
            data=data, tracks=None, track_mask=None, track_classes=[],
            lidar=None, frame=SceneFrame.identity())
    # 'nusc' and 'waymo' share the poses_bounds scene-dir format
    # (reference load_nuscenes.load_waymo_meta).
    from .data import nuscenes
    return nuscenes.load_scene(
        cfg.data_dir, split=split, factor=max(cfg.factor, 1),
        sensor_num=cfg.sensor_num,
        load_lidar=cfg.lidar_supervision or split == "lidar",
        load_objects=cfg.model.instance_obj,
        semantic_dilate=cfg.semantic_dilate,
        load_normals=cfg.normal_supervision and split == "train")


def exp_dir(cfg: configs.Config) -> str:
    return os.path.join("exp", cfg.exp_name)


def _device(name: str) -> torch.device:
    """`--device`: "cuda" is this process's card, cuda:LOCAL_RANK under
    torchrun and cuda:0 otherwise; an explicit cuda:<i> is kept."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu for a CPU run)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def _data_mesh(device: torch.device, multihost: bool = False,
               shape=(-1,), axes=("data",)):
    """The entries' `maybe_data_mesh`, after joining a torchrun process
    group (`parallel.init_distributed`); prints the world once."""
    parallel.init_distributed(multihost, device)
    mesh = parallel.maybe_data_mesh(shape, axes)
    if mesh is not None:
        parallel.main_print(f"data-parallel over {mesh.world} devices")
    return mesh


def _pad_obj_latents(params, num_objects: int):
    """Grow the restored obj_latents table to `num_objects` rows (track
    insertion adds slots the checkpoint never trained). New slots get zero
    latents, the neutral-appearance convention."""
    lat = params.get("params", {}).get("obj_latents")
    if lat is None or lat.shape[0] >= num_objects:
        return params
    pad = np.zeros((num_objects - lat.shape[0], lat.shape[1]), lat.dtype)
    params = dict(params)
    params["params"] = dict(params["params"])
    params["params"]["obj_latents"] = np.concatenate([lat, pad], axis=0)
    return params


def _restore_model_params(cfg, params_path: Optional[str] = None,
                          allow_fresh: bool = False):
    """(Flax param tree, step) of `--params` (a params_<step>.npz or a JAX
    checkpoint_<step>.ckpt), or without it of the newest weights in
    exp/<name>/ (`checkpoints.restore_model_params`). With nothing to
    restore: (None, 0) under `allow_fresh`, else a refusal, so no entry
    ships output of an untrained init by accident."""
    params, step = checkpoints.restore_model_params(
        params_path or exp_dir(cfg))
    if params_path and params is None:
        raise SystemExit(f"--params {params_path}: no such file")
    if params is None and not allow_fresh:
        raise SystemExit(
            f"no checkpoint in {exp_dir(cfg)} and no --params: refusing to "
            "render from an untrained init (pass --params <npz or ckpt> "
            "with trained weights, or --allow_fresh to debug)")
    return params, step


def load_params(model: Model, cfg, params) -> None:
    """A Flax param tree's weights into the model (a model without objects
    skips the object leaves; inserted object slots get zero latents)."""
    if model.has_objects:
        params = _pad_obj_latents(params, cfg.model.num_objects)
    model.load_state_dict(convert.flax_to_state_dict(params, cfg.model))


def build_model(cfg, params, device: torch.device) -> Model:
    """The scene model with a Flax param tree's weights (`load_params`), or,
    for params None, a fresh init seeded by `cfg.seed`."""
    model = Model(cfg.model, device=device)
    if params is not None:
        load_params(model, cfg, params)
    else:
        model.init_weights(torch.Generator().manual_seed(cfg.seed))
    return model.eval()


def _sweeps(args, scene, out: str):
    """The sweeps to render and their sensor-to-world poses."""
    frame = scene.frame
    lidar = getattr(scene, "lidar", None)
    sweep_ts = lidar.get("sweep_timestamps") if lidar else None
    if args.mode == "replay":
        if lidar is None:
            raise SystemExit(
                "--mode replay needs the scene's real LiDAR trajectory "
                "(lidar_points/ + lidar2globals), which this scene lacks; "
                "use --mode simu for a synthesized trajectory")
        l2g = lidar["lidar2globals"]
        sweeps = sensor.replay_sweeps(l2g[:, :3, 3], l2g, frame,
                                      timestamps=sweep_ts,
                                      points_per_beam=args.azimuth_steps)
    else:
        start = np.array(args.start or [0.0, 0.0, 0.6])
        end = np.array(args.end or [10.0, 0.0, 0.6])
        sweeps, trace = sensor.simulated_sweeps(
            start, end, np.eye(4), frame, num_sweeps=args.num_sweeps,
            complicated=args.complicated, timestamps=sweep_ts,
            points_per_beam=args.azimuth_steps)
        if parallel.is_main():
            os.makedirs(out, exist_ok=True)
            np.save(os.path.join(out, "ego_trace.npy"), trace)
        l2g = np.tile(np.eye(4, dtype=np.float64), (len(sweeps), 1, 1))
        l2g[:, :3, 3] = trace[: len(sweeps)]
    sweeps = sweeps[: args.num_sweeps]
    return sweeps, l2g[: len(sweeps)]


def _with_objects(cfg, tracks, classes):
    """cfg with one object slot per track and the tracks' semantic ids, or
    with the objects off when there are no tracks (a scene without tracks
    trains and renders as a static field)."""
    if tracks is not None and cfg.model.instance_obj:
        n = int(tracks.shape[0])
        model = dataclasses.replace(cfg.model, num_objects=n,
                                    obj_sem_ids=_obj_sem_ids(classes, n))
    else:
        model = dataclasses.replace(cfg.model, instance_obj=False)
    return dataclasses.replace(cfg, model=model)


def _track_tensors(cfg, tracks, track_mask, device: torch.device):
    """(tracks, track_mask) as tensors on `device` when the model has
    objects, else (None, None)."""
    if not (cfg.model.instance_obj and cfg.model.num_objects > 0):
        return None, None
    mask = None if track_mask is None else torch.as_tensor(
        np.asarray(track_mask, bool), device=device)
    return torch.as_tensor(np.asarray(tracks, np.float32),
                           device=device), mask


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on `device`, copied from pinned memory without
    blocking the host when the device is a GPU."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def train_test_view(scene) -> int:
    """The view the in-train render shows: the first view of the scene's
    test split, mapped through the loader's "loaded" ids to its index in
    the loaded data, else the last loaded view (the JAX `cmd_train`'s
    choice; with `use_all_for_training` that view is trained on too, so
    its PSNR is a train-view upper bound)."""
    data = scene.data
    splits = getattr(scene, "splits", None) or {}
    test_split = splits.get("test")
    test_view = data.num_views - 1
    if test_split is not None and len(test_split):
        g = int(test_split[0])
        loaded = splits.get("loaded")
        if loaded is None:
            test_view = g
        else:
            hit = np.nonzero(np.asarray(loaded) == g)[0]
            if len(hit):
                test_view = int(hit[0])
    return test_view


class _TestRender:
    """The in-train test-view render: every `train_render_every` steps one
    view through the plain compositor (the JAX `fused=False`: training
    never dies on an inference kernel), its PNG under train_renders/ and
    its PSNR logged as `test_psnr`."""

    def __init__(self, model, cfg, scene, out, logger, tracks, track_mask,
                 mesh=None):
        self.renderer = ChunkRenderer(model, cfg, cfg.render_chunk_size,
                                      fused=False, mesh=mesh)
        self.view = train_test_view(scene)
        self.rays = _view_rays(scene.data, self.view)
        self.gt = scene.data.images[self.view]
        self.out, self.logger = out, logger
        self.tracks, self.track_mask = tracks, track_mask

    def __call__(self, step: int) -> float:
        img = render_view(self.renderer, self.rays, self.tracks,
                          self.track_mask)
        device = self.renderer.model.nerf_mlp.table.device
        psnr = float(image_lib.psnr(torch.from_numpy(img["rgb"]).to(device),
                                    torch.from_numpy(self.gt).to(device)))
        if parallel.is_main():
            d = os.path.join(self.out, "train_renders")
            os.makedirs(d, exist_ok=True)
            png.write_png(os.path.join(d, f"rgb_{step:06d}.png"),
                          (np.clip(img["rgb"], 0, 1) * 255).astype(np.uint8))
        self.logger.log(step, test_psnr=psnr)
        parallel.main_print(f"step {step}: test view {self.view} "
                            f"psnr={psnr:.2f}")
        return psnr


def _ray_batcher(cfg, scene, seed: int, mask_moving: bool) -> RayBatcher:
    return RayBatcher(scene.data, cfg.batch_size, cfg.patch_size,
                      lidar_supervision=cfg.lidar_supervision,
                      lidar_batch_ratio=cfg.lidar_batch_ratio,
                      only_lidar_depth=cfg.only_lidar_supervision,
                      aug_road=cfg.aug_road, aug_delta=cfg.aug_delta,
                      apply_bayer_mask=cfg.apply_bayer_mask, seed=seed,
                      mask_moving=mask_moving)


def step_batchers(cfg, scene, mask_moving: bool):
    """The batchers the train steps draw from, as the JAX loop's: worker w
    (of 2) seeded `cfg.seed + 1000 + w`, step k taking worker k % 2's next
    batch. (The JAX loop queues the workers' batches in whatever order its
    threads finish; strict alternation is the order it gives when they
    finish in turn, and the one a test can pin. Both packages restart the
    workers from their seeds on resume.)"""
    return [_ray_batcher(cfg, scene, cfg.seed + 1000 + w, mask_moving)
            for w in range(2)]


def _broadcast_state(mesh, *modules) -> None:
    """Every rank takes rank 0's weights (a --multihost host's init is
    seeded by its own seed; a rank may resume from a file the others do
    not see)."""
    with torch.no_grad():
        for module in modules:
            if module is not None:
                for t in module.state_dict().values():
                    mesh.broadcast(t)


def cmd_train(args) -> types.SimpleNamespace:
    """Fit a scene: RayBatcher batches -> `train_step`, printing loss /
    PSNR / rays per second every `print_every` steps (and logging them to
    exp/<name>/metrics.jsonl) and writing checkpoint_<step>.pt +
    params_<step>.npz there every `checkpoint_every` steps and at the end,
    on a background thread (`checkpoints.AsyncCheckpointer`). The steps'
    batches come from two worker batchers in turn (`step_batchers`),
    built and staged on the device by `BatchPrefetcher`; the `cfg.seed`
    batcher gives the batch's layout (`num_patch_rays`, `total_rays`).
    With tracks and `instance_obj`, one object slot per track (the
    moving-object mask then stays off, since the objects model those
    pixels), the tracknet under `track_refine`; the posenet (one row per
    view, one for the LiDAR) under `pose_refine`. Every
    `train_render_every` steps a test view is rendered (`_TestRender`);
    `--trace_dir` writes a torch.profiler Chrome trace of steps
    [trace_start, trace_stop], counted from the first step of this run.
    `--obj_ckpt name=path` loads an object MLP's subtree before training.
    Resumes from the newest train state there, the port's
    checkpoint_<step>.pt or the JAX package's checkpoint_<step>.ckpt
    (`checkpoints.restore_checkpoint`; a .ckpt that does not match the
    config ends the run with its name and step). Under a data mesh
    (torchrun, or a process group the caller initialised) every rank
    trains on its rows of each batch and takes the one-process step;
    `--multihost` seeds each host's batches and randomness by `seed +
    GROUP_RANK`; rank 0 alone writes and prints. A prefetcher worker's or
    the checkpoint writer's error ends the run with that error. Returns
    what was built, the step it started at (`init_step`), the printed
    stats (`history`), the in-train renders' PSNRs (`test_psnr`) and the
    last checkpoint's paths (None on a rank that writes none)."""
    cfg = build_config(args)
    cfg.validate()
    device = _device(args.device)
    mesh = _data_mesh(device, args.multihost, cfg.mesh_shape, cfg.mesh_axes)
    if args.multihost:
        # Decorrelate the hosts' sampling, as the reference's seed + rank
        # (train.py:61) and the JAX CLI's seed + process_index.
        cfg = dataclasses.replace(cfg, seed=cfg.seed + parallel.host_index())
    writer = parallel.is_main()
    say = parallel.main_print
    out = exp_dir(cfg)
    if writer:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "config.json"), "w") as f:
            f.write(cfg.to_json())
    scene = load_scene_for(cfg, "train")
    cfg = _with_objects(cfg, getattr(scene, "tracks", None),
                        getattr(scene, "track_classes", []))
    train_step.check_ported(cfg)
    tracks, track_mask = _track_tensors(cfg, getattr(scene, "tracks", None),
                                        getattr(scene, "track_mask", None),
                                        device)

    batcher = _ray_batcher(cfg, scene, cfg.seed, tracks is None)
    model = Model(cfg.model, device=device)
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    posenet = tracknet = None
    if cfg.pose_refine:
        posenet = posenet_lib.LearnPose(
            num_cams=scene.data.num_views, num_lidars=1, t_ratio=cfg.t_ratio,
            learn_R=cfg.learn_R, learn_t=cfg.learn_t, device=device)
    if cfg.track_refine and tracks is not None:
        tracknet = posenet_lib.TrackOpt(int(tracks.shape[0]),
                                        int(tracks.shape[1]), device=device)
    # Transplant pre-trained object MLPs (--obj_ckpt obj_mlp_cls2=car.ckpt,
    # repeatable); a checkpoint of this experiment overrides them.
    for spec in args.obj_ckpt:
        name, _, path = spec.partition("=")
        checkpoints.restore_obj_mlp_params(model, name, path)
        say(f"restored obj MLP '{name}' from {path}")
    optimizer = train_step.make_optimizer(model, cfg, posenet, tracknet)
    try:
        init_step = checkpoints.restore_checkpoint(out, model, optimizer,
                                                   posenet, tracknet)
    except ValueError as e:
        raise SystemExit(f"train: cannot resume: {e}") from e
    if init_step:
        say(f"resumed from step {init_step}")
    if mesh is not None:
        _broadcast_state(mesh, model, posenet, tracknet)
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 17)
    max_steps = args.steps or cfg.max_steps
    logger = MetricsLogger(out, tensorboard=args.tensorboard)
    test_render = None
    if cfg.train_render_every > 0 and scene.data.num_views > 1:
        test_render = _TestRender(model, cfg, scene, out, logger, tracks,
                                  track_mask, mesh)
    trace = None

    # Each rank builds its host's whole batch and stages its own rows (the
    # host work is repeated on every rank of a host; a scatter from one
    # process would save it).
    workers = step_batchers(cfg, scene, tracks is None)
    prefetcher = BatchPrefetcher(
        lambda w: workers[w].next(), depth=3, num_workers=len(workers),
        device=device,
        rows=None if mesh is None else mesh.rows(batcher.total_rays))
    checkpointer = checkpoints.AsyncCheckpointer()
    history, test_psnr, paths = [], [], (None, None)
    timer = Timer()
    try:
        for step in range(init_step, max_steps):
            if writer and args.trace_dir and \
                    step == init_step + args.trace_start:
                trace = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if device.type == "cuda" else [])])
                trace.start()
            batch = prefetcher.next()
            stats = train_step.train_step(
                model, optimizer, cfg, batch, step, batcher.num_patch_rays,
                generator, posenet=posenet, tracknet=tracknet, tracks=tracks,
                track_mask=track_mask, mesh=mesh)
            timer.tick(batcher.total_rays)
            if trace is not None and step == init_step + args.trace_stop:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                trace.stop()
                os.makedirs(args.trace_dir, exist_ok=True)
                path = os.path.join(args.trace_dir, f"trace_{step + 1}.json")
                trace.export_chrome_trace(path)
                trace = None
                print(f"profiler trace written to {path}")
            if test_render is not None and \
                    (step + 1) % cfg.train_render_every == 0:
                t_render = time.perf_counter()
                test_psnr.append(test_render(step + 1))
                render_s = time.perf_counter() - t_render
                logger.log(step + 1, render_s=round(render_s, 2))
                timer.t0 += render_s  # kept out of the steps' time
            if (step + 1) % cfg.print_every == 0:
                keys = [k for k in stats if not k.startswith("_")]
                # One copy to the host, which waits for the step.
                vals = dict(zip(keys, torch.stack(
                    [stats[k].float() for k in keys]).tolist()))
                rays_per_sec = timer.mark()[1]
                vals.update(step_s=batcher.total_rays / rays_per_sec,
                            rays_per_sec=rays_per_sec)
                logger.log(step + 1, **vals)
                history.append(dict(vals, step=step + 1))
                say(f"step {step + 1}: loss={vals['loss']:.4f} "
                    f"psnr={vals['psnr']:.2f} "
                    f"rays/s={vals['rays_per_sec']:,.0f}", flush=True)
            if writer and ((step + 1) % cfg.checkpoint_every == 0
                           or step + 1 == max_steps):
                checkpointer.save(out, model, optimizer, step + 1,
                                  keep=cfg.checkpoint_keep, posenet=posenet,
                                  tracknet=tracknet)
        paths = checkpointer.wait()
    finally:
        prefetcher.close()
        if trace is not None:
            trace.stop()
    # The other ranks may read what rank 0 wrote once this returns.
    parallel.barrier()
    say(f"kernel launches: hash_encode_ms="
        f"{grid.hash_encode_multisample.launches} hash_encode_ms_bwd="
        f"{grid.hash_encode_multisample_bwd.launches} scatter_add_rows="
        f"{grid.scatter_add_rows.launches}")
    say(f"done: {out}")
    return types.SimpleNamespace(
        cfg=cfg, model=model, optimizer=optimizer, batcher=batcher,
        generator=generator, init_step=init_step, history=history,
        test_psnr=test_psnr, out=out, mesh=mesh,
        checkpoint=paths[0], params=paths[1], posenet=posenet,
        tracknet=tracknet, tracks=tracks, track_mask=track_mask,
        test_view=None if test_render is None else test_render.view)


def cmd_render_lidar(args) -> types.SimpleNamespace:
    """Render LiDAR sweeps of a scene, its vehicles included, and write the
    points / points_semantic / points_rgb trio plus lidar2globals.npy under
    exp/<name>/lidar_<mode>[_<obj_mode>]/. `--obj_mode` edits the tracks
    (laneshift, removal, rotate), `--insert_track` adds one; every sweep
    carries its timestamp, which places the vehicles. Returns what was
    built and written."""
    cfg = build_config(args)
    device = _device(args.device)
    mesh = _data_mesh(device)
    scene = load_scene_for(cfg, "lidar")
    tracks = getattr(scene, "tracks", None)
    track_mask = getattr(scene, "track_mask", None)
    classes = list(getattr(scene, "track_classes", []))
    angle, tracks = objlib.simu_info(args.obj_mode, tracks)
    if tracks is not None and angle:
        tracks = objlib.manipulate_tracks(tracks, angle)
    if args.insert_track and tracks is not None:
        tracks, track_mask, classes = objlib.edit_tracks(
            tracks, track_mask, classes, np.load(args.insert_track))
    cfg = _with_objects(cfg, tracks, classes)
    out = exp_dir(cfg)
    sweeps, l2g = _sweeps(args, scene, out)
    params, step = _restore_model_params(cfg, args.params, args.allow_fresh)
    model = build_model(cfg, params, device)
    tracks_t, mask_t = _track_tensors(cfg, tracks, track_mask, device)
    parallel.main_print(f"restored step {step}")
    parallel.main_print(f"dynamic objects: "
                        f"{0 if tracks_t is None else len(tracks_t)} "
                        f"(obj_mode={args.obj_mode})")
    renderer = ChunkRenderer(model, cfg, cfg.render_chunk_size, mesh=mesh)
    name = (f"lidar_{args.mode}" if args.obj_mode == "replay"
            else f"lidar_{args.mode}_{args.obj_mode}")
    sweep_dir = os.path.join(out, name)
    data = scene.data
    paths = render_sweeps_to_dir(renderer, sweeps, data.near, data.far,
                                 scene.frame, sweep_dir, tracks_t, mask_t)
    if parallel.is_main():
        np.save(os.path.join(sweep_dir, "lidar2globals.npy"), l2g)
    parallel.main_print(f"wrote {len(paths)} sweeps to {sweep_dir}")
    return types.SimpleNamespace(
        cfg=cfg, model=model, renderer=renderer, sweeps=sweeps,
        near=data.near, far=data.far, frame=scene.frame,
        sweep_dir=sweep_dir, paths=paths, tracks=tracks_t,
        track_mask=mask_t)


def follow_checkpoints(out: str, eval_fn, poll_every: float = 10.0,
                       timeout: float = 1800.0, stop_step: int = 0,
                       share=None):
    """The JAX CLI's daemon loop (reference eval.py:67-71), over both
    checkpoint layouts: poll `out` for new weights
    (the port's params_<step>.npz or the JAX checkpoint_<step>.ckpt), call
    eval_fn(step) once per new one, stop after the stop_step checkpoint or
    `timeout` idle seconds (0: never). Under a data mesh, `share(int) ->
    int` gives every rank rank 0's value: rank 0 polls, every rank takes
    its step and what eval_fn returned there, so all ranks evaluate the
    same checkpoints together."""
    share = share or (lambda v: v)
    say = parallel.main_print
    last_step = -1
    idle = 0.0
    while True:
        latest, step = checkpoints.newest_params(out) if \
            parallel.is_main() else (None, -1)
        step = share(step if latest and step > last_step else -1)
        if step >= 0:
            say(f"eval --follow: new checkpoint at step {step}")
            done = eval_fn(step)
            done = share(-1 if done is None else done)
            # eval_fn may restore a newer checkpoint than detected; trust
            # the step it reports so that one is not evaluated twice.
            last_step = max(step, done if done >= 0 else step)
            step = last_step
            idle = 0.0
            if stop_step and step >= stop_step:
                say("eval --follow: final checkpoint evaluated")
                return
        else:
            time.sleep(poll_every)
            idle += poll_every
            if timeout and idle >= timeout:
                say("eval --follow: no new checkpoint; giving up")
                return


def _view_rays(data, i: int, pose: Optional[np.ndarray] = None):
    """Full [H, W] ray grid of view i (or of `pose` with view i's
    intrinsics and timestamp), shared by eval, render and the in-train
    test render: the JAX CLI's `_view_rays`, and the per-frame rays of its
    `cmd_render` (`tests/test_torch_host.py`)."""
    from .data import camera as camlib
    pixtocam = (data.pixtocam if data.pixtocam.ndim == 2
                else data.pixtocam[min(i, len(data.pixtocam) - 1)])
    x, y = np.meshgrid(np.arange(data.width), np.arange(data.height))
    rays = camlib.pixels_to_rays(
        x, y, pixtocam, data.camtoworlds[i] if pose is None else pose,
        distortion_params=data.distortion_params, camtype=data.camtype,
        pixtocam_ndc=data.pixtocam_ndc)
    rays["near"] = np.full((data.height, data.width, 1), data.near,
                           np.float32)
    rays["far"] = np.full((data.height, data.width, 1), data.far,
                          np.float32)
    view = min(i, data.num_views - 1)
    if data.timestamps is not None:
        rays["timestamp"] = np.full(
            (data.height, data.width), data.timestamps[view], np.float32)
    if data.exposure_values is not None:
        # RawNeRF: the view's exposure, as its train rays carry it.
        rays["exposure_values"] = np.full(
            (data.height, data.width, 3),
            np.float32(data.exposure_values[view]), np.float32)
        ei = (int(data.exposure_idx[view])
              if data.exposure_idx is not None else 0)
        rays["exposure_idx"] = np.full((data.height, data.width, 1), ei,
                                       np.int32)
    return rays


def _scene_model(cfg, split: str, device: torch.device):
    """(cfg with one object slot per track, scene, tracks, track mask) of
    the image and LiDAR eval entries: dynamic scenes are scored with the
    full model, vehicles included, as the reference's eval builds it."""
    scene = load_scene_for(cfg, split)
    cfg = _with_objects(cfg, getattr(scene, "tracks", None),
                        getattr(scene, "track_classes", []))
    tracks, mask = _track_tensors(cfg, getattr(scene, "tracks", None),
                                  getattr(scene, "track_mask", None), device)
    return cfg, scene, tracks, mask


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def cmd_eval(args) -> types.SimpleNamespace:
    """Render every test view (or the first `--max_views`) through the
    chunked renderer (K1 on the final level, H1 on every level) and score
    PSNR / SSIM on the device and the colour-corrected PSNR / SSIM (the
    warp solved on the host in float64); writes eval/rgb_###.npy,
    metrics.json, metrics_<step>.json and render_times_<step>.txt under
    exp/<name>/. `--follow` evaluates each new checkpoint as it appears;
    under a data mesh rank 0 polls and every rank renders its rows of each
    view. Returns what was built and the last mean metrics."""
    if args.follow and (args.params or args.allow_fresh):
        raise SystemExit("eval --follow evaluates the checkpoints of "
                         "exp/<name>/ as they appear: drop --params and "
                         "--allow_fresh")
    cfg = build_config(args)
    device = _device(args.device)
    mesh = _data_mesh(device)
    writer = parallel.is_main()
    out = exp_dir(cfg)
    cfg, scene, tracks, track_mask = _scene_model(cfg, "test", device)
    data = scene.data
    params, step = (None, 0) if args.follow else _restore_model_params(
        cfg, args.params, args.allow_fresh)
    model = build_model(cfg, params, device)
    renderer = ChunkRenderer(model, cfg, cfg.render_chunk_size, mesh=mesh)
    harness = image_lib.MetricHarness()
    n_views = min(data.num_views, args.max_views or data.num_views)
    eval_dir = os.path.join(out, "eval")
    if writer:
        os.makedirs(eval_dir, exist_ok=True)
    run = types.SimpleNamespace(cfg=cfg, model=model, renderer=renderer,
                                data=data, tracks=tracks,
                                track_mask=track_mask, metrics=None,
                                steps=[])

    def eval_checkpoint(step, params):
        if params is not None:
            load_params(model, cfg, params)
        metrics, render_times = [], []
        for i in range(n_views):
            rays = _view_rays(data, i)
            t0 = time.perf_counter()
            img = render_view(renderer, rays, tracks, track_mask)
            render_times.append(time.perf_counter() - t0)
            gt = torch.from_numpy(np.asarray(data.images[i], np.float32)
                                  ).to(device)
            m = harness(torch.from_numpy(img["rgb"]).to(device), gt)
            cc = image_lib.color_correct(img["rgb"], data.images[i])
            m.update(harness(torch.from_numpy(cc).to(device), gt, "_cc"))
            metrics.append(m)
            parallel.main_print(
                f"view {i}: " + " ".join(f"{k}={v:.3f}"
                                         for k, v in m.items())
                + f" ({render_times[-1]:.2f}s)")
            if writer:
                np.save(os.path.join(eval_dir, f"rgb_{i:03d}.npy"),
                        img["rgb"])
        avg = {k: float(np.mean([m[k] for m in metrics]))
               for k in metrics[0]}
        avg["median_render_time_s"] = float(np.median(render_times))
        avg["step"] = step
        parallel.main_print(f"step {step} mean:", avg)
        if writer:
            _write_json(os.path.join(eval_dir, "metrics.json"), avg)
            _write_json(os.path.join(eval_dir, f"metrics_{step}.json"), avg)
            with open(os.path.join(eval_dir, f"render_times_{step}.txt"),
                      "w") as f:
                f.write("\n".join(f"{t:.4f}" for t in render_times))
        run.metrics = avg
        run.steps.append(step)

    if not args.follow:
        parallel.main_print(f"restored step {step}")
        eval_checkpoint(step, None)
        return run

    def share(v: int) -> int:
        """Rank 0's value on every rank (itself without a mesh)."""
        if mesh is None:
            return v
        return int(mesh.broadcast(torch.tensor([v], device=device))[0])

    def eval_latest(_detected_step):
        # Re-restore and label with the RESTORED step: the trainer may have
        # saved a newer checkpoint and pruned the detected one meanwhile;
        # if it pruned them all, skip this poll rather than score the init.
        # Under a mesh rank 0 reads the file and the other ranks take its
        # weights.
        params, step = (checkpoints.restore_model_params(out) if writer
                        else (None, 0))
        step = share(-1 if writer and params is None else step)
        if step < 0:
            return None
        if params is not None:
            load_params(model, cfg, params)
        if mesh is not None:
            _broadcast_state(mesh, model)
        eval_checkpoint(step, None)
        return step

    follow_checkpoints(out, eval_latest, poll_every=args.poll_every,
                       timeout=args.follow_timeout,
                       stop_step=args.steps or cfg.max_steps, share=share)
    return run


def cmd_lidar_eval(args) -> types.SimpleNamespace:
    """Replay the scene's real LiDAR returns (every one, or `--max_rays`
    drawn by `RandomState(0)`, the JAX entry's subset) through the field
    and score depth MAE / median / RMSE, the Chamfer distance of the hit
    points (on the device), and per-class IoU / mIoU where the returns
    carry labels; writes lidar_eval/metrics.json, iou.txt,
    pred_depth.npy, gt_depth.npy and pred_semantic.npy under
    exp/<name>/. Returns what was built and the metrics."""
    from .data.batching import cast_lidar_rays
    from .utils import pc_metrics

    cfg = build_config(args)
    device = _device(args.device)
    mesh = _data_mesh(device)
    out = exp_dir(cfg)
    cfg, scene, tracks, track_mask = _scene_model(cfg, "lidar", device)
    data = scene.data
    if data.lidar_origins is None:
        raise SystemExit("scene has no LiDAR returns to replay")
    params, step = _restore_model_params(cfg, args.params, args.allow_fresh)
    parallel.main_print(f"restored step {step}")
    model = build_model(cfg, params, device)

    o, d, gt_depth = (data.lidar_origins, data.lidar_dirs, data.lidar_depth)
    ts = data.lidar_timestamps
    labels = scene.lidar.get("labels") if getattr(scene, "lidar", None) \
        else None  # aligned 1:1 with the rays
    if args.max_rays and o.shape[0] > args.max_rays:
        sel = np.random.RandomState(0).choice(o.shape[0], args.max_rays,
                                              replace=False)
        o, d, gt_depth = o[sel], d[sel], gt_depth[sel]
        ts = ts[sel] if ts is not None else None
        labels = labels[sel] if labels is not None else None
    rays = cast_lidar_rays(o, d, data.near, data.far)
    if ts is not None:
        rays["timestamp"] = ts.astype(np.float32)

    renderer = ChunkRenderer(model, cfg, cfg.render_chunk_size, mesh=mesh)
    outr = renderer.render(rays, tracks, track_mask)
    depth = outr["depth"].reshape(-1)
    err = np.abs(depth - gt_depth)
    pred_pts = o + depth[:, None] * rays["viewdirs"]
    gt_pts = o + gt_depth[:, None] * rays["viewdirs"]
    metrics = {
        "step": int(step),
        "num_rays": int(o.shape[0]),
        "depth_mae": float(err.mean()),
        "depth_median": float(np.median(err)),
        "depth_rmse": float(np.sqrt((err**2).mean())),
    }
    metrics.update(pc_metrics.chamfer_distance(pred_pts, gt_pts,
                                               device=device))

    ious = None
    if "semantic" in outr and labels is not None:
        pred_sem = np.argmax(outr["semantic"], axis=-1)
        ious = pc_metrics.eval_miou(
            pred_sem, labels, num_classes=outr["semantic"].shape[-1])
        metrics.update(ious)
    if parallel.is_main():
        ed = os.path.join(out, "lidar_eval")
        os.makedirs(ed, exist_ok=True)
        if ious is not None:
            with open(os.path.join(ed, "iou.txt"), "w") as f:
                for k, v in ious.items():
                    f.write(f"{k} {v}\n")
        if "semantic" in outr:
            np.save(os.path.join(ed, "pred_semantic.npy"),
                    np.argmax(outr["semantic"], axis=-1))
        np.save(os.path.join(ed, "pred_depth.npy"), depth)
        np.save(os.path.join(ed, "gt_depth.npy"), gt_depth)
        _write_json(os.path.join(ed, "metrics.json"), metrics)
    parallel.main_print("lidar_eval:", json.dumps(metrics))
    return types.SimpleNamespace(cfg=cfg, model=model, renderer=renderer,
                                 rays=rays, tracks=tracks,
                                 track_mask=track_mask, metrics=metrics,
                                 pred_pts=pred_pts, gt_pts=gt_pts)


def _video_module(args, frames_dir: str):
    """imageio for `--video` (imported only then: the port reads and writes
    its PNGs itself), or None without `--video`; a machine without imageio
    stops here, before rendering, with a message that names it."""
    if not args.video:
        return None
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise SystemExit(
            "--video needs imageio (with an ffmpeg backend for mp4, else a "
            "GIF), which is not installed: render the frames without "
            f"--video and join <exp>/{frames_dir}/color_*.png with "
            "ffmpeg") from e
    return imageio


def _assemble_video(imageio, render_dir: str, prefix: str,
                    fps: int = 30) -> Optional[str]:
    """The frame PNGs <prefix>_*.png of `render_dir` -> <prefix>.mp4
    through imageio / ffmpeg, or <prefix>.gif where that has no ffmpeg
    backend (the JAX CLI's `_assemble_video`). Returns the path written,
    None without frames."""
    import glob as globlib
    frames = sorted(globlib.glob(os.path.join(render_dir,
                                              f"{prefix}_*.png")))
    if not frames:
        return None
    path = os.path.join(render_dir, f"{prefix}.mp4")
    try:
        with imageio.get_writer(path, fps=fps) as w:
            for f in frames:
                w.append_data(png.read_png(f))
        print(f"wrote {path}")
    except Exception:  # noqa: BLE001 -- no ffmpeg backend: a GIF instead
        if os.path.exists(path):
            os.remove(path)
        path = os.path.join(render_dir, f"{prefix}.gif")
        imageio.mimsave(path, [png.read_png(f) for f in frames],
                        duration=1.0 / fps)
        print(f"wrote {path} (no ffmpeg; GIF fallback)")
    return path


def cmd_render(args) -> types.SimpleNamespace:
    """Test-view (`--path test`) or ellipse-path frames with colour /
    depth / acc / semantic panels (`compute_extras`, so the final level
    composites without K1, as in JAX) under exp/<name>/render_<path>/;
    `--video` joins the colour frames into color.mp4 (or color.gif without
    ffmpeg), which needs imageio. Returns what was built, the frames and
    the video's path."""
    from .data import camera as camlib
    from .utils import vis as vis_lib

    imageio = _video_module(args, "render_<path>")
    cfg = build_config(args)
    device = _device(args.device)
    mesh = _data_mesh(device)
    out = exp_dir(cfg)
    cfg, scene, tracks, track_mask = _scene_model(cfg, "test", device)
    data = scene.data
    params, step = _restore_model_params(cfg, args.params, args.allow_fresh)
    parallel.main_print(f"restored step {step}")
    model = build_model(cfg, params, device)
    if args.path == "ellipse":
        poses = camlib.generate_ellipse_path(data.camtoworlds,
                                             n_frames=args.num_frames)
    else:
        poses = data.camtoworlds[: args.num_frames or None]
    renderer = ChunkRenderer(model, cfg, cfg.render_chunk_size,
                             compute_extras=True, mesh=mesh)
    render_dir = os.path.join(out, f"render_{args.path}")
    frames = []
    for i, pose in enumerate(poses):
        img = render_view(renderer, _view_rays(data, i, pose), tracks,
                          track_mask)
        if parallel.is_main():
            vis_lib.save_panels(vis_lib.visualize_suite(
                img, near=data.near, far=data.far), render_dir, i)
        frames.append(img)
        parallel.main_print(f"rendered frame {i}")
    video = None
    if imageio is not None and parallel.is_main():
        video = _assemble_video(imageio, render_dir, "color", args.fps)
    parallel.main_print(f"frames in {render_dir}")
    return types.SimpleNamespace(cfg=cfg, model=model, renderer=renderer,
                                 render_dir=render_dir, frames=frames,
                                 video=video)


def cmd_render_video(args) -> types.SimpleNamespace:
    """Scene-edit frames: the `--mode` edit (laneshift, removal, rotate) of
    the tracks, `--insert_track`, then the first `--num_frames` training
    views rendered with colour / depth / acc / semantic panels
    (compute_extras: the final level composites without K1, as in JAX)
    under exp/<name>/video_<mode>/. `--hq` renders 256 + 64 proposal and
    64 NeRF samples. `--video` as `render --video`. Returns what was
    built, the frames and the video's path."""
    from .utils import vis as vis_lib

    imageio = _video_module(args, "video_<mode>")
    cfg = build_config(args)
    device = _device(args.device)
    mesh = _data_mesh(device)
    out = exp_dir(cfg)
    scene = load_scene_for(cfg, "train")
    data = scene.data
    tracks = getattr(scene, "tracks", None)
    track_mask = getattr(scene, "track_mask", None)
    classes = list(getattr(scene, "track_classes", []))
    angle, tracks = objlib.simu_info(args.mode, tracks)
    if tracks is not None and angle:
        tracks = objlib.manipulate_tracks(tracks, angle)
    if args.insert_track and tracks is not None:
        tracks, track_mask, classes = objlib.edit_tracks(
            tracks, track_mask, classes, np.load(args.insert_track))
    cfg = _with_objects(cfg, tracks, classes)
    if args.hq:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, num_prop_samples=(256, 64), num_nerf_samples=64))
    params, step = _restore_model_params(cfg, args.params, args.allow_fresh)
    parallel.main_print(f"restored step {step}")
    model = build_model(cfg, params, device)
    tracks_t, mask_t = _track_tensors(cfg, tracks, track_mask, device)
    renderer = ChunkRenderer(model, cfg, cfg.render_chunk_size,
                             compute_extras=True, mesh=mesh)
    render_dir = os.path.join(out, f"video_{args.mode}")
    frames = []
    for i in range(min(args.num_frames, data.num_views)):
        img = render_view(renderer, _view_rays(data, i), tracks_t, mask_t)
        if parallel.is_main():
            vis_lib.save_panels(vis_lib.visualize_suite(
                img, near=data.near, far=data.far), render_dir, i)
        frames.append(img)
        parallel.main_print(f"rendered frame {i}")
    video = None
    if imageio is not None and parallel.is_main():
        video = _assemble_video(imageio, render_dir, "color", args.fps)
    parallel.main_print(f"frames in {render_dir}")
    return types.SimpleNamespace(cfg=cfg, model=model, renderer=renderer,
                                 data=data, render_dir=render_dir,
                                 frames=frames, tracks=tracks_t,
                                 track_mask=mask_t, video=video)


def cmd_render_instance(args) -> types.SimpleNamespace:
    """Orbit-render one dynamic object's field alone
    (`models/objects.render_instance`: `--num_views` views of `--size`^2
    around its box) into exp/<name>/instance_<track_id>/view_<i>.png.
    Returns what was built and the frames."""
    cfg = build_config(args)
    device = _device(args.device)
    scene = load_scene_for(cfg, "train")
    tracks = getattr(scene, "tracks", None)
    if tracks is None:
        raise SystemExit("scene has no tracks; render_instance needs "
                         "instance_obj data")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, instance_obj=True, num_objects=int(tracks.shape[0])))
    params, step = _restore_model_params(cfg, args.params, args.allow_fresh)
    print(f"restored step {step}")
    model = build_model(cfg, params, device)
    frames = objlib.render_instance(model, args.track_id, height=args.size,
                                    width=args.size,
                                    num_views=args.num_views)
    out = os.path.join(exp_dir(cfg), f"instance_{args.track_id}")
    os.makedirs(out, exist_ok=True)
    for i, frame in enumerate(frames):
        png.write_png(os.path.join(out, f"view_{i:03d}.png"),
                      (np.clip(frame, 0, 1) * 255).astype(np.uint8))
    print(f"{len(frames)} views in {out}")
    return types.SimpleNamespace(cfg=cfg, model=model, frames=frames,
                                 out=out)


def cmd_extract(args) -> types.SimpleNamespace:
    """Mesh extraction (`extract.extract_mesh`) of the static field:
    density on a `--resolution`^3 lattice of contracted space, the
    `--threshold` isosurface, `--clean`, `--decimate N` faces, vertex
    colours unless `--no_color`; writes exp/<name>/mesh.ply. Returns what
    was built and the mesh."""
    from .extract import extract_mesh

    cfg = build_config(args)
    device = _device(args.device)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, instance_obj=False))
    params, step = _restore_model_params(cfg, args.params, args.allow_fresh)
    print(f"restored step {step}")
    model = build_model(cfg, params, device)
    out = exp_dir(cfg)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "mesh.ply")
    verts, faces, colors = extract_mesh(
        model, resolution=args.resolution,
        isosurface_threshold=args.threshold, out_path=path,
        vertex_color=not args.no_color, clean=args.clean,
        decimate_target=args.decimate)
    print(f"mesh: {len(verts)} verts, {len(faces)} faces -> {path}")
    return types.SimpleNamespace(cfg=cfg, model=model, verts=verts,
                                 faces=faces, colors=colors, path=path)


def _load_features(path: str) -> Dict[str, np.ndarray]:
    if not path.endswith(".npy"):
        raise SystemExit("--features must point to a .npy dict of "
                         "images/masks/ranges (see build_training_set)")
    return np.load(path, allow_pickle=True).item()


def cmd_raydrop_features(args):
    """Scene-scanning feature assembly: pair each scene dir's real .bin
    sweeps with its rendered replay sweeps, build the 6-channel feature
    stacks + GT masks/ranges, persist one .npy dict that raydrop_train
    consumes. Repeatable --pair scene_dir:sim_dir spans multiple scenes.
    Host numpy only. Returns the dict written."""
    from .raydrop import features as feat_lib

    for p in args.pair or []:
        if ":" not in p:
            raise SystemExit(f"--pair must be scene_dir:sim_sweep_dir "
                             f"(got {p!r})")
    pairs = [p.split(":", 1) for p in args.pair or []]
    if args.data_dir and args.sim_dir:
        pairs.append([args.data_dir, args.sim_dir])
    if not pairs:
        raise SystemExit("need --pair scene_dir:sim_dir (repeatable) or "
                         "--data_dir + --sim_dir")
    sets = []
    for scene_dir, sim_dir in pairs:
        s = feat_lib.assemble_training_set(scene_dir, sim_dir,
                                           h=args.height, w=args.width)
        print(f"{scene_dir} + {sim_dir}: {s['images'].shape[0]} sweeps")
        sets.append(s)
    data = feat_lib.concat_training_sets(sets)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.save(args.out, data, allow_pickle=True)
    print(f"wrote {data['images'].shape[0]} feature frames "
          f"{data['images'].shape[1:]} to {args.out}")
    return data


def cmd_raydrop_train(args) -> types.SimpleNamespace:
    """Train the ray-drop U-Net on a features .npy; checkpoints and
    metrics.json under exp/<exp_name>/. Returns the trainer, its final
    state and the per-epoch history."""
    from .raydrop.trainer import RayDropConfig, RayDropTrainer

    data = _load_features(args.features)
    cfg = RayDropConfig(epochs=args.epochs, vgg=not args.no_vgg,
                        vgg_npz=args.vgg_npz, darknet=args.darknet,
                        darknet_npz=args.darknet_npz,
                        batch_size=args.batch_size)
    trainer = RayDropTrainer(cfg, device=_device(args.device))
    out = os.path.join("exp", args.exp_name or "raydrop")
    state = trainer.fit(data, save_dir=out)
    print(f"raydrop checkpoints in {out}")
    return types.SimpleNamespace(trainer=trainer, state=state,
                                 history=trainer.history, out=out)


def cmd_raydrop_drop(args) -> types.SimpleNamespace:
    """Drop rays of rendered sweeps with a trained U-Net and export
    SemanticKITTI velodyne/*.bin + labels/*.label, summary.json and the
    sensor metadata (lidar2egos / ego2globals)."""
    from .lidar import export as export_lib
    from .raydrop import features as feat_lib
    from .raydrop import infer as infer_lib
    from .raydrop.trainer import RayDropConfig, RayDropTrainer

    trainer = RayDropTrainer(RayDropConfig(vgg=False),
                             device=_device(args.device))
    state = trainer.restore(args.ckpt)
    sweeps, l2g = feat_lib.load_sim_sweep_dir(args.simulation_path)
    if l2g is not None:
        # Rendered points are world-frame; the range projection needs the
        # sensor frame (nerf2world.nerf_to_lidar).
        sweeps = [(feat_lib.world_points_to_sensor(p, l2g[i]), s, r)
                  for i, (p, s, r) in enumerate(sweeps)]
    n = infer_lib.drop_and_export(trainer, state, sweeps, args.out,
                                  h=args.height, w=args.width,
                                  car_median_rule=args.place_car)
    # Export summary: points/sweep + (with --features) drop-mask quality
    # vs the real sensor's GT pattern.
    summary = {"sweeps": n}
    pts = [len(export_lib.read_bin(os.path.join(
        args.out, "velodyne", f"{i:06d}.bin"))) for i in range(n)]
    summary["points_per_sweep"] = float(np.mean(pts)) if pts else 0.0
    if args.features:
        data = _load_features(args.features)
        summary.update(trainer.evaluate(
            state, data["images"], data["masks"], data["ranges"]))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("summary: " + json.dumps(summary))
    if l2g is not None:
        # Sensor metadata for SemanticKITTI consumers: the ego is folded
        # into the sensor frame, so lidar2ego = I and ego2global =
        # lidar2global.
        export_lib.write_sensor_metadata(
            args.out, np.tile(np.eye(4), (len(sweeps), 1, 1)),
            l2g[: len(sweeps)])
    print(f"exported {n} sweeps to {args.out}")
    return types.SimpleNamespace(trainer=trainer, state=state, sweeps=n,
                                 summary=summary)


def cmd_raydrop_val_vis(args):
    """Validation-split drop-mask .obj dumps + accuracy (see
    raydrop/val_vis.py). Returns the metrics."""
    from .raydrop import val_vis
    from .raydrop.trainer import RayDropConfig, RayDropTrainer

    data = _load_features(args.features)
    trainer = RayDropTrainer(RayDropConfig(vgg=False,
                                           val_fraction=args.val_fraction),
                             device=_device(args.device))
    state = trainer.restore(args.ckpt)
    metrics = val_vis.dump_val_masks(trainer, state, data, args.out,
                                     threshold=args.threshold,
                                     seed=args.seed,
                                     max_frames=args.max_frames)
    print("val_vis: " + " ".join(
        f"{k}={v:.4f}" for k, v in metrics.items()
        if isinstance(v, float)))
    print(f"wrote raw/gt/pred/real .obj per val frame to {args.out}")
    return metrics


def cmd_points_vis(args):
    """Point-cloud inspection dumps: read .bin/.npy clouds (+ optional
    .label), filter by class / sky / z-floor, write .obj files named per
    variant for side-by-side comparison. Host numpy only."""
    from .lidar import export as export_lib

    classes = ([int(c) for c in args.classes.split(",")]
               if args.classes else None)
    os.makedirs(args.out, exist_ok=True)
    written = []
    for spec in args.points:
        name, _, path = spec.rpartition("=")
        if not name:
            name = os.path.splitext(os.path.basename(path))[0]
        labels = None
        lab_path = args.labels
        if lab_path is None and path.endswith(".bin"):
            cand = path.replace("velodyne", "labels")[:-3] + "label"
            lab_path = cand if os.path.exists(cand) and cand != path \
                else None
        if lab_path:
            labels = export_lib.read_label(lab_path)
        pts = export_lib.load_points_any(
            path, dims=args.dims,
            n_points=0 if labels is None else len(labels))
        if labels is not None:
            labels = labels[: len(pts)]
        keep = np.ones(len(pts), bool)
        if labels is not None:
            if classes:  # e.g. 13,14,15 = vehicles
                keep &= np.isin(labels, classes)
            if args.drop_sky:
                keep &= labels != 10
        if args.z_min is not None:
            keep &= pts[:, 2] > args.z_min
        if labels is not None and args.per_class:
            # One .obj per class id, label appended.
            for c in np.unique(labels[keep]):
                sel = keep & (labels == c)
                out = os.path.join(args.out, f"{name}_class{int(c)}.obj")
                export_lib.write_obj(
                    out, np.concatenate(
                        [pts[sel], labels[sel, None].astype(np.float32)],
                        axis=1))
                written.append((out, int(sel.sum())))
        else:
            out = os.path.join(args.out, f"{name}.obj")
            export_lib.write_obj(out, pts[keep])
            written.append((out, int(keep.sum())))
    for out, n in written:
        print(f"{out}: {n} points")
    return written


def _torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint's state dict as numpy arrays (`module.` prefixes
    dropped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {(k[len("module."):] if k.startswith("module.") else k):
            v.detach().cpu().numpy() for k, v in sd.items()}


def cmd_validate_scene(args) -> types.SimpleNamespace:
    """Check a nuScenes-layout scene directory against every convention
    the loader assumes (`data/validate.py`); prints the report as the JAX
    CLI does. Returns the report and the exit code (0 without an ERROR,
    else 1)."""
    from .data import validate as vlib
    rep = vlib.validate_scene(args.scene_dir, sensor_num=args.sensor_num,
                              factor=args.factor)
    for line in rep.info:
        print(f"  {line}")
    for issue in rep.issues:
        print(str(issue))
    n_err = sum(i.level == "ERROR" for i in rep.issues)
    n_warn = len(rep.issues) - n_err
    print(f"{'OK' if rep.ok else 'FAIL'}: {n_err} errors, {n_warn} warnings")
    return types.SimpleNamespace(report=rep, code=0 if rep.ok else 1)


def cmd_convert_rangenet(args):
    """A rangenet darknet-53 `backbone` torch checkpoint -> the .npz that
    `raydrop_train --darknet_npz` (and the JAX package) takes, loaded back
    into the port's Darknet-53 as a structural check."""
    from .raydrop import darknet as dk_lib

    arrays = {k: v for k, v in _torch_checkpoint(args.backbone).items()
              if not k.endswith("num_batches_tracked")}
    np.savez(args.out, **arrays)
    model = dk_lib.load_rangenet(args.out)
    n = sum(p.numel() for p in model.parameters())
    print(f"wrote {args.out}: {len(arrays)} tensors, {n:,} params loaded "
          "into the port's Darknet-53 OK")
    return 0


def cmd_convert_vgg(args):
    """A torchvision VGG19 checkpoint (.pth state_dict) -> the
    features.N.weight .npz that `raydrop_train --vgg_npz` (and the JAX
    package) takes, loaded back into the port's VGG19 trunk as a
    structural check."""
    from .raydrop import vgg as vgg_lib

    arrays = {k: v for k, v in _torch_checkpoint(args.ckpt).items()
              if k.startswith("features.")}  # the loss uses the conv trunk
    np.savez(args.out, **arrays)
    model = vgg_lib.load_vgg19(args.out)
    n = sum(p.numel() for p in model.parameters())
    print(f"wrote {args.out}: {len(arrays)} tensors, {n:,} params loaded "
          "into the port's VGG19 trunk OK")
    return 0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("nerf_lidar_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", default="nuscenes_single",
                        choices=CONFIGS)
        sp.add_argument("--config_json", default=None,
                        help="load a config.json snapshot instead of a "
                             "named base config")
        sp.add_argument("--data_dir", default=None)
        sp.add_argument("--exp_name", default=None)
        sp.add_argument("--set", action="append", default=[],
                        help="dotted config override key=value")
        sp.add_argument("--device", default="cuda",
                        help="torch device; cuda with no GPU is an error")

    def weights(sp):
        sp.add_argument("--params", default=None,
                        help="weights: a params_<step>.npz (Flax param tree, "
                             "flat '/'-keyed) or a JAX checkpoint_<step>.ckpt;"
                             " default: the newest of either in exp/<name>/")
        sp.add_argument("--allow_fresh", action="store_true",
                        help="render from a seeded fresh init when there are "
                             "no weights (debugging only)")

    sp = sub.add_parser("train")
    common(sp)
    sp.add_argument("--multihost", action="store_true",
                    help="a torchrun launch over several hosts: each "
                         "host's batches seeded seed + GROUP_RANK")
    sp.add_argument("--steps", type=int, default=None,
                    help="stop after this many steps (default: the "
                         "config's max_steps, which also sets the "
                         "schedules)")
    sp.add_argument("--tensorboard", action="store_true",
                    help="also mirror scalar metrics to <exp>/tb "
                         "(tensorboardX, when installed)")
    sp.add_argument("--trace_dir", default=None,
                    help="write a torch.profiler Chrome trace of steps "
                         "[trace_start, trace_stop] to this dir")
    sp.add_argument("--trace_start", type=int, default=10)
    sp.add_argument("--trace_stop", type=int, default=15)
    sp.add_argument("--obj_ckpt", action="append", default=[],
                    help="transplant a pre-trained obj MLP subtree: "
                         "name=path (e.g. obj_mlp_cls2=car.ckpt)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("eval")
    common(sp)
    weights(sp)
    sp.add_argument("--max_views", type=int, default=0)
    sp.add_argument("--follow", action="store_true",
                    help="poll for new checkpoints and evaluate each")
    sp.add_argument("--poll_every", type=float, default=10.0)
    sp.add_argument("--follow_timeout", type=float, default=1800.0,
                    help="stop after this many idle seconds (0 = never)")
    sp.add_argument("--steps", type=int, default=0,
                    help="stop --follow once this step is evaluated")
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("lidar_eval")
    common(sp)
    weights(sp)
    sp.add_argument("--max_rays", type=int, default=0,
                    help="subsample the replayed returns (0 = all)")
    sp.set_defaults(fn=cmd_lidar_eval)

    sp = sub.add_parser("render")
    common(sp)
    weights(sp)
    sp.add_argument("--path", default="test", choices=["test", "ellipse"])
    sp.add_argument("--num_frames", type=int, default=0)
    sp.add_argument("--video", action="store_true",
                    help="also join the colour frames into color.mp4 "
                         "(color.gif without ffmpeg); needs imageio")
    sp.add_argument("--fps", type=int, default=30)
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("render_video")
    common(sp)
    weights(sp)
    sp.add_argument("--mode", default="replay",
                    choices=["replay", "laneshift", "removal", "rotate"])
    sp.add_argument("--num_frames", type=int, default=10)
    sp.add_argument("--insert_track", default=None,
                    help="npy track ([T, 9]) to insert into the scene")
    sp.add_argument("--hq", action="store_true",
                    help="256 + 64 proposal and 64 NeRF samples")
    sp.add_argument("--video", action="store_true",
                    help="also join the colour frames into color.mp4 "
                         "(color.gif without ffmpeg); needs imageio")
    sp.add_argument("--fps", type=int, default=30)
    sp.set_defaults(fn=cmd_render_video)

    sp = sub.add_parser("render_instance")
    common(sp)
    weights(sp)
    sp.add_argument("--track_id", type=int, default=0)
    sp.add_argument("--size", type=int, default=128)
    sp.add_argument("--num_views", type=int, default=8)
    sp.set_defaults(fn=cmd_render_instance)

    sp = sub.add_parser("extract")
    common(sp)
    weights(sp)
    sp.add_argument("--resolution", type=int, default=256)
    sp.add_argument("--threshold", type=float, default=20.0)
    sp.add_argument("--no_color", action="store_true")
    sp.add_argument("--clean", action="store_true",
                    help="post-process: merge close verts, drop "
                         "duplicate/null faces + small components")
    sp.add_argument("--decimate", type=int, default=0,
                    help="decimate to <= N faces (quadric edge collapse up "
                         "to 100,000 faces, vertex clustering above)")
    sp.set_defaults(fn=cmd_extract)

    sp = sub.add_parser("render_lidar")
    common(sp)
    weights(sp)
    sp.add_argument("--mode", default="simu", choices=["replay", "simu"],
                    help="trajectory: replay the real drive or simulate one")
    sp.add_argument("--obj_mode", default="replay",
                    choices=["replay", "laneshift", "removal", "rotate"],
                    help="scene-edit mode applied to the dynamic-object "
                         "tracks")
    sp.add_argument("--insert_track", default=None,
                    help="npy track ([T, 9]) to insert into the scene")
    sp.add_argument("--num_sweeps", type=int, default=10)
    sp.add_argument("--azimuth_steps", type=int, default=1100,
                    help="azimuth samples per beam (32 beams x this = "
                         "rays/sweep)")
    sp.add_argument("--complicated", action="store_true")
    sp.add_argument("--start", type=float, nargs=3)
    sp.add_argument("--end", type=float, nargs=3)
    sp.set_defaults(fn=cmd_render_lidar)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device; cuda with no GPU is an error")

    sp = sub.add_parser("points_vis")
    sp.add_argument("--points", action="append", required=True,
                    help="[name=]path to .bin/.npy cloud, repeatable "
                         "(multi-variant comparison dumps)")
    sp.add_argument("--labels", default=None,
                    help=".label file (auto-derived from velodyne/ paths)")
    sp.add_argument("--out", default="points_vis")
    sp.add_argument("--classes", default=None,
                    help="keep only these class ids, e.g. 13,14,15")
    sp.add_argument("--per_class", action="store_true",
                    help="one .obj per class id with the label appended")
    sp.add_argument("--drop_sky", action="store_true",
                    help="drop class 10 (sky) points")
    sp.add_argument("--z_min", type=float, default=None,
                    help="drop points at or below this height, e.g. -1.75")
    sp.add_argument("--dims", type=int, default=0,
                    help="force .bin row width (default: infer 5/4/3)")
    sp.set_defaults(fn=cmd_points_vis)

    sp = sub.add_parser("raydrop_val_vis")
    sp.add_argument("--features", required=True,
                    help="the .npy the trainer consumed")
    sp.add_argument("--ckpt", required=True,
                    help="raydrop_#####.pt, its Flax-layout .npz, or the "
                         "JAX package's raydrop_#####.ckpt")
    sp.add_argument("--out", default="mask_vis")
    sp.add_argument("--threshold", type=float, default=0.5)
    sp.add_argument("--seed", type=int, default=0,
                    help="the fit seed (reproduces its val split)")
    sp.add_argument("--val_fraction", type=float, default=0.2)
    sp.add_argument("--max_frames", type=int, default=0)
    device(sp)
    sp.set_defaults(fn=cmd_raydrop_val_vis)

    sp = sub.add_parser("validate_scene")
    sp.add_argument("scene_dir")
    sp.add_argument("--sensor_num", type=int, default=6)
    sp.add_argument("--factor", type=int, default=1)
    sp.set_defaults(fn=cmd_validate_scene)

    sp = sub.add_parser("convert_rangenet")
    sp.add_argument("--backbone", required=True,
                    help="rangenet.lib 'backbone' torch checkpoint file")
    sp.add_argument("--out", required=True, help="output .npz path")
    sp.set_defaults(fn=cmd_convert_rangenet)

    sp = sub.add_parser("convert_vgg")
    sp.add_argument("--ckpt", required=True,
                    help="torchvision VGG19 .pth state_dict")
    sp.add_argument("--out", required=True, help="output .npz path")
    sp.set_defaults(fn=cmd_convert_vgg)

    sp = sub.add_parser("raydrop_train")
    sp.add_argument("--features", required=True)
    sp.add_argument("--exp_name", default="raydrop")
    sp.add_argument("--epochs", type=int, default=100)
    sp.add_argument("--batch_size", type=int, default=4)
    sp.add_argument("--no_vgg", action="store_true")
    sp.add_argument("--vgg_npz", default=None,
                    help="VGG19 weights: torchvision .pth or .npz, or the "
                         "Flax-layout .npz of pretrain.save_vgg_npz")
    sp.add_argument("--darknet", action="store_true",
                    help="add the rangenet darknet-53 feature loss")
    sp.add_argument("--darknet_npz", default=None,
                    help="rangenet backbone weights (.pth or .npz)")
    device(sp)
    sp.set_defaults(fn=cmd_raydrop_train)

    sp = sub.add_parser("raydrop_features")
    sp.add_argument("--pair", action="append", default=[],
                    help="scene_dir:rendered_sweep_dir, repeatable")
    sp.add_argument("--data_dir", default=None)
    sp.add_argument("--sim_dir", default=None,
                    help="rendered sweep dir (e.g. exp/x/lidar_replay)")
    sp.add_argument("--out", required=True, help="output features .npy")
    sp.add_argument("--height", type=int, default=32)
    sp.add_argument("--width", type=int, default=1024)
    sp.set_defaults(fn=cmd_raydrop_features)

    sp = sub.add_parser("raydrop_drop")
    sp.add_argument("--ckpt", required=True,
                    help="raydrop_#####.pt, its Flax-layout .npz, or the "
                         "JAX package's raydrop_#####.ckpt")
    sp.add_argument("--simulation_path", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--height", type=int, default=32)
    sp.add_argument("--width", type=int, default=1024)
    sp.add_argument("--place_car", action="store_true",
                    help="per-image median car-probability keep rule")
    sp.add_argument("--features", default=None,
                    help="feature .npy with GT masks/ranges: also writes "
                         "drop-mask IoU/precision/recall + range MAE into "
                         "<out>/summary.json")
    device(sp)
    sp.set_defaults(fn=cmd_raydrop_drop)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    # validate_scene's code: 1 on an ERROR, so `validate_scene DIR &&
    # train ...` stops at a broken scene.
    raise SystemExit(getattr(main(), "code", 0))
