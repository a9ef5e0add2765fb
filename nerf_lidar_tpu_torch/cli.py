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

On a scene with dynamic-object tracks (`bboxes.json`; `data/synth_nusc.py`
writes one) and a config with `instance_obj`, `train` fits the object
MLPs and latents beside the field (with the tracknet under
`track_refine`, the posenet under `pose_refine`), and `render_lidar`
composites the vehicles into the sweeps, edited by `--obj_mode` and
`--insert_track`.

Config, overrides and scene loading (`build_config`, `apply_overrides`,
`load_scene_for`, `exp_dir`) are copies of the JAX CLI's helpers over the
port's own `configs` and `data` modules, so a preset and a `--set` mean the
same thing in both packages (`tests/test_torch_host.py`). `train` writes
the weights as a Flax param tree in a flat .npz (see `convert.py`), which
`render_lidar --params` and the JAX package both read; `render_lidar` can
also start from a seeded fresh init for debugging (`--allow_fresh`).
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

from . import configs, convert
from .data.batching import RayBatcher
from .lidar import sensor
from .lidar.render import render_sweeps_to_dir
from .models import objects as objlib
from .models import posenet as posenet_lib
from .models.model import Model
from .ops import grid
from .renderer import ChunkRenderer
from .train import checkpoints, train_step

# The presets whose every flag is ported (the `_fast`, `_mxu` and `_speed`
# presets set `ms_coarse_res_cutoff`, which is not).
CONFIGS = ["nuscenes_single", "nuscenes_multi", "tiny_debug", "default"]


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
    """Dataset registry: {synthetic, nusc/waymo}. The llff / blender /
    colmap and tat / dtu loaders are not ported yet."""
    if cfg.dataset_loader in ("llff", "blender", "colmap", "tat_nerfpp",
                              "tat_fvs", "dtu"):
        raise SystemExit(
            f"dataset_loader={cfg.dataset_loader!r} is not ported yet: use "
            "nerf_lidar_tpu.cli")
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
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu for a CPU run)")
    return dev


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


def build_model(cfg, params_path: Optional[str], allow_fresh: bool,
                device: torch.device) -> Model:
    """The scene model with `--params` weights (a model without objects
    skips the object leaves; inserted object slots get zero latents), or a
    fresh init seeded by `cfg.seed` when `allow_fresh`; refuses an
    untrained model otherwise."""
    if not params_path and not allow_fresh:
        raise SystemExit(
            "no --params given: refusing to render from an untrained init "
            "(pass --params <npz> with trained weights, or --allow_fresh to "
            "debug)")
    model = Model(cfg.model, device=device)
    if params_path:
        params = convert.load_npz_params(params_path)
        if model.has_objects:
            params = _pad_obj_latents(params, cfg.model.num_objects)
        model.load_state_dict(convert.flax_to_state_dict(params, cfg.model))
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


def cmd_train(args) -> types.SimpleNamespace:
    """Fit a scene: RayBatcher batches -> `train_step`, printing loss /
    PSNR / rays per second every `print_every` steps and writing
    checkpoint_<step>.pt + params_<step>.npz under exp/<name>/ every
    `checkpoint_every` steps and at the end. With tracks and
    `instance_obj`, one object slot per track (the moving-object mask then
    stays off, since the objects model those pixels), the tracknet under
    `track_refine`; the posenet (one row per view, one for the LiDAR)
    under `pose_refine`. Resumes from the newest checkpoint there. Returns
    what was built, the printed stats (`history`) and the last
    checkpoint's paths."""
    cfg = build_config(args)
    cfg.validate()
    device = _device(args.device)
    out = exp_dir(cfg)
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

    batcher = RayBatcher(scene.data, cfg.batch_size, cfg.patch_size,
                         lidar_supervision=cfg.lidar_supervision,
                         lidar_batch_ratio=cfg.lidar_batch_ratio,
                         only_lidar_depth=cfg.only_lidar_supervision,
                         aug_road=cfg.aug_road, aug_delta=cfg.aug_delta,
                         apply_bayer_mask=cfg.apply_bayer_mask,
                         seed=cfg.seed, mask_moving=tracks is None)
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
    optimizer = train_step.make_optimizer(model, cfg, posenet, tracknet)
    init_step = checkpoints.restore_checkpoint(out, model, optimizer,
                                               posenet, tracknet)
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 17)
    max_steps = args.steps or cfg.max_steps

    history, paths = [], (None, None)
    mark, mark_step = time.perf_counter(), init_step
    for step in range(init_step, max_steps):
        batch = to_device(batcher.next(), device)
        stats = train_step.train_step(
            model, optimizer, cfg, batch, step, batcher.num_patch_rays,
            generator, posenet=posenet, tracknet=tracknet, tracks=tracks,
            track_mask=track_mask)
        if (step + 1) % cfg.print_every == 0:
            vals = {k: float(v) for k, v in stats.items()
                    if not k.startswith("_")}  # waits for the step
            now = time.perf_counter()
            seconds = (now - mark) / (step + 1 - mark_step)
            vals.update(step=step + 1, step_s=seconds,
                        rays_per_sec=batcher.total_rays / seconds)
            history.append(vals)
            print(f"step {step + 1}: loss={vals['loss']:.4f} "
                  f"psnr={vals['psnr']:.2f} "
                  f"rays/s={vals['rays_per_sec']:,.0f}", flush=True)
            mark, mark_step = time.perf_counter(), step + 1
        if (step + 1) % cfg.checkpoint_every == 0 or step + 1 == max_steps:
            paths = checkpoints.save_checkpoint(
                out, model, optimizer, step + 1, keep=cfg.checkpoint_keep,
                posenet=posenet, tracknet=tracknet)
            mark, mark_step = time.perf_counter(), step + 1
    print(f"kernel launches: hash_encode_ms="
          f"{grid.hash_encode_multisample.launches} hash_encode_ms_bwd="
          f"{grid.hash_encode_multisample_bwd.launches} scatter_add_rows="
          f"{grid.scatter_add_rows.launches}")
    print(f"done: {out}")
    return types.SimpleNamespace(
        cfg=cfg, model=model, optimizer=optimizer, batcher=batcher,
        generator=generator, history=history, out=out,
        checkpoint=paths[0], params=paths[1], posenet=posenet,
        tracknet=tracknet, tracks=tracks, track_mask=track_mask)


def cmd_render_lidar(args) -> types.SimpleNamespace:
    """Render LiDAR sweeps of a scene, its vehicles included, and write the
    points / points_semantic / points_rgb trio plus lidar2globals.npy under
    exp/<name>/lidar_<mode>[_<obj_mode>]/. `--obj_mode` edits the tracks
    (laneshift, removal, rotate), `--insert_track` adds one; every sweep
    carries its timestamp, which places the vehicles. Returns what was
    built and written."""
    cfg = build_config(args)
    device = _device(args.device)
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
    model = build_model(cfg, args.params, args.allow_fresh, device)
    tracks_t, mask_t = _track_tensors(cfg, tracks, track_mask, device)
    print(f"dynamic objects: {0 if tracks_t is None else len(tracks_t)} "
          f"(obj_mode={args.obj_mode})")
    renderer = ChunkRenderer(model, cfg, cfg.render_chunk_size)
    name = (f"lidar_{args.mode}" if args.obj_mode == "replay"
            else f"lidar_{args.mode}_{args.obj_mode}")
    sweep_dir = os.path.join(out, name)
    data = scene.data
    paths = render_sweeps_to_dir(renderer, sweeps, data.near, data.far,
                                 scene.frame, sweep_dir, tracks_t, mask_t)
    np.save(os.path.join(sweep_dir, "lidar2globals.npy"), l2g)
    print(f"wrote {len(paths)} sweeps to {sweep_dir}")
    return types.SimpleNamespace(
        cfg=cfg, model=model, renderer=renderer, sweeps=sweeps,
        near=data.near, far=data.far, frame=scene.frame,
        sweep_dir=sweep_dir, paths=paths, tracks=tracks_t,
        track_mask=mask_t)


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

    sp = sub.add_parser("train")
    common(sp)
    sp.add_argument("--steps", type=int, default=None,
                    help="stop after this many steps (default: the "
                         "config's max_steps, which also sets the "
                         "schedules)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("render_lidar")
    common(sp)
    sp.add_argument("--params", default=None,
                    help="Flax param tree as a flat '/'-keyed .npz")
    sp.add_argument("--allow_fresh", action="store_true",
                    help="render from a seeded fresh init when no --params "
                         "is given (debugging only)")
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
                    help="raydrop_#####.pt (or its Flax-layout .npz)")
    sp.add_argument("--out", default="mask_vis")
    sp.add_argument("--threshold", type=float, default=0.5)
    sp.add_argument("--seed", type=int, default=0,
                    help="the fit seed (reproduces its val split)")
    sp.add_argument("--val_fraction", type=float, default=0.2)
    sp.add_argument("--max_frames", type=int, default=0)
    device(sp)
    sp.set_defaults(fn=cmd_raydrop_val_vis)

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
                    help="raydrop_#####.pt (or its Flax-layout .npz)")
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
    main()
