"""Command-line entry of the port (counterpart of `nerf_lidar_tpu/cli.py`).

  python -m nerf_lidar_tpu_torch.cli train --config nuscenes_single \
      --set dataset_loader=synthetic --exp_name myscene --steps 1000
  python -m nerf_lidar_tpu_torch.cli render_lidar --config nuscenes_single \
      --exp_name myscene --mode simu --num_sweeps 10 \
      --params exp/myscene/params_1000.npz

Config, overrides and scene loading are the JAX package's own jax-free
helpers (`build_config`, `apply_overrides`, `load_scene_for`, `exp_dir`), so
a preset and a `--set` mean the same thing in both packages. `train` writes
the weights as a Flax param tree in a flat .npz (see `convert.py`), which
`render_lidar --params` and the JAX package both read; `render_lidar` can
also start from a seeded fresh init for debugging (`--allow_fresh`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from nerf_lidar_tpu.cli import build_config, exp_dir, load_scene_for
from nerf_lidar_tpu.data.batching import RayBatcher
from nerf_lidar_tpu.lidar import sensor

from . import convert
from .lidar.render import render_sweeps_to_dir
from .models.model import Model
from .ops import grid
from .renderer import ChunkRenderer
from .train import checkpoints, train_step

# The presets whose every flag is ported (the `_fast`, `_mxu` and `_speed`
# presets set `ms_coarse_res_cutoff`, which is not).
CONFIGS = ["nuscenes_single", "nuscenes_multi", "tiny_debug", "default"]


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu for a CPU run)")
    return dev


def build_model(cfg, params_path: Optional[str], allow_fresh: bool,
                device: torch.device) -> Model:
    """The scene model with `--params` weights, or a fresh init seeded by
    `cfg.seed` when `allow_fresh`; refuses an untrained model otherwise."""
    if not params_path and not allow_fresh:
        raise SystemExit(
            "no --params given: refusing to render from an untrained init "
            "(pass --params <npz> with trained weights, or --allow_fresh to "
            "debug)")
    model = Model(cfg.model, device=device)
    if params_path:
        model.load_state_dict(convert.flax_to_state_dict(
            convert.load_npz_params(params_path), cfg.model))
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


def _static_scene(cfg, split: str, entry: str):
    """Load the scene; refuse one with dynamic-object tracks (not ported)
    and turn the config's objects off. Returns (cfg, scene)."""
    scene = load_scene_for(cfg, split)
    if getattr(scene, "tracks", None) is not None and cfg.model.instance_obj:
        raise SystemExit(
            "this scene has dynamic-object tracks, and dynamic objects are "
            f"not ported yet: run it with nerf_lidar_tpu.cli {entry}")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, instance_obj=False, num_objects=0, obj_sem_ids=())), scene


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
    """Fit the static field of a scene: RayBatcher batches -> `train_step`,
    printing loss / PSNR / rays per second every `print_every` steps and
    writing checkpoint_<step>.pt + params_<step>.npz under exp/<name>/
    every `checkpoint_every` steps and at the end. Resumes from the newest
    checkpoint there. Returns what was built, the printed stats (`history`)
    and the last checkpoint's paths."""
    cfg = build_config(args)
    cfg.validate()
    device = _device(args.device)
    out = exp_dir(cfg)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "config.json"), "w") as f:
        f.write(cfg.to_json())
    cfg, scene = _static_scene(cfg, "train", "train")
    train_step.check_ported(cfg, getattr(scene, "tracks", None) is not None)

    batcher = RayBatcher(scene.data, cfg.batch_size, cfg.patch_size,
                         lidar_supervision=cfg.lidar_supervision,
                         lidar_batch_ratio=cfg.lidar_batch_ratio,
                         only_lidar_depth=cfg.only_lidar_supervision,
                         aug_road=cfg.aug_road, aug_delta=cfg.aug_delta,
                         apply_bayer_mask=cfg.apply_bayer_mask,
                         seed=cfg.seed, mask_moving=True)
    model = Model(cfg.model, device=device)
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    optimizer = train_step.make_optimizer(model, cfg)
    init_step = checkpoints.restore_checkpoint(out, model, optimizer)
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 17)
    max_steps = args.steps or cfg.max_steps

    history, paths = [], (None, None)
    mark, mark_step = time.perf_counter(), init_step
    for step in range(init_step, max_steps):
        batch = to_device(batcher.next(), device)
        stats = train_step.train_step(model, optimizer, cfg, batch, step,
                                      batcher.num_patch_rays, generator)
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
            paths = checkpoints.save_checkpoint(out, model, optimizer,
                                                step + 1,
                                                keep=cfg.checkpoint_keep)
            mark, mark_step = time.perf_counter(), step + 1
    print(f"kernel launches: hash_encode_ms="
          f"{grid.hash_encode_multisample.launches} hash_encode_ms_bwd="
          f"{grid.hash_encode_multisample_bwd.launches} scatter_add_rows="
          f"{grid.scatter_add_rows.launches}")
    print(f"done: {out}")
    return types.SimpleNamespace(
        cfg=cfg, model=model, optimizer=optimizer, batcher=batcher,
        generator=generator, history=history, out=out,
        checkpoint=paths[0], params=paths[1])


def cmd_render_lidar(args) -> types.SimpleNamespace:
    """Render LiDAR sweeps of a static scene and write the
    points / points_semantic / points_rgb trio plus lidar2globals.npy under
    exp/<name>/lidar_<mode>/. Returns what was built and written."""
    cfg = build_config(args)
    device = _device(args.device)
    cfg, scene = _static_scene(cfg, "lidar", "render_lidar")
    out = exp_dir(cfg)
    sweeps, l2g = _sweeps(args, scene, out)
    model = build_model(cfg, args.params, args.allow_fresh, device)
    renderer = ChunkRenderer(model, cfg, cfg.render_chunk_size)
    sweep_dir = os.path.join(out, f"lidar_{args.mode}")
    data = scene.data
    paths = render_sweeps_to_dir(renderer, sweeps, data.near, data.far,
                                 scene.frame, sweep_dir)
    np.save(os.path.join(sweep_dir, "lidar2globals.npy"), l2g)
    print(f"wrote {len(paths)} sweeps to {sweep_dir}")
    return types.SimpleNamespace(
        cfg=cfg, model=model, renderer=renderer, sweeps=sweeps,
        near=data.near, far=data.far, frame=scene.frame,
        sweep_dir=sweep_dir, paths=paths)


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
    sp.add_argument("--num_sweeps", type=int, default=10)
    sp.add_argument("--azimuth_steps", type=int, default=1100,
                    help="azimuth samples per beam (32 beams x this = "
                         "rays/sweep)")
    sp.add_argument("--complicated", action="store_true")
    sp.add_argument("--start", type=float, nargs=3)
    sp.add_argument("--end", type=float, nargs=3)
    sp.set_defaults(fn=cmd_render_lidar)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
