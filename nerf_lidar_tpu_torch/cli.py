"""Command-line entry of the port (counterpart of `nerf_lidar_tpu/cli.py`).

  python -m nerf_lidar_tpu_torch.cli render_lidar --config nuscenes_single \
      --exp_name myscene --mode simu --num_sweeps 10 --params weights.npz

Config, overrides and scene loading are the JAX package's own jax-free
helpers (`build_config`, `apply_overrides`, `load_scene_for`, `exp_dir`), so
a preset and a `--set` mean the same thing in both packages. Weights come
from `--params` (a Flax param tree as a flat .npz, see `convert.py`) or, for
debugging, a seeded fresh init (`--allow_fresh`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import types
from typing import List, Optional

import numpy as np
import torch

from nerf_lidar_tpu.cli import build_config, exp_dir, load_scene_for
from nerf_lidar_tpu.lidar import sensor

from . import convert
from .lidar.render import render_sweeps_to_dir
from .models.model import Model
from .renderer import ChunkRenderer

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


def cmd_render_lidar(args) -> types.SimpleNamespace:
    """Render LiDAR sweeps of a static scene and write the
    points / points_semantic / points_rgb trio plus lidar2globals.npy under
    exp/<name>/lidar_<mode>/. Returns what was built and written."""
    cfg = build_config(args)
    device = _device(args.device)
    scene = load_scene_for(cfg, "lidar")
    if getattr(scene, "tracks", None) is not None and cfg.model.instance_obj:
        raise SystemExit(
            "this scene has dynamic-object tracks, and dynamic objects are "
            "not ported yet: render it with nerf_lidar_tpu.cli render_lidar")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, instance_obj=False, num_objects=0, obj_sem_ids=()))
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

    sp = sub.add_parser("render_lidar")
    sp.add_argument("--config", default="nuscenes_single", choices=CONFIGS)
    sp.add_argument("--config_json", default=None,
                    help="load a config.json snapshot instead of a named "
                         "base config")
    sp.add_argument("--data_dir", default=None)
    sp.add_argument("--exp_name", default=None)
    sp.add_argument("--set", action="append", default=[],
                    help="dotted config override key=value")
    sp.add_argument("--params", default=None,
                    help="Flax param tree as a flat '/'-keyed .npz")
    sp.add_argument("--allow_fresh", action="store_true",
                    help="render from a seeded fresh init when no --params "
                         "is given (debugging only)")
    sp.add_argument("--device", default="cuda",
                    help="torch device; cuda with no GPU is an error")
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
