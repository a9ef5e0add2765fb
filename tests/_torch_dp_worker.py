"""Ranks of the port's data-parallel tests, in processes of their own.

    python tests/_torch_dp_worker.py JOB RANK WORLD PORT

Each rank joins a gloo group on localhost:PORT, runs the jobs listed in
the pickled JOB file (functions of this module, each called with the
rank's `DataMesh` and its keyword arguments) and writes their results to
JOB.rank<RANK>, with the JAX-side modules it found loaded. This module
imports no JAX (the tests' conftest gives JAX 8 virtual devices in the
test process), and `launch` bounds every run by its own time limit.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BARRED = ("jax", "jaxlib", "flax", "optax", "msgpack", "nerf_lidar_tpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(jobs: List[dict], world: int, workdir: str, timeout: float,
           env: Optional[List[Dict[str, str]]] = None,
           cwd: Optional[List[str]] = None) -> List[dict]:
    """Run `jobs` ({"fn": name, **kwargs}) on `world` ranks; returns each
    rank's {"results": [...], "modules": [...]}. env / cwd: per rank. Kills
    every rank and raises when one fails or the time limit passes."""
    path = os.path.join(workdir, "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(jobs, f)
    port = _free_port()
    procs = []
    for r in range(world):
        e = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
        e.pop("XLA_FLAGS", None)
        e.update((env or [{}] * world)[r])
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path, str(r),
             str(world), str(port)], env=e,
            cwd=(cwd or [workdir] * world)[r], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise RuntimeError(f"ranks did not finish in {timeout} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{log}")
    out = []
    for r in range(world):
        with open(f"{path}.rank{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------------ jobs

def steps(mesh, cfg_json, state, batches, num_patch_rays, seed=None,
          tracks=None, track_mask=None):
    """train_step on this rank's rows of each global batch, from `state`
    (a state dict of numpy arrays); with `seed`, the randomness of a
    generator seeded so; with `tracks` / `track_mask`, the dynamic
    objects. Returns the stats of each step, the final state dict and the
    last step's gradients."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import configs
    from nerf_lidar_tpu_torch.models.model import Model
    from nerf_lidar_tpu_torch.train import train_step

    cfg = configs.Config.from_dict(json.loads(cfg_json))
    model = Model(cfg.model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    opt = train_step.make_optimizer(model, cfg)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    objects = {} if tracks is None else dict(
        tracks=torch.from_numpy(tracks),
        track_mask=torch.from_numpy(track_mask))
    stats = []
    for step, batch in enumerate(batches):
        rows = mesh.rows(len(batch["rgb"]))
        local = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                 for k, v in batch.items()}
        s = train_step.train_step(model, opt, cfg, local, step,
                                  num_patch_rays, gen, mesh=mesh, **objects)
        stats.append({k: v.numpy() for k, v in s.items()})
    return dict(stats=stats,
                state={k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()},
                grads={k: p.grad.numpy().copy()
                       for k, p in model.named_parameters()})


def render(mesh, cfg_json, state, rays, chunk):
    """ChunkRenderer(mesh=) of `rays` at `chunk`."""
    import torch
    from nerf_lidar_tpu_torch import configs
    from nerf_lidar_tpu_torch.models.model import Model
    from nerf_lidar_tpu_torch.renderer import ChunkRenderer

    cfg = configs.Config.from_dict(json.loads(cfg_json))
    model = Model(cfg.model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return ChunkRenderer(model.eval(), cfg, chunk, mesh=mesh).render(rays)


def cli_runs(mesh, argvs, record_batches=0, env=None, cwd=None):
    """cli.main of each argv in this rank's working directory (`cwd[rank]`
    when given) with this rank's `env[rank]` set; the first
    `record_batches` batches that train_step is handed, the runs' seeds,
    states (and eval's steps and metrics), and the files under exp/
    afterwards."""
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.train import train_step

    if env is not None:
        os.environ.update(env[mesh.rank])
    if cwd is not None:
        os.chdir(cwd[mesh.rank])

    seen = []
    step_fn = train_step.train_step

    def recording(model, optimizer, config, batch, *args, **kwargs):
        if len(seen) < record_batches:
            seen.append({k: v.numpy().copy() for k, v in batch.items()})
        return step_fn(model, optimizer, config, batch, *args, **kwargs)

    train_step.train_step = recording
    runs = []
    try:
        for argv in argvs:
            run = cli.main(argv)
            runs.append(dict(seed=run.cfg.seed, state={
                k: v.detach().numpy().copy()
                for k, v in run.model.state_dict().items()},
                steps=getattr(run, "steps", None),
                metrics=getattr(run, "metrics", None)))
    finally:
        train_step.train_step = step_fn
    files = sorted(os.path.join(root, n) for root, _, names in
                   os.walk("exp") for n in names)
    return dict(runs=runs, batches=seen, files=files)


def main(argv):
    path, rank, world, port = argv[1], int(argv[2]), int(argv[3]), argv[4]
    import torch.distributed as dist
    from nerf_lidar_tpu_torch import parallel

    with open(path, "rb") as f:
        jobs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        results = []
        for job in jobs:
            job = dict(job)
            fn = globals()[job.pop("fn")]
            shape = job.pop("mesh_shape", (-1,))
            axes = job.pop("mesh_axes", ("data",))
            results.append(fn(parallel.maybe_data_mesh(shape, axes), **job))
        modules = sorted(m for m in sys.modules
                         if m.split(".")[0] in BARRED)
        with open(f"{path}.rank{rank}", "wb") as f:
            pickle.dump(dict(results=results, modules=modules), f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
