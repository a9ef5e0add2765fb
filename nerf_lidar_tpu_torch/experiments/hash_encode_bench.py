"""Kernel H1 (`hash_encode_ms`) and its backward on the points the main
paths give them, on one GPU.

    python nerf_lidar_tpu_torch/experiments/hash_encode_bench.py \
        [--root DIR] [--copies] [--profile] [--steps N]

Runs the port's `train` entry on `nuscenes_single` (synthetic scene, full
width) for `--steps` steps, records the (x01, stds, g_out) that one more
warm step hands `grid.hash_encode_multisample_bwd` for each grid, renders
one sweep through `render_lidar` from the weights it wrote, and records the
(x01, stds) of the sweep's first chunk per grid. Then, per grid: H1-bwd on
the train inputs and H1 on the render inputs, each also on uniform points
of the same shape, and H1 on the train inputs (the step's forward encodes
the same points), timed with CUDA events after a warm-up and held against
its plain version. One JSON line per measurement, after nvidia-smi's name
and power limit of the card.

--root DIR: import `nerf_lidar_tpu_torch` from the checkout at DIR (for
  example an earlier commit unpacked with `git archive`) to time its
  kernels the same way; they build into DIR. Run this file by its path, not
  with -m, for that.
--copies: also time each kernel on COPIES fresh copies of its inputs,
  which land at other device addresses; where the checkout's kernels take a
  block order (`grid.level_major`), both orders in turns on each copy
  (picked, other, other, picked).
--profile: torch.profiler over 2 warm train steps: wall and device busy
  time, idle share, and device time by kernel kind.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# Relative to the largest value, as chip_smoke.py holds them.
BWD_TOL = 1e-4
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
# Published peaks of one H100 SXM at 700 W: 3.35 TB/s, 67 TFLOP/s float32
# outside the tensor cores (per millisecond).
HBM_BYTES_PER_MS = 3.35e9
FP32_FLOP_PER_MS = 67e9
GRIDS = ("nerf", "prop0", "prop1")


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device milliseconds per call of fn, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, flops):
    return max(n_bytes / HBM_BYTES_PER_MS, flops / FP32_FLOP_PER_MS)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def points_in_range(x01):
    return int((~((x01 < 0) | (x01 > 1)).any(-1)).sum())


def rows_read(spec, x01):
    """Distinct table rows the encode of x01 reads."""
    from nerf_lidar_tpu_torch.ops import grid
    x = x01.reshape(-1, 3)
    x = x[~((x < 0) | (x > 1)).any(-1)]
    read = torch.zeros(spec.total_rows, dtype=torch.bool, device=x.device)
    for l in range(spec.num_levels):
        ig = torch.floor(x * spec.scales[l] + 0.5).long()
        for c in range(8):
            read[spec.offsets[l] + grid._corner_index(
                spec, l, ig[:, 0] + (c & 1), ig[:, 1] + (c >> 1 & 1),
                ig[:, 2] + (c >> 2 & 1))] = True
    return int(read.sum())


def fwd_bound(spec, x01, stds):
    """Bytes and operations of the encode: the points, the features and the
    distinct rows read; a multiply-add per corner channel."""
    out = stds.numel() // stds.shape[-1] * spec.output_dim * 4
    n_bytes = (nbytes(x01, stds) + out
               + rows_read(spec, x01) * spec.level_dim * 4)
    flops = 2 * points_in_range(x01) * spec.num_levels * 8 * spec.level_dim
    return n_bytes, flops


def bwd_bound(spec, x01, stds, g_out):
    """Bytes and operations of the backward: the points and g_out read, the
    whole d_table written; a multiply and an add per corner channel."""
    n_bytes = (nbytes(x01, stds, g_out)
               + spec.total_rows * spec.level_dim * 4)
    flops = 2 * points_in_range(x01) * spec.num_levels * 8 * spec.level_dim
    return n_bytes, flops


def grid_names(model):
    """[(grid name, MLP)] of a model's hash grids: "nerf", "prop<i>", and
    with dynamic objects "obj" (shared) or "obj_cls<k>" (per class)."""
    mlps = [("nerf", model.nerf_mlp)] + [
        (f"prop{i}", p) for i, p in enumerate(model.prop_mlps)]
    if model.has_objects and model.cfg.obj_class_ids:
        mlps += [(f"obj_cls{k}", getattr(model, f"obj_mlp_cls{k}"))
                 for k in sorted(set(model.cfg.obj_class_ids))]
    elif model.has_objects:
        mlps.append(("obj", model.obj_mlp))
    return mlps


def grid_tables(model):
    """{table data_ptr: grid name} of a model's hash tables."""
    return {mlp.table.data_ptr(): name for name, mlp in grid_names(model)}


@contextlib.contextmanager
def recording(module, name, model):
    """Within the block, module.<name> records the first call per hash table
    of `model`: {grid name: (cloned tensor args, other args)}. The wrapper
    carries the function's launch count, and gives it back."""
    orig = getattr(module, name)
    names = grid_tables(model)
    calls = {}

    def wrapper(*args):
        grid_name = names.get(args[0].data_ptr())
        if grid_name is not None and grid_name not in calls:
            calls[grid_name] = tuple(
                a.detach().clone() if isinstance(a, torch.Tensor) else a
                for a in args)
        return orig(*args)

    wrapper.launches = orig.launches
    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        orig.launches = wrapper.launches
        setattr(module, name, orig)


def record_train_inputs(run, step):
    """(table, x01, stds, g_out, spec, needs) per grid, from one train step
    of the train entry's `run` (its model, optimizer, batcher, generator)."""
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.ops import grid
    from nerf_lidar_tpu_torch.train import train_step
    dev = next(run.model.parameters()).device
    batch = cli.to_device(run.batcher.next(), dev)
    with recording(grid, "hash_encode_multisample_bwd", run.model) as calls:
        stats = train_step.train_step(
            run.model, run.optimizer, run.cfg, batch, step,
            run.batcher.num_patch_rays, run.generator, posenet=run.posenet,
            tracknet=run.tracknet, tracks=run.tracks,
            track_mask=run.track_mask)
        float(stats["loss"])
    return calls


def record_render_inputs(renderer, sweep, near, far, frame):
    """(table, x01, stds, spec) per grid, from the first chunk of a sweep."""
    from nerf_lidar_tpu_torch.lidar.render import render_sweep
    from nerf_lidar_tpu_torch.ops import grid
    with recording(grid, "hash_encode_multisample", renderer.model) as calls:
        render_sweep(renderer, sweep, near, far, frame)
        torch.cuda.synchronize()
    return calls


def uniform_like(x01, stds, seed):
    """Points uniform in [-0.05, 1.05]^3 (each multisample independent) and
    stds in [1e-5, 1e-2), of x01's and stds' shapes."""
    g = torch.Generator(device=x01.device).manual_seed(seed)
    return (torch.rand(x01.shape, device=x01.device, generator=g) * 1.1
            - 0.05,
            torch.rand(stds.shape, device=x01.device, generator=g) * 0.01
            + 1e-5)


def max_rel_err(got, want):
    scale = float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or scale == 0:
        return float("inf")
    return float((got - want).abs().max()) / scale


def check_fwd(name, got, want):
    """Raises unless |got - want| <= FWD_ATOL + FWD_RTOL |want|."""
    err = (got - want).abs()
    if bool((err > FWD_ATOL + FWD_RTOL * want.abs()).any()) \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: max abs err {float(err.max())}")
    return float(err.max())


def check_bwd(got, plain, needs):
    """The largest error of the wanted gradients relative to the plain
    twin's largest value; raises above BWD_TOL."""
    err = max(max_rel_err(got[i], plain[i]) for i in range(3) if needs[i])
    if not err <= BWD_TOL:
        raise AssertionError(f"hash_encode_ms_bwd: error {err} of max")
    return err


def measure_bwd(spec, table, x01, stds, g_out, needs, fn):
    """fn's ms on these inputs, its error against the plain twin, and the
    twin's result."""
    from nerf_lidar_tpu_torch.ops import grid
    plain = grid.hash_encode_multisample_bwd_plain(table, x01, stds, g_out,
                                                   spec, needs)
    err = check_bwd(fn(), plain, needs)
    return cuda_ms(fn), err, plain


def measure_fwd(root, name, inputs, table, x01, stds, spec, copies):
    """Emits H1's ms on these inputs, its error against the plain encode
    and its bound; with `copies`, its times on fresh copies (`on_copies`)."""
    from nerf_lidar_tpu_torch.ops import grid
    n_ms = x01.shape[-2]
    want = grid.hash_encode_multisample_plain(table, x01, stds, spec)[0]
    fn = lambda *t: grid.hash_encode_multisample(*t, spec)
    check = lambda got: check_fwd(f"hash_encode_ms {name} {inputs}", got,
                                  want)
    err = check(fn(table, x01, stds))
    n_bytes, flops = fwd_bound(spec, x01, stds)
    emit(root=root, kernel="hash_encode_ms", grid=name, inputs=inputs,
         B=stds.numel() // n_ms, n=n_ms,
         ms=cuda_ms(lambda: fn(table, x01, stds)), max_abs_err=err,
         bound_ms=bound_ms(n_bytes, flops), bytes=n_bytes, flops=flops)
    if copies:
        emit(root=root, kernel="hash_encode_ms", grid=name, inputs=inputs,
             copies_ms=on_copies(fn, (table, x01, stds), check))


COPIES = 3


@contextlib.contextmanager
def other_order(grid):
    """Within the block, H1 and its backward run in the block order that
    `grid.level_major` does not pick."""
    picked = grid.level_major
    grid.level_major = lambda spec, l2_bytes: not picked(spec, l2_bytes)
    try:
        yield
    finally:
        grid.level_major = picked


def on_copies(fn, tensors, check):
    """{"picked": [ms, ...], "other": [ms, ...]}: fn(*copies) on each of
    COPIES fresh copies of `tensors`, in both block orders in turns
    (picked, other, other, picked), or twice in the one order of kernels
    that take none; check(result) raises on a wrong result."""
    from nerf_lidar_tpu_torch.ops import grid
    turns = (("picked", "other", "other", "picked")
             if hasattr(grid, "level_major") else ("picked", "picked"))
    times = {order: [] for order in turns}
    for _ in range(COPIES):
        copies = [t.clone() for t in tensors]
        for order in turns:
            with (other_order(grid) if order == "other"
                  else contextlib.nullcontext()):
                check(fn(*copies))
                times[order].append(cuda_ms(lambda: fn(*copies)))
        del copies
    return times


def emit(**rec):
    print(json.dumps(rec), flush=True)


def profile_train(run, step, steps=2):
    """torch.profiler over `steps` warm train steps of the train entry's
    `run` (its refiners and tracks too): wall ms/step, device busy ms/step
    (union of device intervals), idle share, device ms/step by kernel kind,
    the ten kernels that take the most, and the host's waits for the
    device per step (stream / device synchronisations and blocking
    copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.train import train_step
    dev = next(run.model.parameters()).device
    batches = [cli.to_device(run.batcher.next(), dev) for _ in range(steps)]

    def one(i):
        stats = train_step.train_step(
            run.model, run.optimizer, run.cfg, batches[i], step + i,
            run.batcher.num_patch_rays, run.generator, posenet=run.posenet,
            tracknet=run.tracknet, tracks=run.tracks,
            track_mask=run.track_mask)
        float(stats["loss"])

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            one(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kinds = [("hash_encode_ms_bwd", r"hash_encode_ms_bwd"),
             ("hash_encode_ms", r"hash_encode_ms"),
             ("scatter_add_rows", r"scatter_add_rows"),
             ("gemm", r"gemm|cutlass|sm90_xmma|matmul|dot_kernel"),
             ("sort", r"sort|radix"),
             ("optimizer", r"adam|multi_tensor|foreach"),
             ("reduce", r"reduce|norm_kernel"),
             ("elementwise_gather_where", r"elementwise|index|gather|where"
                                          r"|scatter|copy|cat|fill"),
             ("memcpy_memset", r"^Memcpy|^Memset|^memcpy|^memset")]
    by_kind, by_name, spans, waits = {}, {}, [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            if re.fullmatch(r"cuda(Stream|Device)Synchronize|cudaMemcpy",
                            e.name):
                waits[e.name] = waits.get(e.name, 0) + 1 / steps
            continue
        us = e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
        kind = next((k for k, pat in kinds
                     if re.search(pat, e.name, re.IGNORECASE)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3 / steps
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + us / 1e3 / steps
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    busy = busy / 1e3 / steps
    return dict(wall_ms_per_step=wall, device_busy_ms_per_step=busy,
                idle_share=1 - busy / wall, kernel_ms_per_step=dict(
                    sorted(by_kind.items(), key=lambda kv: -kv[1])),
                kernel_ms_sum=sum(by_kind.values()),
                top_kernels_ms_per_step=dict(sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:10]),
                host_waits_per_step=waits)


def main(argv=None):
    p = argparse.ArgumentParser("hash_encode_bench")
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--copies", action="store_true")
    p.add_argument("--profile", action="store_true")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import nerf_lidar_tpu_torch
    if not os.path.abspath(nerf_lidar_tpu_torch.__file__).startswith(
            os.path.join(root, "")):
        raise SystemExit(f"nerf_lidar_tpu_torch was imported from "
                         f"{nerf_lidar_tpu_torch.__file__}, not {root}: run "
                         "this file by its path")
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.ops import grid
    if not torch.cuda.is_available():
        raise SystemExit("hash_encode_bench needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    tag = f"hash_encode_bench_{os.getpid()}"
    base = ["--config", "nuscenes_single", "--set",
            "dataset_loader=synthetic", "--device", "cuda", "--exp_name",
            tag]
    train_argv = ["train", *base, "--steps", str(args.steps)]
    out_dir = cli.exp_dir(cli.build_config(cli.parse_args(train_argv)))
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        run = cli.main(train_argv)
        train = record_train_inputs(run, args.steps)
        profile = (profile_train(run, args.steps + 1) if args.profile
                   else None)
        render_run = cli.main(["render_lidar", *base, "--mode", "simu",
                               "--num_sweeps", "1", "--params", run.params])
        render = record_render_inputs(
            render_run.renderer, render_run.sweeps[0], render_run.near,
            render_run.far, render_run.frame)
        del run, render_run
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    if profile is not None:
        emit(root=root, what="train_step_profile", **profile)

    for name in GRIDS:
        table, x01, stds, g_out, spec, needs = train[name]
        n_ms = x01.shape[-2]
        for inputs, (x, s) in (("train", (x01, stds)),
                               ("uniform", uniform_like(x01, stds, 6))):
            fn = lambda: grid.hash_encode_multisample_bwd(
                table, x, s, g_out, spec, needs)
            ms, err, plain = measure_bwd(spec, table, x, s, g_out, needs, fn)
            n_bytes, flops = bwd_bound(spec, x, s, g_out)
            emit(root=root, kernel="hash_encode_ms_bwd", grid=name,
                 inputs=inputs, B=s.numel() // n_ms, n=n_ms,
                 needs=list(needs),
                 ms=ms, max_rel_err=err, bound_ms=bound_ms(n_bytes, flops),
                 bytes=n_bytes, flops=flops)
            if args.copies:
                emit(root=root, kernel="hash_encode_ms_bwd", grid=name,
                     inputs=inputs, copies_ms=on_copies(
                         lambda *t: grid.hash_encode_multisample_bwd(
                             *t, spec, needs), (table, x, s, g_out),
                         lambda got: check_bwd(got, plain, needs)))
            del plain
        # The train step's forward encodes the same points.
        measure_fwd(root, name, "train", table, x01, stds, spec, args.copies)
        del train[name]
        torch.cuda.empty_cache()

    for name in GRIDS:
        table, x01, stds, spec = render[name]
        for inputs, (x, s) in (("render", (x01, stds)),
                               ("uniform", uniform_like(x01, stds, 1))):
            measure_fwd(root, name, inputs, table, x, s, spec, args.copies)
        del render[name]
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
