#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`nerf_lidar_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases (each raises on failure, so the script exits non-zero):
1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
2. build: compiles csrc/*.cu with nvcc (sm_90a) and loads the library;
3. K1 `composite` vs its plain torch version at the slice's chunk
   (R = 16,384, S = 32, K = 19; opaque on/off; ragged R = 700; the sweep's
   last chunk, R = 2,432) on seeded uniform densities and on trained-like
   ones (log-normal up to 1e4, rays opaque at their first sample, rays of
   zero density); device times from torch.profiler;
4. H1 `hash_encode_ms` vs its plain torch version on the `nuscenes_single`
   NeRF (10 x C4, 14,995,560 rows) and proposal (C1) grids, each at the
   batch the main path gives it (16,384-ray chunk x 32 NeRF or 64 proposal
   samples), n = 7 multisamples: on uniform points with out-of-range ones,
   and on the (x01, stds) of the first render chunk of [5]; times and the
   bound per grid on both;
5. the slice: the port's `render_lidar` entry, in-process, renders two
   full 35,200-ray sweeps of `nuscenes_single` at full width (seeded fresh
   weights) with the kernels on; checks the files and values and counts the
   kernel launches of that run; records the encode's inputs of one more
   sweep's first chunk; times one sweep kernels on and off
   (`use_kernels=False`); then gives every hash table seeded uniform(-1, 1)
   values, so that the encode moves density, colour and the resampling,
   and compares the kernels-on render with the kernels-off one;
6. the H1 backward `hash_encode_ms_bwd` at the train step's shapes (20,480
   rays x 32 NeRF or 64 proposal samples, n = 7) vs its written-out plain
   twin (`index_add_`) on every grid, on uniform points and on the
   (x01, stds, g_out) one warm step of [8] gave it: d_table, and d_x01 /
   d_stds on the smallest proposal grid's uniform points, where it is also
   held against plain autograd through the plain encode; times and the
   bound per grid;
7. K3 `scatter_add_rows` vs `index_add_` at the shapes the train path gives
   it (the hash-decay level sums of the three grids: every row of a level
   onto one output row; against float64) and at K3's own shapes (rows 4,096
   and 2^17, N 2^20 and 2^22, C 16); kernel, plain and `index_add_` device
   times (torch.profiler) beside the bound at every shape;
8. the port's `train` entry, in-process, in a fresh experiment directory,
   fits `nuscenes_single` on the synthetic scene at full width for 30 steps
   with the kernels on: finite losses, a non-zero gradient on every hash
   table, the launch counts of H1, its backward and K3, warm ms/step,
   rays/s and peak memory; records the encode backward's inputs of one more
   step (for [6]); then 3 steps kernels on vs off from the same
   weights, batches and randomness (the loss of each; the first step's
   MLP gradients to 1e-3 of their largest value, each hash table's to
   float32 eps times the magnitudes of its summed terms beyond what the two
   sides' encode inputs carry, `table_grad_excess`; the hash-decay term);
   then 100 steps at the full learning rate (no warm-up), where the data
   loss must fall;
9. train -> render: `render_lidar --params` renders one full sweep from the
   params_100.npz that [8]'s learning check wrote, through K1 and H1; then
   that sweep kernels on, every K1 and H1 call held against its plain
   version on its own inputs, vs kernels off (`use_kernels=False`) at
   [5]'s tolerances on all but TRAINED_SWEEP_SHARE of the values, and K1
   on with H1 off vs off at [5]'s tolerances on every value; then K1 vs
   plain, and its device time, on the recorded inputs of the sweep's first
   chunk;
10. the in-tile gathers (`ops/tile_gather.py`, `csrc/gather.cu`) at the TPU
   kernels' own shapes: K2 `tile_lane_gather` [8, 128], K4's other four
   forms (`take_along_axis` on (256, 128), (128, 128) axis 0 and (8, 2^15);
   `take_rows` (512, 128) <- 256) and K5 (`tile_grid_gather`, tbl [8, 128],
   idx [1024, 8, 128]), and `take_rows` at the gather bench's row gather
   (2^19, 16) <- 2^20, each exactly equal to its plain version, NaN
   positions included, on in-range indices and on negative and
   out-of-range ones; kernel, plain and library-call (`take_along_dim` /
   `index_select`) device times from torch.profiler, kernel and library
   call in turns (kernel, library, library, kernel; 50 calls each); and
   the device time of an empty kernel, the card's launch floor;
11. the port's gather-bench entry (`experiments/gather_bench.py`),
   in-process, at the JAX bench's sizes: every probe line prints, the K4
   forms pass, and the launch counts of that run; then the device time of
   one call of its row gather (both layouts) and row scatter-add at the
   hash grid's 2^19 x 16, without the bench's host loop;
12. dynamic objects: writes a synth_nusc scene (one moving "vehicle.car"
   and its track) with the port's copy of the writer, runs the port's
   `train` entry on it, in-process, with `nuscenes_single` at full width
   and the tracknet live from the first step (`track_start_opt=0`) for
   OBJ_STEPS steps: finite losses, obj_hit_frac > 0, obj_overflow 0, a
   non-zero gradient on every hash table, obj_latents and the tracknet's
   opt_t, the launch counts (and those on the object grid), warm ms/step
   and peak memory beside [8]'s; then 2 steps kernels on vs off under
   [8]'s rules (the object table, obj_latents and the tracknet included;
   without obj_nodecay, so that K3 sums the object table there too); then
   `render_lidar --mode replay` from the params it wrote, with the car
   (`--obj_mode replay`) and without it (`removal`), every K1 and H1 call
   held against its plain version: the files, a ray with a sample in a
   box, and the rays with no sample in a box at any level equal between
   the two renders at [5]'s tolerances; warm s/sweep of both; then H1 and
   H1-bwd (d_table, d_x01; also vs plain autograd) on the object grid at a
   train step's recorded call (n = 1, stds 0), in both block orders in
   turns, and K3 at the object table's hash-decay level sums, with device
   times and bounds; and a torch.profiler breakdown of 2 warm train steps
   with objects (`hash_encode_bench.profile_train`); these profiled parts
   run after [13];
13. ray-drop: writes a synth_nusc scene with dense LiDAR (RD_SWEEPS frames,
   1,100 returns per beam), trains a field on it for RD_FIELD_STEPS steps
   and renders RD_SWEEPS replay sweeps (the earlier entries), then, with
   every kernel count at 0, drives the ray-drop path through the port's
   CLI on the card: `raydrop_features` ([N, 32, 1024, 6] features),
   `raydrop_train` (the U-Net at 64-1024 with the VGG19 loss, 32 x 1024,
   batch 4, RD_EPOCHS epochs: one eval; the training CE must fall), a
   short `raydrop_train --darknet` (Darknet-53), `raydrop_drop --place_car
   --features` (velodyne/*.bin and labels/*.label read back against
   drop_sweep, ground returns below the sensor, the sensor metadata) and
   `raydrop_val_vis`; no kernel of the table launches there. Then the card
   against the CPU from the trained weights: eval logits, the keep mask,
   one train step in float64 (at RD_LOSS_TOL / RD_GRAD_TOL / RD_BN_TOL) and
   in float32 (its loss; its gradients reported); and the times of a train
   step (VGG; VGG + Darknet), a predict, and features / drop per sweep.
The phases run in the order 1, 2, 3, 5, 4, 8, 12, 13, 6, 7, 9, 10, 11: [4]
and [6] time the encode on the inputs that [5] and [8] record, and what
times with torch.profiler ([3]'s timing, [7], [9], [10], [11], [12]'s
kernel times and profile) runs after the timed entries, [3]'s timing after
[7]. Then it fails if any
module of jax, jaxlib, flax, optax or the JAX package
(`nerf_lidar_tpu`, `nerf_lidar_tpu.*`) was imported. Prints the kernels'
JSON line (every kernel's launches on each path, the object paths
`train_objects` and `render_lidar_objects` and the ray-drop path `raydrop`
(none) included, times, and its bound:
the larger of its bytes over the card's memory rate and its operations
over its float32 rate; H1 and its backward per grid too, and H1, H1-bwd
and K3 on the object grid under "obj_grid"), the nvidia-smi line,
then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "nerf_lidar_tpu_torch/csrc/kernels.cu"
GATHER_SOURCE = "nerf_lidar_tpu_torch/csrc/gather.cu"
# Published peaks of one H100 SXM at 700 W: device memory 3.35 TB/s, float32
# outside the tensor cores 67 TFLOP/s (per millisecond below).
HBM_BYTES_PER_MS = 3.35e9
FP32_FLOP_PER_MS = 67e9
MODULES_BARRED = ("jax", "jaxlib", "flax", "optax", "nerf_lidar_tpu")
# The main paths: the port's `render_lidar` and `train` entries, as a user
# would call them.
SLICE_ARGV = ["render_lidar", "--config", "nuscenes_single",
              "--set", "dataset_loader=synthetic", "--mode", "simu",
              "--num_sweeps", "2", "--allow_fresh", "--device", "cuda",
              "--exp_name", "chip_smoke"]
TRAIN_STEPS = 30
TRAIN_ARGV = ["train", "--config", "nuscenes_single",
              "--set", "dataset_loader=synthetic", "--set", "print_every=1",
              "--steps", str(TRAIN_STEPS), "--device", "cuda",
              "--exp_name", "chip_smoke_train"]
LEARN_ARGV = ["train", "--config", "nuscenes_single",
              "--set", "dataset_loader=synthetic", "--set", "print_every=1",
              "--set", "lr_delay_steps=0", "--steps", "100",
              "--device", "cuda", "--exp_name", "chip_smoke_learn"]
# [12]: the recipe on a synth_nusc scene with one moving car, whose track
# the tracknet refines from the first step.
OBJ_EXP = "chip_smoke_objects"
OBJ_SCENE = os.path.join("exp", OBJ_EXP, "scene")
OBJ_STEPS = 20
OBJ_TRAIN_ARGV = ["train", "--config", "nuscenes_single",
                  "--set", "dataset_loader=nusc", "--data_dir", OBJ_SCENE,
                  "--set", "track_start_opt=0", "--set", "print_every=1",
                  "--steps", str(OBJ_STEPS), "--device", "cuda",
                  "--exp_name", OBJ_EXP]
OBJ_RENDER_ARGV = ["render_lidar", "--config", "nuscenes_single",
                   "--set", "dataset_loader=nusc", "--data_dir", OBJ_SCENE,
                   "--mode", "replay", "--num_sweeps", "1", "--device",
                   "cuda", "--exp_name", OBJ_EXP]
# [13]: the ray-drop stage on a synth_nusc scene with dense LiDAR (1,100
# returns per beam, as real sweeps are: the 256-point default leaves the
# ground-truth range image 75% empty), a field trained on it briefly.
RD_EXP = "chip_smoke_raydrop"
RD_SCENE = os.path.join("exp", RD_EXP, "scene")
RD_SWEEPS = 8
RD_FIELD_STEPS = 60
RD_EPOCHS = 10
RD_FIELD_ARGV = ["--config", "nuscenes_single", "--set", "dataset_loader=nusc",
                 "--data_dir", RD_SCENE, "--set", "track_start_opt=0",
                 "--set", "lr_delay_steps=0", "--device", "cuda",
                 "--exp_name", RD_EXP]
RD_RENDER_ARGS = ["--mode", "replay", "--num_sweeps", str(RD_SWEEPS)]
RD_DEVICE = ["--device", "cuda"]
# Card against CPU from one set of weights (TF32 off): the U-Net's eval
# logits to 1e-4 of their max; one train step's loss rtol 1e-4, gradients
# 1e-3 of each tensor's max, BatchNorm buffers rtol 1e-5; the keep mask
# equal wherever the CPU's probability is farther than 1e-4 from 0.5.
RD_LOGIT_TOL = 1e-4
RD_LOSS_TOL = 1e-4
RD_GRAD_TOL = 1e-3
RD_BN_TOL = 1e-5
RD_KEEP_MARGIN = 1e-4
# What [5] and [8] measured, printed beside [12]'s.
STATIC = {}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def close(name, got, want, rtol, atol):
    """Max |got - want|; raises unless |got - want| <= atol + rtol |want|."""
    import torch
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        fail(f"{name}: {int(bad.sum())} of {got.numel()} values outside "
             f"rtol {rtol} / atol {atol} (max abs err {float(err.max())})")
    return float(err.max())


def rel_err(name, got, want, tol):
    """max |got - want| / max |want|; raises above tol. Returns (max abs
    err, relative err)."""
    import torch
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or scale == 0 \
            or err > tol * scale:
        fail(f"{name}: max abs err {err} against max |want| {scale} "
             f"(tolerance {tol} of it)")
    return err, err / scale


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds per call of fn, timed with CUDA events."""
    import torch
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


def cuda_ms_once(fn):
    """(device milliseconds of one call of fn, its result)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def device_ms(fn, iters=50):
    """Device milliseconds per call of fn: the summed time of the device
    activities (kernels, copies, fills) of `iters` calls under
    torch.profiler, so host launch gaps between short kernels do not
    count. This card's tracer now and then drops activities from a session
    (late in a long process, the first launch of every session, or most of
    them), so a session counts only if each activity name appears a whole
    multiple of `iters` times; up to five are taken, and if none is whole,
    the last one counts each name's mean duration times its launches per
    call, rounded. If that is zero too, CUDA events time fn, with a note."""
    import statistics
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                spans.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if spans and all(len(v) % iters == 0 for v in spans.values()):
            return sum(map(sum, spans.values())) / 1e3 / iters
    us = sum(statistics.fmean(v) * round(len(v) / iters)
             for v in spans.values())
    if us > 0:
        return us / 1e3
    print("    (torch.profiler recorded no whole launch in five sessions: "
          "CUDA events instead)")
    return cuda_ms(fn, iters)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, flops):
    """The least time the card could take: {"bound_ms", "bound_by"}, the
    larger of bytes over the memory rate and float32 operations over the
    float32 rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_MS, flops / FP32_FLOP_PER_MS
    if by_bytes >= by_ops:
        return dict(bound_ms=by_bytes, bound_by="bytes")
    return dict(bound_ms=by_ops, bound_by="operations")


# K1 against its plain version, per output: (rtol, atol).
COMPOSITE_TOL = dict(weights=(1e-5, 1e-6), depth=(1e-4, 1e-5),
                     acc=(1e-5, 1e-6), rgb=(1e-5, 1e-5),
                     semantic=(1e-5, 1e-5), intensity=(1e-5, 1e-5))


def composite_inputs(dev, r, s, k, g, trained=False, opaque=True,
                     with_int=False):
    """Seeded K1 inputs: densities uniform in [0, 3), or (`trained`) what a
    trained field gives K1: log-normal densities up to 1e4, every 8th ray
    opaque at its first sample (1e4 there) and every 16th ray of zero
    density, so that T underflows to 0 and the last sample takes it all."""
    import torch
    rand = lambda *shape: torch.rand(*shape, device=dev, generator=g)
    density = rand(r, s) * 3
    if trained:
        density = torch.exp(torch.randn(r, s, device=dev, generator=g) * 3
                            ).clamp(max=1e4)
        density[::8, 0] = 1e4
        density[::16] = 0.0
    return dict(density=density,
                tdist=torch.sort(rand(r, s + 1) * 5, dim=-1).values,
                dirs=torch.randn(r, 3, device=dev, generator=g),
                rgb=rand(r, s, 3), semantic=rand(r, s, k) if k else None,
                intensity=rand(r, s) if with_int else None,
                opaque_background=opaque, bg_value=1.0)


def check_composite(what, args):
    """K1 vs its plain version on `args` at COMPOSITE_TOL; the max abs
    error."""
    import torch
    from nerf_lidar_tpu_torch.ops import render_fused
    got = render_fused.fused_composite(**args)
    want = render_fused.fused_composite_plain(**args)
    torch.cuda.synchronize()
    if set(got) != set(want):
        fail(f"composite outputs {sorted(got)} != {sorted(want)}")
    return max(close(f"composite {what} {key}", got[key], want[key],
                     *COMPOSITE_TOL[key]) for key in want)


def composite_bound(args):
    """K1's bound on `args`: every input read once, every output written
    once; operations, the weighted sums of depth, rgb and semantics (2 per
    sample each)."""
    import torch
    from nerf_lidar_tpu_torch.ops import render_fused
    out = render_fused.fused_composite(**args)
    r, s = args["density"].shape
    k = args["semantic"].shape[-1] if args["semantic"] is not None else 0
    return bound(nbytes(*(v for v in args.values()
                          if isinstance(v, torch.Tensor)), *out.values()),
                 2 * r * s * (4 + k))


def phase_composite(dev):
    """K1 vs plain on the card. Returns the max abs error."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for r, trained, opaque, with_int in (
            (16384, False, True, False), (16384, False, False, True),
            (700, False, True, True), (16384, True, True, False),
            (2432, True, False, True)):
        args = composite_inputs(dev, r, 32, 19, g, trained, opaque, with_int)
        worst = max(worst, check_composite(
            f"R={r} trained-like={trained} opaque={opaque}", args))
    print(f"[3] composite vs plain: max abs err {worst:.3e}")
    return worst


def time_composite(dev, worst):
    """[3]'s timing, after the timed entries (a torch.profiler session
    slows a later host-bound phase), on [3]'s first inputs (R = 16,384,
    opaque, no intensity): the numbers of K1's kernels line, by device time
    (CUDA events would time the wrapper's host side)."""
    import torch
    from nerf_lidar_tpu_torch.ops import render_fused
    timed = composite_inputs(dev, 16384, 32, 19,
                             torch.Generator(device=dev).manual_seed(0))
    ms = device_ms(lambda: render_fused.fused_composite(**timed))
    plain_ms = device_ms(lambda: render_fused.fused_composite_plain(**timed),
                         iters=10)
    lim = composite_bound(timed)
    print(f"[3] composite R=16384 S=32 K=19: device ms kernel {ms:.5f}, "
          f"plain {plain_ms:.4f}; bound {lim['bound_ms']:.5f} ms "
          f"({lim['bound_by']})")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=None, **lim)


def main_path_grids(cfg):
    """[(name, GridConfig, samples per ray)] of the NeRF and proposal grids."""
    m = cfg.model
    return [("nerf", m.nerf_mlp.grid, m.num_nerf_samples)] + [
        (f"prop{i}", m.prop_mlp_for_level(i).grid, samples)
        for i, samples in enumerate(m.num_prop_samples)]


def phase_hash_encode(dev, cfg, render_inputs):
    """H1 vs plain on the card, each grid at the batch the main path gives
    it (a render chunk times that grid's samples): on uniform points, and
    on `render_inputs` ({grid: (table, x01, stds, spec)} of a render chunk
    of [5]). Returns the numbers of its kernels line: the NeRF grid's on the
    render's points, with every grid's beside."""
    import torch
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid

    g = torch.Generator(device=dev).manual_seed(1)
    n = cfg.model.sample_n
    worst, grids = 0.0, {}
    for name, grid_cfg, samples in main_path_grids(cfg):
        b = cfg.render_chunk_size * samples
        spec = grid.spec_for(grid_cfg)
        table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                           generator=g) * 2 - 1
        x01 = torch.rand(b, n, 3, device=dev, generator=g) * 1.1 - 0.05
        stds = torch.rand(b, n, device=dev, generator=g) * 0.01 + 1e-5
        nums = {}
        for inputs, args in (("uniform", (table, x01, stds, spec)),
                             ("render", render_inputs[name])):
            got = grid.hash_encode_multisample(*args)
            want = grid.hash_encode_multisample_plain(*args)[0]
            torch.cuda.synchronize()
            err = close(f"hash_encode_ms {name} {inputs}", got, want, 1e-5,
                        1e-6)
            worst = max(worst, err)
            ms = cuda_ms(lambda: grid.hash_encode_multisample(*args),
                         iters=5, warmup=1)
            plain_ms = cuda_ms(lambda: grid.hash_encode_multisample_plain(
                *args), iters=5, warmup=1)
            # Bound: the points, the features and the distinct table rows
            # read; operations, one multiply-add per corner channel.
            lim = bound(*hb.fwd_bound(spec, args[1], args[2]))
            x = args[1]
            oob = float(((x < 0) | (x > 1)).any(-1).float().mean())
            print(f"[4] hash_encode_ms {name} on {inputs} points: "
                  f"{spec.num_levels} levels x C{spec.level_dim}, "
                  f"{spec.total_rows} rows, B={args[2].numel() // n} n={n} "
                  f"(out of range {oob:.3f}): max abs err {err:.3e}; kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
                  f"{lim['bound_ms']:.4f} ms ({lim['bound_by']})")
            nums[inputs] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                **lim)
            del got, want
        grids[name] = nums
        del table, x01, stds
    return dict(grids["nerf"]["render"], max_abs_err=worst, library_ms=None,
                uniform_ms=grids["nerf"]["uniform"]["ms"],
                uniform_bound_ms=grids["nerf"]["uniform"]["bound_ms"],
                grids=grids)


def phase_slice(dev):
    """The port's render_lidar entry at full width, kernels on; then the
    same sweep kernels off. Returns the launch counts of the entry's run
    and the encode's inputs of one sweep's first chunk, per grid."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.lidar.render import render_sweep
    from nerf_lidar_tpu_torch.ops import grid, render_fused
    from nerf_lidar_tpu_torch.renderer import ChunkRenderer

    torch.cuda.reset_peak_memory_stats(dev)
    render_fused.fused_composite.launches = 0
    grid.hash_encode_multisample.launches = 0
    t0 = time.perf_counter()
    run = cli.main(SLICE_ARGV)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    launches = dict(composite=render_fused.fused_composite.launches,
                    hash_encode_ms=grid.hash_encode_multisample.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[5] render_lidar (2 sweeps, cold, weights init included): "
          f"{entry_s:.2f} s; launches {launches}; peak memory "
          f"{peak / 2**30:.2f} GiB")
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the main path")

    n_rays = 32 * 1100
    for i in range(2):
        pts = np.load(os.path.join(run.sweep_dir, f"points_{i:04d}.npy"))
        sem = np.load(os.path.join(run.sweep_dir,
                                   f"points_semantic_{i:04d}.npy"))
        rgb = np.load(os.path.join(run.sweep_dir, f"points_rgb_{i:04d}.npy"))
        if pts.shape != (n_rays, 3) or sem.shape != (n_rays, 19) \
                or rgb.shape != (n_rays, 3):
            fail(f"sweep {i}: shapes {pts.shape} {sem.shape} {rgb.shape}")
        for name, a in (("points", pts), ("semantic", sem), ("rgb", rgb)):
            if not np.isfinite(a).all():
                fail(f"sweep {i}: non-finite {name}")
        if np.abs(sem.sum(-1) - 1).max() > 1e-3:
            fail(f"sweep {i}: semantic rows do not sum to 1")
    if np.load(os.path.join(run.sweep_dir, "lidar2globals.npy")).shape \
            != (2, 4, 4):
        fail("lidar2globals.npy has the wrong shape")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sweep = run.sweeps[0]
    kern = ChunkRenderer(run.model, run.cfg, run.cfg.render_chunk_size)
    plain = ChunkRenderer(run.model, run.cfg, run.cfg.render_chunk_size,
                          use_kernels=False)

    def timed(renderer):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = render_sweep(renderer, sweep, run.near, run.far, run.frame)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def check_depth(out, what):
        lo, hi = run.near * (1 - 1e-4), run.far * (1 + 1e-4)
        if out["depth"].min() < lo or out["depth"].max() > hi:
            fail(f"{what}: depth outside [near, far]: {out['depth'].min()} "
                 f"{out['depth'].max()}")

    # The points and stds H1 gets from one render chunk, for [4].
    render_inputs = hb.record_render_inputs(kern, sweep, run.near, run.far,
                                            run.frame)

    # Timing, on the entry's own (fresh) weights.
    times = dict(kernels=[], plain=[])
    for _ in range(3):
        for name, renderer in (("kernels", kern), ("plain", plain)):
            out, sec = timed(renderer)
            times[name].append(sec)
            check_depth(out, f"fresh weights, {name}")
    med = {k: statistics.median(v) for k, v in times.items()}
    STATIC["s_per_sweep"] = med["kernels"]
    print(f"[5] warm s/sweep (35,200 rays, median of 3, TF32 off): "
          f"kernels {med['kernels']:.4f} (runs {times['kernels']}), "
          f"plain {med['plain']:.4f} (runs {times['plain']})")

    # Agreement. Fresh tables are uniform(+-1e-4), so the encode barely
    # moves the field; uniform(-1, 1) tables make a wrong row or level
    # order in H1 change density, colour and the resampled intervals.
    g = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        for mlp in (run.model.nerf_mlp, *run.model.prop_mlps):
            mlp.table.uniform_(-1.0, 1.0, generator=g)
    a, _ = timed(kern)
    b, _ = timed(plain)
    check_depth(a, "uniform(-1, 1) tables, kernels")
    errs, _, _, spread = compare_sweeps("slice", a, b)
    print(f"[5] kernels on vs off (uniform(-1, 1) tables), max abs diff "
          f"{errs}; std across rays of the kernels' render {spread}")
    return launches, render_inputs


def compare_sweeps(what, a, b, share=0.0):
    """A sweep rendered kernels on (a) vs off (b): depth rtol 1e-3, rgb and
    semantic atol 1e-4 (the kernels change summation order only, and the
    resampling chain amplifies that), on all but `share` of each output's
    values, and none beyond 100 times the tolerance. Returns ({key: max abs
    diff}, {key: values outside the tolerance}, [rays] mask of the rays with
    a value outside, {key: std across rays of a})."""
    import torch
    errs, outside, rays, spread = {}, {}, None, {}
    for key, rtol, atol in (("depth", 1e-3, 0.0), ("rgb", 0.0, 1e-4),
                            ("semantic", 0.0, 1e-4)):
        got, want = torch.from_numpy(a[key]), torch.from_numpy(b[key])
        err = (got - want).abs()
        tol = atol + rtol * want.abs()
        out = err > tol
        n_out = int(out.sum())
        if not bool(torch.isfinite(got).all()) or n_out > share * \
                err.numel() or bool((err > 100 * tol).any()):
            fail(f"{what} {key}: {n_out} of {err.numel()} values outside "
                 f"rtol {rtol} / atol {atol} (allowed: {share} of them, "
                 f"none beyond 100 times; max abs err {float(err.max())})")
        out = out.reshape(out.shape[0], -1).any(-1)
        rays = out if rays is None else rays | out
        errs[key], outside[key] = float(err.max()), n_out
        spread[key] = float(got.std())
    return errs, outside, rays, spread


# Atomics sum each gradient row in an order that changes from run to run:
# relative to the largest value, 1e-4 leaves room for the coarse levels,
# where thousands of fp32 terms land on one row.
BWD_TOL = 1e-4
GRADS = ("d_table", "d_x01", "d_stds")


def phase_hash_encode_bwd(dev, cfg, train_inputs):
    """H1 backward vs its written-out plain twin, each grid at the train
    step's batch: on uniform points, and on `train_inputs` ({grid: (table,
    x01, stds, g_out, spec, needs)} of a train step of [8]); on prop0's
    uniform points (the smallest grid) also vs plain autograd through the
    plain encode, which takes seconds there (an accumulating index_put_ per
    corner and level). Returns the numbers of its kernels line: the NeRF
    grid's d_table on the train step's inputs, with every grid's beside,
    and "prop0_vs_autograd"."""
    import torch
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid

    g = torch.Generator(device=dev).manual_seed(6)
    n = cfg.model.sample_n
    rays = cfg.batch_size + cfg.batch_size // cfg.lidar_batch_ratio
    grids, vs_autograd = {}, None
    for name, grid_cfg, samples in main_path_grids(cfg):
        b = rays * samples
        spec = grid.spec_for(grid_cfg)
        table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                           generator=g) * 2 - 1
        x01 = torch.rand(b, n, 3, device=dev, generator=g) * 1.1 - 0.05
        stds = torch.rand(b, n, device=dev, generator=g) * 0.01 + 1e-5
        g_out = torch.randn(b, spec.output_dim, device=dev, generator=g)
        inputs = name == "prop0"
        nums = {}
        for kind, (args, needs) in (
                ("uniform", ((table, x01, stds, g_out, spec),
                             (True, inputs, inputs))),
                ("train", (train_inputs[name][:5], train_inputs[name][5]))):
            got = grid.hash_encode_multisample_bwd(*args, needs=needs)
            twin_ms, want = cuda_ms_once(
                lambda: grid.hash_encode_multisample_bwd_plain(
                    *args, needs=needs))
            errs = {key: rel_err(f"hash_encode_ms_bwd {name} {kind} {key} "
                                 "vs twin", got[i], want[i], BWD_TOL)
                    for i, key in enumerate(GRADS) if needs[i]}
            ms = cuda_ms(lambda: grid.hash_encode_multisample_bwd(
                *args, needs=(True, False, False)), iters=3, warmup=1)
            # Bound: the points and g_out read, the whole d_table written;
            # operations, a multiply and an add per corner channel.
            lim = bound(*hb.bwd_bound(spec, *args[1:4]))
            print(f"[6] hash_encode_ms_bwd {name} on {kind} points: "
                  f"{spec.num_levels} levels x C{spec.level_dim}, "
                  f"B={args[2].numel() // n} n={n}: vs written-out twin (max "
                  f"abs err, relative to max) {errs}; kernel {ms:.3f} ms "
                  f"(d_table only), twin {twin_ms:.1f} ms"
                  f"{' (all three inputs)' if all(needs) else ''}; bound "
                  f"{lim['bound_ms']:.4f} ms ({lim['bound_by']})")
            nums[kind] = dict(max_abs_err=errs["d_table"][0], ms=ms,
                              plain_ms=twin_ms, **lim)
            if kind == "uniform" and inputs:
                vs_autograd = _bwd_vs_autograd(name, spec, args, got)
            del got, want
        grids[name] = nums
        del table, x01, stds, g_out
        torch.cuda.empty_cache()
    return dict(grids["nerf"]["train"], library_ms=None,
                uniform_ms=grids["nerf"]["uniform"]["ms"],
                uniform_bound_ms=grids["nerf"]["uniform"]["bound_ms"],
                grids=grids, prop0_vs_autograd=vs_autograd)


def _bwd_vs_autograd(name, spec, args, got):
    """H1-bwd's three gradients (`got`) vs plain autograd through the plain
    encode; prints and returns (max abs err, kernel ms, autograd ms)."""
    import torch
    from nerf_lidar_tpu_torch.ops import grid
    table, x01, stds, g_out = args[:4]
    ms_all = cuda_ms(lambda: grid.hash_encode_multisample_bwd(*args),
                     iters=3, warmup=1)
    leaves = [t.clone().requires_grad_(True) for t in (table, x01, stds)]
    out = grid.hash_encode_multisample_plain(*leaves, spec)[0]
    auto_ms, auto = cuda_ms_once(lambda: torch.autograd.grad(out, leaves,
                                                             g_out))
    errs = {key: rel_err(f"hash_encode_ms_bwd {name} {key} vs autograd",
                         got[i], auto[i], BWD_TOL)
            for i, key in enumerate(GRADS)}
    print(f"[6] hash_encode_ms_bwd {name} vs plain autograd {errs}; all "
          f"three inputs: kernel {ms_all:.3f} ms, autograd {auto_ms:.1f} ms")
    return dict(max_abs_err=max(e[0] for e in errs.values()), ms=ms_all,
                plain_ms=auto_ms)


# Relative to the largest sum. At K3's own shapes (~1,000 values a row),
# against index_add_. On the path a level of up to 2^21 values lands on
# one row: the kernel adds ~16,000 partial sums there in any order, so it
# is held against index_add_ in float64, to 1e-4; index_add_ in float32,
# the timed plain version, is itself ~1e-3 off there.
SCATTER_TOL = 1e-5
PATH_SCATTER_TOL = 1e-4


def phase_scatter(dev, cfg):
    """K3 vs index_add_, at the train path's shapes (the hash-decay level
    sums of each grid, table uniform(-1, 1)) and at K3's own; kernel, plain
    version and `index_add_` alone, beside the bound, at every shape.
    Returns the numbers of its kernels line for the NeRF grid's level sums
    (every grid's under "grids", every own shape's under "own_shapes"), and
    the same at K3's rows 2^17, N 2^22."""
    import torch
    from nerf_lidar_tpu_torch.ops import grid

    g = torch.Generator(device=dev).manual_seed(7)
    grids = {}
    for name, grid_cfg, _ in main_path_grids(cfg):
        spec = grid.spec_for(grid_cfg)
        table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                           generator=g) * 2 - 1
        ids = grid.level_ids(spec, dev)
        vals = table**2
        rows = spec.num_levels
        got = grid.scatter_add_rows(ids, vals, rows)
        want = grid.scatter_add_rows_plain(ids, vals.double(), rows)
        err, rel = rel_err(f"scatter_add_rows hash decay {name}",
                           got.double(), want, PATH_SCATTER_TOL)
        plain32 = float((grid.scatter_add_rows_plain(ids, vals, rows)
                         - want).abs().max() / want.abs().max())
        # Device time (torch.profiler): the proposal grids' kernels take
        # less time than the wrapper's host side, which CUDA events would
        # time instead.
        ms = device_ms(lambda: grid.scatter_add_rows(ids, vals, rows))
        plain_ms = device_ms(lambda: grid.scatter_add_rows_plain(
            ids, vals, rows), iters=5)
        ids64 = ids.long()
        library_ms = device_ms(lambda: vals.new_zeros(
            rows, spec.level_dim).index_add_(0, ids64, vals), iters=5)
        # Bound: idx and vals read, the sums written; one add a value.
        lim = bound(nbytes(ids, vals, got), vals.numel())
        grids[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, **lim)
        print(f"[7] scatter_add_rows hash decay {name}: N={spec.total_rows}"
              f" rows onto {rows} C={spec.level_dim}: max abs err "
              f"{err:.3e} ({rel:.2e} of max; index_add_ in float32 "
              f"{plain32:.2e}); device ms: kernel {ms:.4f}, plain "
              f"{plain_ms:.4f}, index_add_ alone {library_ms:.4f}; bound "
              f"{lim['bound_ms']:.4f} ms ({lim['bound_by']})")
        del table, vals, got, want, ids64

    c, own_shapes = 16, {}
    for rows in (4096, 1 << 17):
        for n in (1 << 20, 1 << 22):
            idx = torch.randint(0, rows, (n,), device=dev, generator=g,
                                dtype=torch.int32)
            idx64 = idx.long()
            vals = torch.randn(n, c, device=dev, generator=g)
            plain = lambda: vals.new_zeros(rows, c).index_add_(0, idx64,
                                                               vals)
            got = grid.scatter_add_rows(idx, vals, rows)
            err, rel = rel_err(f"scatter_add_rows rows={rows} N={n}", got,
                               plain(), SCATTER_TOL)
            ms = device_ms(lambda: grid.scatter_add_rows(idx, vals, rows))
            plain_ms = device_ms(plain, iters=5)
            lim = bound(nbytes(idx, vals, got), vals.numel())
            print(f"[7] scatter_add_rows rows={rows} N={n} C={c}: max abs "
                  f"err {err:.3e} ({rel:.2e} of max); device ms: kernel "
                  f"{ms:.4f}, index_add_ {plain_ms:.4f}; bound "
                  f"{lim['bound_ms']:.4f} ms ({lim['bound_by']})")
            own_shapes[f"rows={rows} N={n} C={c}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=plain_ms, **lim)
    return (dict(grids["nerf"], grids=grids, own_shapes=own_shapes),
            own_shapes[f"rows={1 << 17} N={1 << 22} C={c}"])


def _table_grads_nonzero(model, what):
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    for name, mlp in hb.grid_names(model):
        grad = mlp.table.grad
        if grad is None or float(grad.abs().max()) == 0.0:
            fail(f"{what}: the {name} hash table got no gradient")


# Kernels on vs off, the first step from the same weights: every MLP
# parameter's gradient relative to its largest value (no atomic sums them;
# a zero, wrong-sign or misplaced gradient is off by 1 or more, summation
# order moves it by ~2e-4), and each step's loss (measured spread 1.5e-5
# over 3 steps).
GRAD_TOL = 1e-3
LOSS_TOL = 1e-4
# A hash table's gradient is a sum of terms, each row's in an order that
# atomics change from run to run, and a row whose terms cancel can end far
# below its terms (prop0's table once differed by 3.6e-11 against a 2.2e-8
# maximum on an NVIDIA H100 80GB HBM3, 700 W, and failed 1e-3 of max). So
# each row is held to the magnitudes of its terms:
# |g_on - g_off| <= TABLE_GRAD_EPS_MULT * eps32 * terms + upstream, where
# terms sums |term| over both steps (the encode backward over |g_out|, plus
# the hash-decay gradient) and upstream is what the two steps' different
# encode inputs carry (the written-out backward on each side's inputs,
# differenced). Four float32 sums stand behind that difference (the two
# gradients, the two written-out backwards); the error of one grows like
# sqrt(N) eps times its terms for terms in random order (N ~ 15,000 on the
# coarsest rows of these grids), and 4096 leaves that room three times
# over. A zero, wrong-sign or misplaced row taken by few terms is off by
# ~1 / eps32 (8.4e6) of them.
EPS32 = 2.0**-23
TABLE_GRAD_EPS_MULT = 4096


def table_params(model):
    """{parameter name: grid name} of a model's hash tables (the object
    grids' too)."""
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    grids = {id(mlp.table): name for name, mlp in hb.grid_names(model)}
    return {pname: grids[id(p)] for pname, p in model.named_parameters()
            if id(p) in grids}


def decayed_grids(model, cfg):
    """[(grid name, MLP)] of the tables the hash-decay term holds: every
    grid, the object grids only without `obj_nodecay`."""
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    return [(name, mlp) for name, mlp in hb.grid_names(model)
            if not (name.startswith("obj") and cfg.obj_nodecay)]
# The hash-decay term is K3's output on the path. It is held against the
# same term from per-level slice sums in float64 (K3's level sums are
# within ~5e-6 of those, [7]); the plain side, index_add_ in float32, is
# itself ~1e-3 off, so it is reported, not held.
HASH_DECAY_TOL = 1e-4


def fresh_exp_dir(argv):
    """Remove the experiment directory an entry would resume from."""
    from nerf_lidar_tpu_torch import cli
    shutil.rmtree(cli.exp_dir(cli.build_config(cli.parse_args(argv))),
                  ignore_errors=True)


def hash_decay_f64(model, cfg):
    """The hash-decay loss term from per-level slice sums in float64."""
    import torch
    total = 0.0
    for _, mlp in decayed_grids(model, cfg):
        spec, table = mlp.spec, mlp.table.detach().double()
        sums = torch.stack([table[o:o + r].square().sum(0) / r for o, r in
                            zip(spec.offsets, spec.rows_per_level)])
        total += float(sums.mean())
    return cfg.hash_decay_mults * total


def table_grad_excess(got, want, terms, upstream):
    """The largest (|got - want| - upstream) / (eps32 * terms) over a hash
    table's entries: how many float32 eps of its terms' magnitudes a
    gradient (`got`) is off the other (`want`), beyond what `upstream`
    carries. inf where got is not finite or a row without terms differs."""
    import torch
    need = ((got - want).abs() - upstream).clamp(min=0)
    ratio = torch.where(need > 0, need / (EPS32 * terms), 0.0)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(ratio.max())


def table_grad_bounds(spec, table, on, off, decay):
    """(terms, upstream) of one hash table's gradient, kernels on vs off,
    for `table_grad_excess`. on / off: the (x01, stds, g_out) of every
    encode call whose output took a gradient on each side (the object grids
    are encoded at every level); decay: the table's gradient from the
    hash-decay term, which both sides add. Through the written-out backward
    in float32, which picks the kernel's cells."""
    from nerf_lidar_tpu_torch.ops import grid

    def bwd(calls, absolute=False):
        return sum(grid.hash_encode_multisample_bwd_plain(
            table, x01, stds, g_out.abs() if absolute else g_out, spec,
            needs=(True, False, False))[0] for x01, stds, g_out in calls)

    terms = bwd(on, True) + bwd(off, True) + 2 * decay.abs()
    upstream = (bwd(on) - bwd(off)).abs()
    return terms, upstream


def step_table_bounds(model, cfg, seen_on, seen_off, what):
    """{table parameter name: (terms, upstream)} of one train step, kernels
    on (seen_on: `recording_all` of the backward kernel) vs off (seen_off:
    `recording_plain_encode`), for `_grads_close`."""
    import torch
    dev = next(model.parameters()).device
    decayed = {name for name, _ in decayed_grids(model, cfg)}
    tables = {}
    for pname, gname in table_params(model).items():
        on = seen_on.get(gname, [])
        off = [rec[:3] for rec in seen_off.get(gname, [])
               if rec[2] is not None]
        if not on or not off:
            fail(f"{what}: the {gname} table's encode got no gradient on "
                 f"{'the kernels' if not on else 'the plain'} side")
        table, spec = on[0][0].to(dev), on[0][4]
        decay = (hash_decay_grad(table, spec, cfg.hash_decay_mults)
                 if gname in decayed else torch.zeros_like(table))
        tables[pname] = table_grad_bounds(
            spec, table, [[t.to(dev) for t in rec[1:4]] for rec in on],
            [[t.to(dev) for t in rec] for rec in off], decay)
    return tables



def hash_decay_grad(table, spec, mult):
    """The gradient of `losses.hash_decay_loss`'s term of one table: 2
    mult table / (L C rows of the row's level)."""
    import torch
    from nerf_lidar_tpu_torch.ops import grid
    rows = torch.tensor(spec.rows_per_level, dtype=table.dtype,
                        device=table.device)
    count = rows[grid.level_ids(spec, table.device).long()][:, None]
    return 2 * mult * table / (spec.num_levels * spec.level_dim * count)


def to_host(t):
    """A host copy of a tensor, anything else as it is."""
    import torch
    return t.detach().to("cpu", copy=True) if isinstance(
        t, torch.Tensor) else t


@contextlib.contextmanager
def recording_plain_encode(model):
    """Within the block, the plain encode records, per hash table of
    `model`, every call's [x01, stds, g_out, spec] (g_out from a hook on its
    features, set once backward reaches them, None where no gradient
    does), tensors in host memory."""
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid
    orig = grid.hash_encode_multisample_plain
    names = hb.grid_tables(model)
    calls = {}

    def wrapper(table, x01, stds, spec):
        out = orig(table, x01, stds, spec)
        name = names.get(table.data_ptr())
        if name is not None and out[0].requires_grad:
            rec = [to_host(x01), to_host(stds), None, spec]
            calls.setdefault(name, []).append(rec)
            out[0].register_hook(lambda g: rec.__setitem__(2, to_host(g)))
        return out

    grid.hash_encode_multisample_plain = wrapper
    try:
        yield calls
    finally:
        grid.hash_encode_multisample_plain = orig


@contextlib.contextmanager
def recording_all(module, name, model):
    """Within the block, module.<name> (the encode's backward wrapper)
    records every call per hash table of `model`: {grid name: [(table,
    x01, stds, g_out, spec, needs), ...]}, tensors cloned (`calls_to_host`
    moves them off the card). The wrapper carries the function's launch
    count, and gives it back."""
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    orig = getattr(module, name)
    names = hb.grid_tables(model)
    calls = {}

    def wrapper(*args, **kw):
        grid_name = names.get(args[0].data_ptr())
        if grid_name is not None:
            needs = kw.get("needs", args[5] if len(args) > 5
                           else (True, True, True))
            calls.setdefault(grid_name, []).append(tuple(
                a.detach().clone() if hasattr(a, "detach") else a
                for a in args[:5]) + (needs,))
        return orig(*args, **kw)

    wrapper.launches = orig.launches
    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        orig.launches = wrapper.launches
        setattr(module, name, orig)


def calls_to_host(calls):
    """`recording_all`'s calls with their tensors in host memory."""
    return {k: [tuple(to_host(t) for t in rec) for rec in v]
            for k, v in calls.items()}


def _grads_close(model, model_p, what, tables):
    """Kernels on (model) vs off (model_p) after one step. MLP parameters:
    max |grad - grad_p| / max |grad_p|, failing above GRAD_TOL; hash tables
    (`tables`: {parameter name: (terms, upstream)}): `table_grad_excess`,
    failing above TABLE_GRAD_EPS_MULT. Fails on a non-finite gradient, or
    where one side has none. Returns (worst MLP ratio, its parameter,
    {grid: table excess in eps})."""
    import torch
    worst, where, excess = 0.0, None, {}
    for (name, p), q in zip(model.named_parameters(), model_p.parameters()):
        if (p.grad is None) != (q.grad is None):
            fail(f"{what}: {name} has a gradient on one side only")
        if p.grad is None:
            continue
        if name in tables:
            e = table_grad_excess(p.grad, q.grad, *tables[name])
            if not e <= TABLE_GRAD_EPS_MULT:
                fail(f"{what}: {name} gradient differs by {e} float32 eps "
                     f"of its terms beyond the upstream difference "
                     f"(tolerance {TABLE_GRAD_EPS_MULT})")
            excess[table_params(model)[name]] = e
            continue
        scale = float(q.grad.abs().max())
        err = float((p.grad - q.grad).abs().max())
        if not bool(torch.isfinite(p.grad).all()) or err > GRAD_TOL * scale:
            fail(f"{what}: {name} gradient differs by {err} against max "
                 f"|grad| {scale} (tolerance {GRAD_TOL} of it)")
        if scale > 0 and err / scale > worst:
            worst, where = err / scale, name
    if set(excess) != set(table_params(model).values()):
        fail(f"{what}: hash tables checked {sorted(excess)}")
    return worst, where, excess


def phase_train(dev):
    """The port's train entry at full width, kernels on; then kernels on vs
    off for 3 steps; then the learning check. Each entry starts from a
    fresh experiment directory (it would resume from a checkpoint there).
    Returns (launch counts of the entry's run, path of the params it
    wrote, the encode backward's inputs of one more warm step per grid)."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid
    from nerf_lidar_tpu_torch.train import train_step

    fresh_exp_dir(TRAIN_ARGV)
    fresh_exp_dir(LEARN_ARGV)

    counters = dict(hash_encode_ms=grid.hash_encode_multisample,
                    hash_encode_ms_bwd=grid.hash_encode_multisample_bwd,
                    scatter_add_rows=grid.scatter_add_rows)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run = cli.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the train path")
    hist = run.history
    if len(hist) != TRAIN_STEPS or not all(
            np.isfinite(h["loss"]) and np.isfinite(h["psnr"]) for h in hist):
        fail(f"train: {len(hist)} steps logged, or a loss is not finite")
    _table_grads_nonzero(run.model, "train entry")
    step_ms = 1e3 * statistics.median(h["step_s"] for h in hist[-20:])
    rays = run.batcher.total_rays
    STATIC.update(ms_per_step=step_ms, peak_gib=peak / 2**30)
    print(f"[8] train (nuscenes_single, synthetic, {rays} rays/step, "
          f"{TRAIN_STEPS} steps, cold, init included): {entry_s:.2f} s; "
          f"launches {launches}; warm {step_ms:.1f} ms/step (median of the "
          f"last 20), {rays / step_ms * 1e3:,.0f} rays/s; peak memory "
          f"{peak / 2**30:.2f} GiB; loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}")

    # The points, stds and feature gradients the H1 backward gets in one
    # warm step, for [6].
    train_inputs = hb.record_train_inputs(run, TRAIN_STEPS)

    # Kernels on vs off: the same weights, optimizer state, batches and
    # random draws (tolerances above).
    cfg = run.cfg
    model_p = copy.deepcopy(run.model)
    opt_p = train_step.make_optimizer(model_p, cfg)
    # A deep copy: load_state_dict keeps the very moment tensors it is
    # given, which both optimizers would then update.
    opt_p.load_state_dict(copy.deepcopy(run.optimizer.state_dict()))
    batches = [cli.to_device(run.batcher.next(), dev) for _ in range(3)]
    gens = [torch.Generator(device=dev).manual_seed(99) for _ in range(2)]
    decay_ref = hash_decay_f64(run.model, cfg)
    worst_loss = 0.0
    step_s = dict(on=[], off=[])
    torch.cuda.reset_peak_memory_stats(dev)
    for i, batch in enumerate(batches):
        step = TRAIN_STEPS + 1 + i
        # The first step records what each side's encode saw, for the
        # table gradients' bounds.
        with (recording_all(grid, "hash_encode_multisample_bwd", run.model)
              if i == 0 else contextlib.nullcontext({})) as seen_on:
            t0 = time.perf_counter()
            on = train_step.train_step(run.model, run.optimizer, cfg, batch,
                                       step, run.batcher.num_patch_rays,
                                       gens[0])
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        # Held in host memory, off the plain step's device memory peak.
        seen_on = calls_to_host(seen_on)
        with (recording_plain_encode(model_p) if i == 0
              else contextlib.nullcontext({})) as seen_off:
            off = train_step.train_step(model_p, opt_p, cfg, batch, step,
                                        run.batcher.num_patch_rays, gens[1],
                                        use_kernels=False)
            torch.cuda.synchronize()
        step_s["on"].append(t1 - t0)
        step_s["off"].append(time.perf_counter() - t1)
        a, b = float(on["loss"]), float(off["loss"])
        worst_loss = max(worst_loss, abs(a - b) / abs(b))
        if abs(a - b) > LOSS_TOL * abs(b):
            fail(f"train step {step}: loss kernels {a} vs plain {b}")
        if i == 0:
            what = f"train step {step}, kernels on vs off"
            grad_err = _grads_close(run.model, model_p, what,
                                    step_table_bounds(run.model, cfg, seen_on,
                                                      seen_off, what))
            del seen_on, seen_off
            decay = [abs(float(stats["hash_decay"]) - decay_ref) / decay_ref
                     for stats in (on, off)]
            if not decay[0] <= HASH_DECAY_TOL:
                fail(f"train step {step}: hash decay (K3 on the path) "
                     f"{float(on['hash_decay'])} vs {decay_ref} in float64")
    _table_grads_nonzero(model_p, "kernels-off steps")
    med = {k: 1e3 * statistics.median(v) for k, v in step_s.items()}
    print(f"[8] 3 steps kernels on vs off: loss rel diff {worst_loss:.2e} "
          f"(tol {LOSS_TOL}); first step's gradients: MLPs, worst relative "
          f"to max {grad_err[0]:.2e} ({grad_err[1]}; tol {GRAD_TOL}); hash "
          f"tables, float32 eps of the terms beyond the upstream difference "
          f"{ {k: round(v, 2) for k, v in grad_err[2].items()} } (tol "
          f"{TABLE_GRAD_EPS_MULT}); hash decay vs "
          f"float64 slice sums, relative: K3 {decay[0]:.2e} (tol "
          f"{HASH_DECAY_TOL}), index_add_ {decay[1]:.2e}; ms/step (median "
          f"of 3, host clock, synchronised) kernels {med['on']:.1f} "
          f"({rays / med['on'] * 1e3:,.0f} rays/s), plain {med['off']:.1f} "
          f"({rays / med['off'] * 1e3:,.0f} rays/s); peak memory of the "
          f"two models and the plain steps "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    del run, model_p, opt_p, batches
    torch.cuda.empty_cache()

    learn = cli.main(LEARN_ARGV)
    params = learn.params
    data = [h["data"] for h in learn.history]
    first, last = float(np.mean(data[:5])), float(np.mean(data[-5:]))
    if not (len(data) == 100 and last < first):
        fail(f"learning check: data loss {first} (first 5) -> {last} "
             f"(last 5) over {len(data)} steps")
    print(f"[8] learning check (100 steps, no warm-up): data loss "
          f"{first:.4f} (mean of first 5) -> {last:.4f} (mean of last 5); "
          f"psnr {learn.history[0]['psnr']:.2f} -> "
          f"{learn.history[-1]['psnr']:.2f}")
    del learn
    torch.cuda.empty_cache()
    return launches, params, train_inputs


# The trained sweep, kernels on vs off: the share of each output's values
# that may lie outside [5]'s tolerances. On a trained field the proposal
# levels' resampling turns the encode's float rounding into shifts of the
# final sample intervals on a few rays, which move their rgb. Measured on
# an NVIDIA H100 80GB HBM3, 700 W: H1 within 2.4e-7 of its plain version on
# every call; intervals moved by up to 1.1e-3 on 14-28 rays, whose rgb
# moved by up to 4.2e-4 (22-43 of 105,600 values, under 0.05%); K1 on with
# H1 off moved nothing beyond 3.1e-7. So every K1 and H1 call of the sweep
# is held against its plain version on its own inputs, and the K1-only
# sweep to [5]'s tolerances on every value.
TRAINED_SWEEP_SHARE = 2e-3


@contextlib.contextmanager
def kernels_checked():
    """Within the block, every call of K1 (`render_fused.fused_composite`)
    and H1 (`grid.hash_encode_multisample`) is held against its plain
    version on its own inputs, at [3]'s and [4]'s tolerances, and the plain
    compositor records the sample intervals it gets. Yields {"k1_args": the
    first K1 call's arguments by name (tensors cloned), "k1" / "h1": each
    call's max abs error, "tdist_kernels" / "tdist_plain": each call's
    intervals}. The wrappers carry the kernels' launch counts and give them
    back."""
    import inspect
    import torch
    from nerf_lidar_tpu_torch.ops import grid, render_fused
    k1, k1_plain = render_fused.fused_composite, \
        render_fused.fused_composite_plain
    h1, h1_plain = grid.hash_encode_multisample, \
        grid.hash_encode_multisample_plain
    sig = inspect.signature(k1)
    rec = dict(k1_args={}, k1=[], h1=[], tdist_kernels=[], tdist_plain=[])

    def k1_checked(*a, **kw):
        args = sig.bind(*a, **kw)
        args.apply_defaults()
        args = args.arguments
        if not rec["k1_args"]:
            rec["k1_args"].update({k: v.detach().clone() if isinstance(
                v, torch.Tensor) else v for k, v in args.items()})
        rec["tdist_kernels"].append(args["tdist"].detach().clone())
        got, want = k1(*a, **kw), k1_plain(*a, **kw)
        rec["k1"].append(max(close(f"trained sweep K1 call {len(rec['k1'])}"
                                   f" {key}", got[key], want[key],
                                   *COMPOSITE_TOL[key]) for key in want))
        return got

    def k1_plain_recorded(*a, **kw):
        args = sig.bind(*a, **kw).arguments
        rec["tdist_plain"].append(args["tdist"].detach().clone())
        return k1_plain(*a, **kw)

    def h1_checked(table, x01, stds, spec):
        got = h1(table, x01, stds, spec)
        rec["h1"].append(close(f"trained sweep H1 call {len(rec['h1'])}",
                               got, h1_plain(table, x01, stds, spec)[0],
                               1e-5, 1e-6))
        return got

    k1_checked.launches, h1_checked.launches = k1.launches, h1.launches
    render_fused.fused_composite = k1_checked
    render_fused.fused_composite_plain = k1_plain_recorded
    grid.hash_encode_multisample = h1_checked
    try:
        yield rec
    finally:
        k1.launches, h1.launches = k1_checked.launches, h1_checked.launches
        render_fused.fused_composite = k1
        render_fused.fused_composite_plain = k1_plain
        grid.hash_encode_multisample = h1


def phase_train_to_render(dev, params):
    """render_lidar --params <the weights [8] trained>: one full sweep; then
    that sweep kernels on (every K1 and H1 call held against its plain
    version) vs off, on all but TRAINED_SWEEP_SHARE of the values at [5]'s
    tolerances, and K1 on with H1 off vs off on every value; then K1 vs its
    plain version on the inputs of the sweep's first chunk (recorded), which
    also go to exp/chip_smoke_train/k1_chunk.pt for
    `experiments/composite_gather_bench.py --chunk`. Returns the numbers of
    K1's kernels line on that chunk."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.lidar.render import render_sweep
    from nerf_lidar_tpu_torch.ops import grid, render_fused
    from nerf_lidar_tpu_torch.renderer import ChunkRenderer

    render_fused.fused_composite.launches = 0
    grid.hash_encode_multisample.launches = 0
    run = cli.main(["render_lidar", "--config", "nuscenes_single",
                    "--set", "dataset_loader=synthetic", "--mode", "simu",
                    "--num_sweeps", "1", "--params", params,
                    "--device", "cuda", "--exp_name", "chip_smoke_train"])
    launches = dict(composite=render_fused.fused_composite.launches,
                    hash_encode_ms=grid.hash_encode_multisample.launches)
    for name, count in launches.items():
        if count == 0:
            fail(f"render from trained params: {name} was not launched")
    pts = np.load(run.paths[0])
    origin = run.sweeps[0].origins
    depth = np.linalg.norm(pts - origin, axis=-1)
    if pts.shape != (32 * 1100, 3) or not np.isfinite(pts).all():
        fail(f"render from trained params: points {pts.shape}, or not "
             "finite")
    print(f"[9] render_lidar --params {params}: 1 sweep, {pts.shape[0]} "
          f"rays, launches {launches}; hit distance {depth.min():.3f} .. "
          f"{depth.max():.3f} (median {np.median(depth):.3f})")

    # The trained field's sweep, kernels on (every K1 and H1 call held
    # against its plain version) vs off.
    sweep = run.sweeps[0]
    kern = ChunkRenderer(run.model, run.cfg, run.cfg.render_chunk_size)
    plain = ChunkRenderer(run.model, run.cfg, run.cfg.render_chunk_size,
                          use_kernels=False)
    with kernels_checked() as rec:
        a = render_sweep(kern, sweep, run.near, run.far, run.frame)
        b = render_sweep(plain, sweep, run.near, run.far, run.frame)
    errs, outside, rays, spread = compare_sweeps(
        "trained sweep", a, b, share=TRAINED_SWEEP_SHARE)
    # K1 on, H1 off: the plain render with the kernel compositor, which
    # gets the plain render's very inputs, so [5]'s tolerances hold on every
    # value.
    plain_composite = render_fused.fused_composite_plain
    render_fused.fused_composite_plain = render_fused.fused_composite
    try:
        c = render_sweep(plain, sweep, run.near, run.far, run.frame)
    finally:
        render_fused.fused_composite_plain = plain_composite
    k1_errs = compare_sweeps("trained sweep, K1 on and H1 off", c, b)[0]
    n = rays.shape[0]
    moved = (torch.cat(rec["tdist_kernels"])[:n]
             - torch.cat(rec["tdist_plain"])[:n]).abs().amax(-1).cpu()
    print(f"[9] trained sweep: every call vs its plain version, max abs "
          f"err K1 {max(rec['k1']):.3e} ({len(rec['k1'])} calls), H1 "
          f"{max(rec['h1']):.3e} ({len(rec['h1'])} calls); kernels on vs "
          f"off, max abs diff {errs}, values outside [5]'s tolerances "
          f"{outside} (allowed {TRAINED_SWEEP_SHARE} of each); the final "
          f"sample intervals moved by up to "
          f"{float(moved[rays].max()) if bool(rays.any()) else 0.0:.3e} on "
          f"the {int(rays.sum())} rays outside, 99th percentile over all "
          f"rays {float(moved.quantile(0.99)):.3e}; K1 on and H1 off vs "
          f"off, max abs diff {k1_errs}; std across rays of the kernels' "
          f"render {spread}")

    # K1 alone on the first chunk: what the trained field hands it.
    chunk = rec["k1_args"]
    err = check_composite("trained chunk", chunk)
    ms = device_ms(lambda: render_fused.fused_composite(**chunk))
    lim = composite_bound(chunk)
    w = render_fused.fused_composite_plain(**chunk)["weights"]
    sigma = chunk["density"]
    print(f"[9] K1 on the trained sweep's first chunk (R, S, K = "
          f"{tuple(chunk['semantic'].shape)}): max abs err vs plain "
          f"{err:.3e}; device ms {ms:.5f} (bound {lim['bound_ms']:.5f}); "
          f"density max {float(sigma.max()):.4g}, median "
          f"{float(sigma.median()):.4g}; rays with weight > 0.99 on their "
          f"first sample {float((w[:, 0] > 0.99).float().mean()):.4f}, with "
          f"T = 0 before the last sample "
          f"{float((w[:, -1] == 0).float().mean()):.4f}")
    torch.save(chunk, os.path.join(cli.exp_dir(run.cfg), "k1_chunk.pt"))
    return dict(trained_chunk_ms=ms, trained_chunk_max_err=err,
                trained_chunk_bound_ms=lim["bound_ms"])


@contextlib.contextmanager
def obj_grid_launches(spec):
    """Within the block, counts the launches of H1, its backward and K3 on
    the object grids (hash grid `spec`; K3 at an object table's hash-decay
    shape): yields {"hash_encode_ms", "hash_encode_ms_bwd",
    "scatter_add_rows": count}. Installed last, its wrappers take the
    kernels' counts (as `hb.recording` does) and give them back."""
    from nerf_lidar_tpu_torch.ops import grid
    is_obj = dict(
        hash_encode_multisample=lambda a: a[3] == spec,
        hash_encode_multisample_bwd=lambda a: a[4] == spec,
        scatter_add_rows=lambda a: (
            tuple(a[1].shape) == (spec.total_rows, spec.level_dim)
            and a[2] == spec.num_levels))
    names = dict(hash_encode_multisample="hash_encode_ms",
                 hash_encode_multisample_bwd="hash_encode_ms_bwd",
                 scatter_add_rows="scatter_add_rows")
    counts = {v: 0 for v in names.values()}
    origs = {}

    def counting(name, orig):
        def wrapper(*a, **kw):
            before = wrapper.launches
            out = orig(*a, **kw)
            if is_obj[name](a):
                counts[names[name]] += wrapper.launches - before
            return out
        wrapper.launches = orig.launches
        return wrapper

    for name in names:
        origs[name] = getattr(grid, name)
        setattr(grid, name, counting(name, origs[name]))
    try:
        yield counts
    finally:
        for name, orig in origs.items():
            orig.launches = getattr(grid, name).launches
            setattr(grid, name, orig)


@contextlib.contextmanager
def box_hits():
    """Within the block, records which rays have a sample in a box at each
    composite_objects call ([R] bool per call, host memory)."""
    from nerf_lidar_tpu_torch.models import objects as objlib
    orig = objlib.composite_objects
    calls = []

    def wrapper(*a, **kw):
        out = orig(*a, **kw)
        calls.append(out["obj_mask"].flatten(1).any(-1).cpu())
        return out

    objlib.composite_objects = wrapper
    try:
        yield calls
    finally:
        objlib.composite_objects = orig


def rays_in_a_box(calls, levels, n):
    """[n] bool: rays with a sample in a box at any level, from `box_hits`'s
    calls (chunk by chunk, `levels` calls a chunk)."""
    import torch
    per_chunk = torch.stack(calls).reshape(-1, levels, calls[0].shape[0])
    return per_chunk.any(1).reshape(-1)[:n].numpy()


def sweep_files(run):
    """{depth, rgb, semantic} of a render_lidar run's first sweep, read back
    from its files; depth is the distance from each ray's origin to its
    point, in the world frame."""
    import numpy as np
    pts = np.load(run.paths[0])
    sem = np.load(run.paths[0].replace("points_", "points_semantic_"))
    rgb = np.load(run.paths[0].replace("points_", "points_rgb_"))
    origin = run.frame.scene_to_world_points(run.sweeps[0].origins)
    n = run.sweeps[0].num_rays
    if pts.shape != (n, 3) or rgb.shape != (n, 3) or sem.shape[0] != n:
        fail(f"render_lidar {run.sweep_dir}: shapes {pts.shape} "
             f"{sem.shape} {rgb.shape} for {n} rays")
    for name, a in (("points", pts), ("semantic", sem), ("rgb", rgb)):
        if not np.isfinite(a).all():
            fail(f"render_lidar {run.sweep_dir}: non-finite {name}")
    return dict(depth=np.linalg.norm(pts - origin, axis=-1), rgb=rgb,
                semantic=sem)


def phase_objects(dev):
    """[12] The recipe with dynamic objects: a synth_nusc scene (one moving
    car and its track), the port's train entry for OBJ_STEPS steps with the
    tracknet live from the first, 2 steps kernels on vs off, H1 / H1-bwd /
    K3 on the object grid against their plain versions, and the trained
    params rendered by render_lidar with the car (--obj_mode replay) and
    without it (removal). Returns {"train_objects": launches,
    "render_lidar_objects": launches, "obj_grid": {kernel: numbers}}."""
    import dataclasses
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.data import synth_nusc
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.lidar.render import render_sweep
    from nerf_lidar_tpu_torch.ops import grid, render_fused
    from nerf_lidar_tpu_torch.train import train_step

    fresh_exp_dir(OBJ_TRAIN_ARGV)
    t0 = time.perf_counter()
    synth_nusc.write_scene_dir(OBJ_SCENE, sensor_num=1)
    print(f"[12] synth_nusc scene written in {time.perf_counter() - t0:.1f} "
          f"s: {OBJ_SCENE}")
    spec = grid.spec_for(
        cli.build_config(cli.parse_args(OBJ_TRAIN_ARGV)).model.obj_mlp.grid)

    # The train entry, kernels on.
    counters = dict(hash_encode_ms=grid.hash_encode_multisample,
                    hash_encode_ms_bwd=grid.hash_encode_multisample_bwd,
                    scatter_add_rows=grid.scatter_add_rows)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with obj_grid_launches(spec) as obj_launches:
        run = cli.main(OBJ_TRAIN_ARGV)
        torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the objects train path")
    for name in ("hash_encode_ms", "hash_encode_ms_bwd"):
        if obj_launches[name] == 0:
            fail(f"kernel {name} was not launched on the object grid")
    cfg, hist = run.cfg, run.history
    if run.tracknet is None or cfg.model.num_objects < 1:
        fail(f"objects train: {cfg.model.num_objects} object slots, "
             f"tracknet {run.tracknet}")
    if len(hist) != OBJ_STEPS or not all(
            np.isfinite(h["loss"]) and np.isfinite(h["psnr"]) for h in hist):
        fail(f"objects train: {len(hist)} steps logged, or a loss is not "
             "finite")
    hit = [h["obj_hit_frac"] for h in hist]
    overflow = [h["obj_overflow"] for h in hist]
    if not max(hit) > 0 or any(o != 0 for o in overflow):
        fail(f"objects train: obj_hit_frac {hit}, obj_overflow {overflow}")
    _table_grads_nonzero(run.model, "objects train entry")
    for name, p in (("obj_latents", run.model.obj_latents),
                    ("tracknet opt_t", run.tracknet.opt_t)):
        if p.grad is None or float(p.grad.abs().max()) == 0.0:
            fail(f"objects train entry: {name} got no gradient")
    step_ms = 1e3 * statistics.median(h["step_s"] for h in hist[-10:])
    rays = run.batcher.total_rays
    print(f"[12] train with objects (nuscenes_single, synth_nusc, "
          f"{cfg.model.num_objects} object slot(s), sem ids "
          f"{cfg.model.obj_sem_ids}, {rays} rays/step, {OBJ_STEPS} steps, "
          f"cold, init included): {entry_s:.2f} s; launches {launches}, on "
          f"the object grid {obj_launches}; warm {step_ms:.1f} ms/step "
          f"(median of the last 10; static [8] "
          f"{STATIC.get('ms_per_step', float('nan')):.1f}), "
          f"{rays / step_ms * 1e3:,.0f} rays/s; peak memory "
          f"{peak / 2**30:.2f} GiB (static [8] "
          f"{STATIC.get('peak_gib', float('nan')):.2f}); obj_hit_frac "
          f"{min(hit):.4f} .. {max(hit):.4f}, obj_overflow {max(overflow)}; "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")

    # Kernels on vs off, 2 steps from the same weights, optimizer state,
    # batches and random draws, under [8]'s rules. Without obj_nodecay
    # here (the recipe keeps it on), so that K3 sums the object table's
    # hash decay inside a step too.
    cfg = dataclasses.replace(cfg, obj_nodecay=False)
    model_p = copy.deepcopy(run.model)
    tracknet_p = copy.deepcopy(run.tracknet)
    posenet_p = copy.deepcopy(run.posenet)
    opt_p = train_step.make_optimizer(model_p, cfg, posenet_p, tracknet_p)
    # A deep copy: load_state_dict keeps the very moment tensors it is
    # given, which both optimizers would then update.
    opt_p.load_state_dict(copy.deepcopy(run.optimizer.state_dict()))
    batches = [cli.to_device(run.batcher.next(), dev) for _ in range(2)]
    gens = [torch.Generator(device=dev).manual_seed(98) for _ in range(2)]
    decay_ref = hash_decay_f64(run.model, cfg)
    refine = dict(tracks=run.tracks, track_mask=run.track_mask)
    worst_loss, step_obj = 0.0, {}
    for i, batch in enumerate(batches):
        step = OBJ_STEPS + i
        with (recording_all(grid, "hash_encode_multisample_bwd", run.model)
              if i == 0 else contextlib.nullcontext({})) as seen_on, \
                obj_grid_launches(spec) as counts:
            on = train_step.train_step(
                run.model, run.optimizer, cfg, batch, step,
                run.batcher.num_patch_rays, gens[0], posenet=run.posenet,
                tracknet=run.tracknet, **refine)
            torch.cuda.synchronize()
        seen_on = calls_to_host(seen_on)
        step_obj = {k: step_obj.get(k, 0) + v for k, v in counts.items()}
        with (recording_plain_encode(model_p) if i == 0
              else contextlib.nullcontext({})) as seen_off:
            off = train_step.train_step(
                model_p, opt_p, cfg, batch, step, run.batcher.num_patch_rays,
                gens[1], use_kernels=False, posenet=posenet_p,
                tracknet=tracknet_p, **refine)
            torch.cuda.synchronize()
        a, b = float(on["loss"]), float(off["loss"])
        worst_loss = max(worst_loss, abs(a - b) / abs(b))
        if abs(a - b) > LOSS_TOL * abs(b):
            fail(f"objects train step {step}: loss kernels {a} vs plain {b}")
        if i > 0:
            continue
        what = f"objects train step {step}, kernels on vs off"
        grad_err = _grads_close(run.model, model_p, what, step_table_bounds(
            run.model, cfg, seen_on, seen_off, what))
        refiner_err = {}
        for (name, p), q in zip(run.tracknet.named_parameters(),
                                tracknet_p.parameters()):
            scale = float(q.grad.abs().max())
            err = float((p.grad - q.grad).abs().max())
            if scale == 0 or err > GRAD_TOL * scale:
                fail(f"{what}: tracknet {name} gradient differs by {err} "
                     f"against max |grad| {scale} (tolerance {GRAD_TOL})")
            refiner_err[name] = err / scale
        decay = abs(float(on["hash_decay"]) - decay_ref) / decay_ref
        if not decay <= HASH_DECAY_TOL:
            fail(f"{what}: hash decay (K3, object table included) "
                 f"{float(on['hash_decay'])} vs {decay_ref} in float64")
        # The object grid's backward call, for H1 / H1-bwd below.
        bwd_rec = seen_on[next(k for k in seen_on if k.startswith("obj"))][0]
        del seen_on, seen_off
    if step_obj["scatter_add_rows"] == 0:
        fail("objects train steps without obj_nodecay: K3 was not launched "
             "on the object table")
    print(f"[12] 2 steps kernels on vs off (obj_nodecay off): loss rel diff "
          f"{worst_loss:.2e} (tol {LOSS_TOL}); first step's gradients: MLPs "
          f"and obj_latents, worst relative to max {grad_err[0]:.2e} "
          f"({grad_err[1]}; tol {GRAD_TOL}); tracknet {refiner_err}; hash "
          f"tables, float32 eps of the terms beyond the upstream difference "
          f"{ {k: round(v, 2) for k, v in grad_err[2].items()} } (tol "
          f"{TABLE_GRAD_EPS_MULT}); hash decay vs float64 {decay:.2e}; "
          f"launches on the object grid in the 2 kernel steps {step_obj}")
    params = run.params
    del model_p, opt_p, tracknet_p, posenet_p, batches
    torch.cuda.empty_cache()

    # render_lidar from the trained params, with the car and without.
    renders = {}
    for mode in ("replay", "removal"):
        render_fused.fused_composite.launches = 0
        grid.hash_encode_multisample.launches = 0
        with kernels_checked() as rec, box_hits() as hits, \
                obj_grid_launches(spec) as obj_counts:
            rr = cli.main([*OBJ_RENDER_ARGV, "--obj_mode", mode,
                           "--params", params])
        counts = dict(composite=render_fused.fused_composite.launches,
                      hash_encode_ms=grid.hash_encode_multisample.launches)
        for name, count in counts.items():
            if count == 0:
                fail(f"render_lidar --obj_mode {mode}: {name} was not "
                     "launched")
        renders[mode] = dict(run=rr, files=sweep_files(rr), launches=counts,
                             obj=obj_counts["hash_encode_ms"], hits=hits,
                             k1=max(rec["k1"]), h1=max(rec["h1"]),
                             calls=(len(rec["k1"]), len(rec["h1"])))
    rep, rem = renders["replay"], renders["removal"]
    if rep["obj"] == 0 or rem["obj"] != 0 or rem["hits"]:
        fail(f"render_lidar: object-grid encodes replay {rep['obj']}, "
             f"removal {rem['obj']}")
    n = rep["run"].sweeps[0].num_rays
    levels = rep["run"].cfg.model.num_levels
    in_box = rays_in_a_box(rep["hits"], levels, n)
    if not in_box.any():
        fail("render_lidar --obj_mode replay: no ray has a sample in a box")
    free = ~in_box
    errs = compare_sweeps(
        "objects replay vs removal, rays in no box",
        {k: v[free] for k, v in rep["files"].items()},
        {k: v[free] for k, v in rem["files"].items()})[0]
    moved = {k: float(np.abs(rep["files"][k][in_box]
                             - rem["files"][k][in_box]).max())
             for k in ("depth", "rgb", "semantic")}
    car = rep["files"]["semantic"][in_box].argmax(-1)
    # Warm s/sweep, with the car and without, kernels on.
    times = {}
    for mode, r in renders.items():
        rr = r["run"]
        sec = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            render_sweep(rr.renderer, rr.sweeps[0], rr.near, rr.far,
                         rr.frame, rr.tracks, rr.track_mask)
            torch.cuda.synchronize()
            sec.append(time.perf_counter() - t)
        times[mode] = (statistics.median(sec), sec)
    print(f"[12] render_lidar --mode replay from {params}: {n} rays; "
          f"launches replay {rep['launches']} (object grid "
          f"{rep['obj']}), removal {rem['launches']}; every K1 / H1 call vs "
          f"its plain version, max abs err replay {rep['k1']:.3e} / "
          f"{rep['h1']:.3e} ({rep['calls']} calls), removal "
          f"{rem['k1']:.3e} / {rem['h1']:.3e}; {int(in_box.sum())} rays "
          f"with a sample in a box (class ids there "
          f"{np.bincount(car).nonzero()[0].tolist()}), replay vs removal on "
          f"the {int(free.sum())} others: max abs diff {errs}, on the rays "
          f"in a box {moved}; warm s/sweep (median of 3) replay "
          f"{times['replay'][0]:.4f} {times['replay'][1]}, removal "
          f"{times['removal'][0]:.4f} {times['removal'][1]} (static [5] "
          f"{STATIC.get('s_per_sweep', float('nan')):.4f})")
    paths = dict(train_objects=launches, render_lidar_objects=rep["launches"])
    on_obj_grid = dict(train_objects=obj_launches,
                       render_lidar_objects=dict(hash_encode_ms=rep["obj"]))
    del renders, rep, rem

    def profiled():
        """What [12] times with torch.profiler, run after every timed phase
        ([13] included: a profiler session slows later host work): where a
        step with objects spends its time, and the kernels on the object
        grid alone (device time). Returns {kernel: numbers}."""
        nonlocal run
        prof = hb.profile_train(run, OBJ_STEPS + 2)
        print(f"[12] profile of 2 warm train steps with objects: "
              f"{json.dumps(prof)}")
        del run
        torch.cuda.empty_cache()
        obj_grid = dict(
            hash_encode_ms=obj_encode(dev, bwd_rec, fwd=True),
            hash_encode_ms_bwd=obj_encode(dev, bwd_rec, fwd=False),
            scatter_add_rows=obj_scatter(dev, spec))
        for name, nums in obj_grid.items():
            nums["launches_by_path"] = {p: c.get(name, 0)
                                        for p, c in on_obj_grid.items()}
        return obj_grid

    return dict(paths=paths, profiled=profiled)


def _rd_host_step(trainer, state, batch, shift, noise, dtype):
    """One ray-drop train step of a copy of `state` on the CPU in `dtype`,
    with the card trainer's loss networks: (stats, the copy's model)."""
    import torch
    from nerf_lidar_tpu_torch.raydrop.trainer import RayDropTrainer
    cpu = RayDropTrainer(trainer.cfg, device="cpu")
    cpu.vgg_model = copy.deepcopy(trainer.vgg_model).cpu().to(dtype)
    if trainer.dk_model is not None:
        cpu.dk_model = copy.deepcopy(trainer.dk_model).cpu().to(dtype)
    st = cpu.make_state(copy.deepcopy(state.model).cpu().to(dtype))
    stats = cpu.train_step(st, *(t.cpu().to(dtype) if t.is_floating_point()
                                 else t.cpu() for t in batch),
                           shift=shift, noise=noise.cpu().to(dtype))
    return stats, st.model, cpu


def _rd_step_vs_cpu(trainer, state, batch, shift, noise, dtype):
    """One train step from `state`'s weights on the card and on the CPU in
    `dtype` (same batch, roll shift and Gumbel noise; fresh Adam each):
    (loss rel diff, worst gradient error relative to its tensor's max and
    that tensor, worst BatchNorm buffer error relative to the buffer)."""
    import torch
    from nerf_lidar_tpu_torch.raydrop.trainer import RayDropTrainer
    card = RayDropTrainer(trainer.cfg, device=state.model.outc.weight.device)
    card.vgg_model = copy.deepcopy(trainer.vgg_model).to(dtype)
    card.dk_model = (None if trainer.dk_model is None
                     else copy.deepcopy(trainer.dk_model).to(dtype))
    st = card.make_state(copy.deepcopy(state.model).to(dtype))
    on = card.train_step(st, *(t.to(dtype) if t.is_floating_point() else t
                               for t in batch), shift=shift,
                         noise=noise.to(dtype))
    off, model_cpu, _ = _rd_host_step(trainer, state, batch, shift, noise,
                                      dtype)
    loss = abs(float(on["loss"]) - float(off["loss"])) / abs(
        float(off["loss"]))
    grad, grad_at = 0.0, ""
    for (name, p), q in zip(st.model.named_parameters(),
                            model_cpu.parameters()):
        scale = float(q.grad.abs().max())
        err = float((p.grad.cpu() - q.grad).abs().max()) / max(scale, 1e-30)
        if err > grad:
            grad, grad_at = err, name
    bn = 0.0
    for (name, a), b in zip(st.model.named_buffers(), model_cpu.buffers()):
        if name.endswith("num_batches_tracked"):
            continue
        err = (a.cpu() - b).abs() / b.abs().clamp(min=1e-3 * float(
            b.abs().max()))
        bn = max(bn, float(err.max()))
    del st, model_cpu, card
    return loss, grad, grad_at, bn


def phase_raydrop(dev):
    """[13] The ray-drop stage through the port's CLI: a synth_nusc scene
    with dense LiDAR, a field trained on it for RD_FIELD_STEPS steps and
    RD_SWEEPS replay sweeps rendered (the earlier slices' entries), then,
    with every kernel count at 0, raydrop_features, raydrop_train (VGG, 32 x
    1024, batch 4, RD_EPOCHS epochs: one eval), a short raydrop_train
    --darknet, raydrop_drop --place_car --features and raydrop_val_vis;
    checks their outputs and the card against the CPU from one set of
    weights; times a train step, a predict, and features / drop per sweep.
    Returns the kernel counts of the ray-drop path (none launches)."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.data import synth_nusc
    from nerf_lidar_tpu_torch.lidar import export
    from nerf_lidar_tpu_torch.ops import grid, render_fused
    from nerf_lidar_tpu_torch.raydrop import features as feat_lib
    from nerf_lidar_tpu_torch.raydrop import infer

    shutil.rmtree(os.path.join("exp", RD_EXP), ignore_errors=True)
    for sub in ("unet", "darknet"):
        shutil.rmtree(os.path.join("exp", f"{RD_EXP}_{sub}"),
                      ignore_errors=True)
    t0 = time.perf_counter()
    synth_nusc.write_scene_dir(RD_SCENE, num_frames=RD_SWEEPS, sensor_num=1,
                               lidar_points_per_beam=1100)
    field = cli.main(["train", *RD_FIELD_ARGV, "--steps",
                      str(RD_FIELD_STEPS), "--set", "print_every=20"])
    render = cli.main(["render_lidar", *RD_FIELD_ARGV, *RD_RENDER_ARGS,
                       "--params", field.params])
    torch.cuda.synchronize()
    sim_dir = render.sweep_dir
    print(f"[13] dense synth_nusc scene ({RD_SWEEPS} frames, 1,100 returns "
          f"per beam), field trained {RD_FIELD_STEPS} steps (loss "
          f"{field.history[0]['loss']:.4f} -> "
          f"{field.history[-1]['loss']:.4f}), {len(render.paths)} replay "
          f"sweeps of {render.sweeps[0].num_rays} rays: "
          f"{time.perf_counter() - t0:.1f} s")
    del field, render
    torch.cuda.empty_cache()

    counters = dict(composite=render_fused.fused_composite,
                    hash_encode_ms=grid.hash_encode_multisample,
                    hash_encode_ms_bwd=grid.hash_encode_multisample_bwd,
                    scatter_add_rows=grid.scatter_add_rows)
    for fn in counters.values():
        fn.launches = 0
    feats_path = os.path.join("exp", RD_EXP, "features.npy")
    t0 = time.perf_counter()
    data = cli.main(["raydrop_features", "--pair", f"{RD_SCENE}:{sim_dir}",
                     "--out", feats_path])
    feat_s = (time.perf_counter() - t0) / RD_SWEEPS
    n = data["images"].shape[0]
    if data["images"].shape != (RD_SWEEPS, 32, 1024, 6) or \
            data["masks"].shape != (n, 32, 1024) or \
            not np.isfinite(data["images"]).all():
        fail(f"raydrop_features: images {data['images'].shape}, masks "
             f"{data['masks'].shape}")
    keep_rate = float(data["masks"].mean())
    if not 0.05 < keep_rate < 1.0:
        fail(f"raydrop_features: ground-truth keep rate {keep_rate}")

    # Peak memory above what earlier phases still hold.
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    rd = cli.main(["raydrop_train", "--features", feats_path, "--exp_name",
                   f"{RD_EXP}_unet", "--epochs", str(RD_EPOCHS),
                   "--batch_size", "4", *RD_DEVICE])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_vgg = torch.cuda.max_memory_allocated(dev) - held
    hist = rd.history
    if not all(np.isfinite(h["loss"]) for h in hist) or \
            not hist[-1]["ce"] < hist[0]["ce"] or "val_ce" not in hist[-1] \
            or "vgg" not in hist[0]:
        fail(f"raydrop_train: CE {[round(h['ce'], 4) for h in hist]}, "
             f"val_ce in the last epoch: {'val_ce' in hist[-1]}")
    ckpt = os.path.join(rd.out, f"raydrop_{rd.state.step:05d}.pt")
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    dk = cli.main(["raydrop_train", "--features", feats_path, "--exp_name",
                   f"{RD_EXP}_darknet", "--epochs", "1", "--batch_size", "4",
                   "--darknet", *RD_DEVICE])
    torch.cuda.synchronize()
    peak_dk = torch.cuda.max_memory_allocated(dev) - held
    if not all(np.isfinite(h["darknet"]) and h["darknet"] > 0
               for h in dk.history):
        fail(f"raydrop_train --darknet: {dk.history}")

    kitti = os.path.join("exp", RD_EXP, "kitti")
    t0 = time.perf_counter()
    drop = cli.main(["raydrop_drop", "--ckpt", ckpt, "--simulation_path",
                     sim_dir, "--out", kitti, "--place_car", "--features",
                     feats_path, *RD_DEVICE])
    drop_cli_s = (time.perf_counter() - t0) / RD_SWEEPS
    vis = cli.main(["raydrop_val_vis", "--features", feats_path, "--ckpt",
                    ckpt, "--out", os.path.join("exp", RD_EXP, "val_vis"),
                    *RD_DEVICE])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    if any(launches.values()):
        fail(f"the ray-drop path launched a kernel of the table: {launches}")

    # The export, read back: sweep 0 against drop_sweep on the same input.
    sweeps, l2g = feat_lib.load_sim_sweep_dir(sim_dir)
    sweeps = [(feat_lib.world_points_to_sensor(p, l2g[i]), s_, r)
              for i, (p, s_, r) in enumerate(sweeps)]
    trainer, state = drop.trainer, drop.state
    ref = infer.drop_sweep(trainer, state, *sweeps[0], car_median_rule=True)
    b = export.read_bin(os.path.join(kitti, "velodyne", "000000.bin"))
    lab = export.read_label(os.path.join(kitti, "labels", "000000.label"))
    if not len(b) == len(lab) == len(ref["points"]) > 0 or \
            not np.array_equal(b[:, :3], ref["points"]) or \
            not np.array_equal(lab, ref["labels"].astype(np.uint32)):
        fail(f"raydrop_drop: velodyne/000000.bin {b.shape}, labels "
             f"{lab.shape}, drop_sweep {ref['points'].shape}")
    if not b[:, 2].min() < -0.5:
        fail(f"raydrop_drop: lowest exported point at z = {b[:, 2].min()} "
             "in the sensor frame (ground returns lie below the sensor)")
    l2e = np.load(os.path.join(kitti, "lidar2egos.npy"))
    e2g = np.load(os.path.join(kitti, "ego2globals.npy"))
    if l2e.shape != (n, 4, 4) or e2g.shape != (n, 4, 4) or \
            drop.summary["sweeps"] != n:
        fail(f"raydrop_drop: sensor metadata {l2e.shape} {e2g.shape}")
    if not vis["frames"] or not os.path.exists(os.path.join(
            "exp", RD_EXP, "val_vis", f"pred_{vis['frames'][0]:04d}.obj")):
        fail(f"raydrop_val_vis: frames {vis['frames']}")
    print(f"[13] ray-drop path (features -> train -> drop -> export) "
          f"launches of the table's kernels: {launches}")
    print(f"[13] raydrop_features: {tuple(data['images'].shape)} images, "
          f"ground-truth keep rate {keep_rate:.4f}; raydrop_train (VGG, "
          f"batch 4, {len(hist)} epochs, {rd.state.step} steps): "
          f"{train_s:.1f} s, CE {hist[0]['ce']:.4f} -> {hist[-1]['ce']:.4f}, "
          f"val_ce {hist[-1]['val_ce']:.4f}; --darknet {dk.state.step} "
          f"steps, darknet term {dk.history[0]['darknet']:.4f} -> "
          f"{dk.history[-1]['darknet']:.4f}; raydrop_drop: "
          f"{drop.summary['points_per_sweep']:.0f} points/sweep, iou "
          f"{drop.summary['iou']:.4f}, precision "
          f"{drop.summary['precision']:.4f}, recall "
          f"{drop.summary['recall']:.4f}; sweep 0 read back: {len(b)} "
          f"points, lowest z {b[:, 2].min():.2f} m; val_vis frames "
          f"{vis['frames']} acc {vis['acc_mean']:.4f}")

    # The card against the CPU, from the trained weights.
    frame = data["images"][:1]
    logits = {}
    with torch.no_grad():
        state.model.eval()
        from nerf_lidar_tpu_torch.raydrop.trainer import to_nchw
        logits["card"] = state.model(to_nchw(frame, dev)).cpu()
        cpu_model = copy.deepcopy(state.model).cpu().eval()
        logits["cpu"] = cpu_model(to_nchw(frame, "cpu"))
    logit_err = rel_err("[13] U-Net eval logits, card vs CPU",
                        logits["card"], logits["cpu"], RD_LOGIT_TOL)[1]
    from nerf_lidar_tpu_torch.raydrop.trainer import RayDropTrainer
    cpu_trainer = RayDropTrainer(trainer.cfg, device="cpu")
    cpu_state = cpu_trainer.make_state(cpu_model)
    card_out = infer.drop_sweep(trainer, state, *sweeps[0])
    cpu_out = infer.drop_sweep(cpu_trainer, cpu_state, *sweeps[0])
    safe = np.abs(cpu_out["keep_prob"] - 0.5) > RD_KEEP_MARGIN
    prob_err = float(np.abs(card_out["keep_prob"]
                            - cpu_out["keep_prob"]).max())
    if not np.array_equal(card_out["keep_mask"][safe],
                          cpu_out["keep_mask"][safe]):
        fail("[13] keep mask, card vs CPU, differs where the CPU's "
             "probability is farther than 1e-4 from 0.5")
    vgg_trainer = rd.trainer
    g = torch.Generator().manual_seed(13)
    idx = np.arange(4) % n
    batch = vgg_trainer.batch(data["images"], data["masks"],
                               data["ranges"], idx)
    shift = int(torch.randint(0, 1024, (), generator=g))
    noise = -torch.empty(4, 2, 32, 1024).exponential_(generator=g).log()
    step_err = {}
    for dtype, rows in ((torch.float64, 2), (torch.float32, 4)):
        sub = tuple(t[:rows] for t in batch)
        step_err[dtype] = _rd_step_vs_cpu(vgg_trainer, rd.state, sub, shift,
                                          noise[:rows].to(dev), dtype)
    loss64, grad64, at64, bn64 = step_err[torch.float64]
    if not (loss64 <= RD_LOSS_TOL and grad64 <= RD_GRAD_TOL
            and bn64 <= RD_BN_TOL):
        fail(f"[13] train step in float64, card vs CPU: loss {loss64}, "
             f"gradients {grad64} ({at64}), BatchNorm buffers {bn64}")
    loss32, grad32, at32, bn32 = step_err[torch.float32]
    if not loss32 <= RD_LOSS_TOL:
        fail(f"[13] train step in float32, card vs CPU: loss {loss32}")
    print(f"[13] card vs CPU (TF32 off): eval logits on one frame "
          f"{logit_err:.2e} of max (tol {RD_LOGIT_TOL}); keep probability "
          f"max abs diff {prob_err:.2e}, keep mask equal on the "
          f"{int(safe.sum())} of {safe.size} pixels farther than "
          f"{RD_KEEP_MARGIN} from 0.5; one train step (VGG on, same batch, "
          f"roll shift {shift}, Gumbel noise) in float64, batch 2: loss "
          f"{loss64:.2e} (tol {RD_LOSS_TOL}), gradients {grad64:.2e} of max "
          f"({at64}; tol {RD_GRAD_TOL}), BatchNorm buffers {bn64:.2e} (tol "
          f"{RD_BN_TOL}); in float32, batch 4: loss {loss32:.2e}, gradients "
          f"{grad32:.2e} of max ({at32}), BatchNorm buffers {bn32:.2e}")

    # Times on the card: a train step (VGG; VGG + Darknet), a predict.
    def step_ms(tr, st):
        b4 = tr.batch(data["images"], data["masks"], data["ranges"], idx)
        gen = torch.Generator().manual_seed(1)
        ng = torch.Generator(device=dev).manual_seed(2)
        sec = []
        for i in range(13):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.train_step(st, *b4, generator=gen, noise_generator=ng)
            torch.cuda.synchronize()
            if i >= 3:
                sec.append(1e3 * (time.perf_counter() - t))
        return statistics.median(sec), min(sec)

    vgg_ms = step_ms(vgg_trainer, rd.state)
    dk_ms = step_ms(dk.trainer, dk.state)
    pred = []
    for i in range(13):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.predict_prob(state, frame)
        torch.cuda.synchronize()
        if i >= 3:
            pred.append(1e3 * (time.perf_counter() - t))
    drop_s = []
    for sw in sweeps:
        t = time.perf_counter()
        infer.drop_sweep(trainer, state, *sw, car_median_rule=True)
        drop_s.append(time.perf_counter() - t)
    print(f"[13] times on the card: raydrop_train step (batch 4, 32 x 1024) "
          f"with VGG {vgg_ms[0]:.1f} ms (median of 10; min {vgg_ms[1]:.1f}), "
          f"with VGG + Darknet {dk_ms[0]:.1f} ms (min {dk_ms[1]:.1f}); "
          f"predict_prob on one sweep {statistics.median(pred):.2f} ms "
          f"(median of 10, host copies included); raydrop_features "
          f"{feat_s:.3f} s/sweep (host); drop_sweep "
          f"{statistics.median(drop_s):.3f} s/sweep (median of "
          f"{len(drop_s)}; host projection, depth filter and predict), "
          f"raydrop_drop entry {drop_cli_s:.3f} s/sweep (export and the "
          f"--features evaluation included); peak memory training (above what "
          f"earlier phases hold) with VGG "
          f"{peak_vgg / 2**30:.2f} GiB, with VGG + Darknet "
          f"{peak_dk / 2**30:.2f} GiB")
    del rd, dk, drop, trainer, state, vgg_trainer, cpu_model, cpu_state
    torch.cuda.empty_cache()
    return launches


def obj_encode(dev, rec, fwd):
    """H1 (fwd) or H1-bwd (d_table and d_x01) on the object grid at a train
    step's recorded backward call `rec` (table, x01, stds, g_out, spec,
    needs; n = 1, stds 0), against its plain version (the backward also
    against plain autograd through the plain encode), with the kernel's
    device ms in both block orders in turns (the one `grid.level_major`
    picks, the other, the other, the picked), the plain version's and the
    bound. Returns its kernels-line numbers."""
    import torch
    from nerf_lidar_tpu_torch.experiments import hash_encode_bench as hb
    from nerf_lidar_tpu_torch.ops import grid
    table, x01, stds, g_out = (t.to(dev) for t in rec[:4])
    spec, needs = rec[4], rec[5]
    n = stds.shape[-1]
    b = stds.numel() // n
    if n != 1 or bool(stds.any()) or not needs[1]:
        fail(f"object grid's encode: n = {n}, stds max "
             f"{float(stds.abs().max())}, needs {needs} (expected n = 1, "
             "stds 0 and d_x01)")
    if fwd:
        name = "hash_encode_ms"
        call = lambda: grid.hash_encode_multisample(table, x01, stds, spec)
        plain = lambda: grid.hash_encode_multisample_plain(table, x01, stds,
                                                           spec)[0]
        err = close(f"{name} object grid", call(), plain(), 1e-5, 1e-6)
        errs = dict(features=err)
        lim = bound(*hb.fwd_bound(spec, x01, stds))
    else:
        name, asked = "hash_encode_ms_bwd", (True, True, False)
        call = lambda: grid.hash_encode_multisample_bwd(
            table, x01, stds, g_out, spec, needs=asked)
        plain = lambda: grid.hash_encode_multisample_bwd_plain(
            table, x01, stds, g_out, spec, needs=asked)
        got, twin = call(), plain()
        leaves = [t.clone().requires_grad_(True) for t in (table, x01)]
        auto = torch.autograd.grad(grid.hash_encode_multisample_plain(
            *leaves, stds, spec)[0], leaves, g_out)
        errs = {}
        for i, key in enumerate(("d_table", "d_x01")):
            for what, want in (("twin", twin[i]), ("autograd", auto[i])):
                errs[f"{key} vs {what}"] = rel_err(
                    f"{name} object grid {key} vs {what}", got[i], want,
                    BWD_TOL)
        err = errs["d_table vs twin"][0]
        lim = bound(*hb.bwd_bound(spec, x01, stds, g_out))
    order = {"picked": [], "other": []}
    for turn in ("picked", "other", "other", "picked"):
        with (hb.other_order(grid) if turn == "other"
              else contextlib.nullcontext()):
            order[turn].append(device_ms(call))
    plain_ms = device_ms(plain, iters=5)
    picked = ("level-major" if grid.level_major(spec, grid._l2_bytes(
        dev.index)) else "side by side")
    ms = statistics.fmean(order["picked"])
    print(f"[12] {name} on the object grid ({spec.num_levels} levels x "
          f"C{spec.level_dim}, {spec.total_rows} rows, one train step's "
          f"B={b} n=1 stds=0): vs plain {errs}; device ms kernel "
          f"{order['picked']} ({picked}, picked), {order['other']} (the "
          f"other order), plain {plain_ms:.4f}; bound {lim['bound_ms']:.5f} "
          f"ms ({lim['bound_by']})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **lim, block_order=picked,
                other_order_ms=statistics.fmean(order["other"]),
                inputs=f"object grid, one train step's B={b} points, n=1")


def obj_scatter(dev, spec):
    """K3 at the object table's hash-decay level sums (table uniform(-1,
    1)) vs float64, with kernel, plain (index_add_ in float32) and
    index_add_ device ms beside the bound. Returns its kernels-line
    numbers."""
    import torch
    from nerf_lidar_tpu_torch.ops import grid
    g = torch.Generator(device=dev).manual_seed(12)
    table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                       generator=g) * 2 - 1
    ids, vals, rows = grid.level_ids(spec, dev), table**2, spec.num_levels
    got = grid.scatter_add_rows(ids, vals, rows)
    want = grid.scatter_add_rows_plain(ids, vals.double(), rows)
    err, rel = rel_err("scatter_add_rows hash decay object grid",
                       got.double(), want, PATH_SCATTER_TOL)
    ms = device_ms(lambda: grid.scatter_add_rows(ids, vals, rows))
    plain_ms = device_ms(lambda: grid.scatter_add_rows_plain(ids, vals, rows),
                         iters=5)
    ids64 = ids.long()
    library_ms = device_ms(lambda: vals.new_zeros(rows, spec.level_dim)
                           .index_add_(0, ids64, vals), iters=5)
    lim = bound(nbytes(ids, vals, got), vals.numel())
    print(f"[12] scatter_add_rows hash decay on the object grid: "
          f"N={spec.total_rows} rows onto {rows} C={spec.level_dim}: max abs "
          f"err {err:.3e} ({rel:.2e} of max, float64); device ms: kernel "
          f"{ms:.4f}, plain {plain_ms:.4f}, index_add_ alone "
          f"{library_ms:.4f}; bound {lim['bound_ms']:.4f} ms "
          f"({lim['bound_by']})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, **lim,
                inputs="object grid's hash-decay level sums")


def _bad_indices(idx, size, g):
    """idx's shape, values in [-2 size, 2 size) (wrapped, in range and NaN
    cases) and the int32 extremes, -size, size and -1 in its first cells."""
    import torch
    bad = torch.randint(-2 * size, 2 * size, idx.shape, device=idx.device,
                        generator=g, dtype=torch.int32)
    flat = bad.view(-1)
    flat[:5] = torch.tensor([-2**31, 2**31 - 1, -size, size, -1],
                            dtype=torch.int32)
    return bad


def phase_gathers(dev):
    """K2, K4's five forms and K5 vs their plain versions, exactly, at the
    TPU kernels' shapes, on in-range and on negative / out-of-range
    indices; device times of kernel, plain version and library call, and
    the bound. Returns {"K2" | "K4" | "K5": numbers of its kernels line};
    K4's are the sums over its forms 2-5 (form 1 is K2), each beside."""
    import torch
    from nerf_lidar_tpu_torch.experiments import gather_bench
    from nerf_lidar_tpu_torch.ops import tile_gather as tg

    g = torch.Generator(device=dev).manual_seed(10)
    forms = gather_bench.mosaic_forms(dev)
    k5 = "K5 (8,128) x 1024 tiles"
    forms[k5] = (tg.tile_grid_gather, tg.tile_grid_gather_plain, (
        torch.randn(8, 128, device=dev, generator=g),
        torch.randint(0, 128, (1024, 8, 128), device=dev, generator=g,
                      dtype=torch.int32)))
    # take_rows above the card's launch floor: the gather bench's row
    # gather (the finest hash level's 2^19 rows x 16 channels, 2^20
    # indices).
    big = "take rows (2^19,16)<-2^20"
    forms[big] = (tg.take_rows, tg.take_rows_plain, (
        torch.randn(2**19, 16, device=dev, generator=g),
        torch.randint(0, 2**19, (2**20,), device=dev, generator=g,
                      dtype=torch.int32)))
    result = {}
    for name, (fn, plain, args) in forms.items():
        tbl, idx, rest = args[0], args[1], args[2:]
        rows = fn is tg.take_rows
        axis = 0 if rows else (rest[0] if rest else 1)
        size = tbl.shape[axis]
        nan_share = 0.0
        for case in (idx, _bad_indices(idx, size, g)):
            got, want = fn(tbl, case, *rest), plain(tbl, case, *rest)
            torch.cuda.synchronize()
            if not tg.same_values(got, want):
                fail(f"gather {name}: the kernel differs from its plain "
                     f"version (indices in [{int(case.min())}, "
                     f"{int(case.max())}])")
            nan_share = float(got.isnan().float().mean())
        if not 0 < nan_share < 1:
            fail(f"gather {name}: the out-of-range case gave NaN share "
                 f"{nan_share}")
        idx64 = idx.long()
        if rows:
            library = lambda: tbl.index_select(0, idx)
            read = int(torch.unique(idx64).numel()) * tbl.shape[1]
        else:
            src = tbl if idx.dim() == 2 else tbl[None]
            library = lambda: torch.take_along_dim(src, idx64, dim=axis - 2)
            lanes = torch.arange(idx.shape[-2 + (1 - axis)], device=dev)
            lanes = lanes[:, None] if axis == 1 else lanes[None, :]
            flat = (lanes * tbl.shape[1] + idx64 if axis == 1
                    else idx64 * tbl.shape[1] + lanes)
            read = int(torch.unique(flat).numel())
        out = fn(tbl, idx, *rest)
        if not tg.same_values(library(), out):
            fail(f"gather {name}: the library call differs from the kernel")
        # Kernel and library call in turns (kernel, library, library,
        # kernel), 50 calls each: at the card's launch floor they move by
        # more between runs than they differ.
        kern = lambda: fn(tbl, idx, *rest)
        turns = [device_ms(f) for f in (kern, library, library, kern)]
        # Bound: the indices read, the output written, and the distinct
        # table entries the indices touch; no arithmetic.
        nums = dict(max_abs_err=0.0, ms=(turns[0] + turns[3]) / 2,
                    plain_ms=device_ms(lambda: plain(tbl, idx, *rest)),
                    library_ms=(turns[1] + turns[2]) / 2, turns=turns,
                    **bound(nbytes(idx, out) + 4 * read, 0))
        print(f"[10] {fn.__name__} {name}: idx {tuple(idx.shape)}, exact on "
              f"in-range and on out-of-range indices (NaN share "
              f"{nan_share:.3f}); device ms: kernel {nums['ms']:.5f}, plain "
              f"{nums['plain_ms']:.5f}, library {nums['library_ms']:.5f} "
              f"(kernel, library, library, kernel: {turns}); bound "
              f"{nums['bound_ms']:.6f} ({nums['bound_by']})")
        result[name] = nums
    # The card's launch floor: the device time of an empty kernel (one
    # block of 32 threads), which no launch beats (K2's bound is below it).
    from nerf_lidar_tpu_torch.ops import _build
    floor_ms = device_ms(lambda: _build.launch_empty(dev))
    print(f"[10] launch floor: an empty kernel takes {floor_ms:.5f} ms of "
          f"device time")
    k2 = "take_along_axis (8,128)"
    k4 = {k: v for k, v in result.items() if k not in (k2, k5, big)}
    sums = {key: sum(v[key] for v in k4.values())
            for key in ("max_abs_err", "ms", "plain_ms", "library_ms",
                        "bound_ms")}
    return {"K2": dict(result[k2], shape=k2, launch_floor_ms=floor_ms),
            "K4": dict(sums, bound_by="bytes", forms=k4,
                       take_rows_2e19x16_from_2e20=result[big]),
            "K5": dict(result[k5], shape=k5)}


BENCH_RATE_PROBES = 17
BENCH_FORMS = 5


def phase_gather_bench(dev):
    """The port's gather-bench entry at the JAX bench's sizes. Returns the
    launch counts of its run, by kernels-line entry."""
    import math
    from nerf_lidar_tpu_torch.experiments import gather_bench
    from nerf_lidar_tpu_torch.ops import tile_gather as tg

    counters = dict(tile_lane_gather=tg.tile_lane_gather,
                    take_along_axis=tg.take_along_axis,
                    take_rows=tg.take_rows,
                    tile_grid_gather=tg.tile_grid_gather)
    for fn in counters.values():
        fn.launches = 0
    recs = gather_bench.main(["--device", "cuda"])
    launches = {k: fn.launches for k, fn in counters.items()}
    rates = [r for r in recs if "rate_M_per_s" in r]
    forms = [r for r in recs if "result" in r]
    if len(rates) != BENCH_RATE_PROBES or len(forms) != BENCH_FORMS \
            or any(r["result"] != "ok" for r in forms):
        fail(f"gather_bench: {len(rates)} rate lines (want "
             f"{BENCH_RATE_PROBES}), forms {forms}")
    if not all(math.isfinite(r["rate_M_per_s"]) and r["rate_M_per_s"] > 0
               for r in rates):
        fail(f"gather_bench: a rate is not finite and positive: {rates}")
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the gather-bench path")
    print(f"[11] gather_bench: {len(rates)} probes and {len(forms)} kernel "
          f"forms; launches {launches}")

    # The bench times 20 chained iterations of eager torch ops, so the host
    # may bound a probe. The device time of one call of its central row
    # gather and scatter-add at the hash grid's size (2^19 x 16), alone, by
    # CUDA events: each call keeps the device busy (0.04-0.6 ms) longer than
    # its launch takes, and torch.profiler sessions this late in the
    # process lose launches.
    import torch
    g = torch.Generator(device=dev).manual_seed(11)
    rows, c = 2**19, 16
    tbl = torch.randn(rows, c, device=dev, generator=g)
    idx = torch.randint(0, rows, (2**20,), device=dev, generator=g,
                        dtype=torch.int32)
    vals = torch.randn(2**18, c, device=dev, generator=g)
    lanes = tbl.T.contiguous()  # [C, R], the JAX production layout
    calls = {
        "gather_row N=2^20 (index_select dim 0)":
            (2**20, lambda: tbl.index_select(0, idx)),
        "gather_lane N=2^20 (index_select dim 1 of [C, R])":
            (2**20, lambda: lanes.index_select(1, idx)),
        "scatter_row N=2^18 (zeros + index_add_ dim 0)":
            (2**18, lambda: tbl.new_zeros(rows, c).index_add_(
                0, idx[:2**18], vals)),
    }
    for name, (n, fn) in calls.items():
        ms = cuda_ms(fn)
        print(f"[11] device time, R=2^19 C=16 {name}: {ms:.4f} ms, "
              f"{n / ms / 1e3:,.0f} M indices/s")
    return dict(tile_lane_gather=launches["tile_lane_gather"],
                mosaic_gather_forms=launches["take_along_axis"]
                + launches["take_rows"],
                tile_grid_gather=launches["tile_grid_gather"])


def main():
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(HERE, "nerf_lidar_tpu_torch")):
        fail(f"no nerf_lidar_tpu_torch package beside {__file__}: run it "
             "from a checkout of the repository")
    os.chdir(HERE)
    sys.path.insert(0, HERE)
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.ops import _build

    # [1] device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1] device: {kind}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # [2] build
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] built {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s")

    cfg = cli.build_config(cli.parse_args(SLICE_ARGV))
    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"    ({name}: {time.perf_counter() - t:.1f} s)")
        return out

    k1_err = timed("[3]", phase_composite, dev)
    render_launches, render_inputs = timed("[5]", phase_slice, dev)
    h1 = timed("[4]", phase_hash_encode, dev, cfg, render_inputs)
    del render_inputs
    train_launches, params, train_inputs = timed("[8]", phase_train, dev)
    objects = timed("[12]", phase_objects, dev)
    raydrop_launches = timed("[13]", phase_raydrop, dev)
    obj_grid = timed("[12] profiled", objects.pop("profiled"))
    h1_bwd = timed("[6]", phase_hash_encode_bwd, dev, cfg, train_inputs)
    del train_inputs
    k3_path, k3_own = timed("[7]", phase_scatter, dev, cfg)
    k1 = timed("[3] timing", time_composite, dev, k1_err)
    k1_trained = timed("[9]", phase_train_to_render, dev, params)
    gathers = timed("[10]", phase_gathers, dev)
    bench_launches = timed("[11]", phase_gather_bench, dev)
    barred = sorted(m for m in sys.modules
                    if m.split(".")[0] in MODULES_BARRED)
    if barred:
        fail(f"the port imported JAX or the JAX package: {barred[:10]}")

    # Launches per main path: the render entry's run [5], the train entry's
    # run [8], the gather bench's run [11], with dynamic objects [12]'s
    # train entry and its replay render, and [13]'s ray-drop path (features
    # to export, which launches none); `launches` is their sum.
    paths = (("render_lidar", render_launches), ("train", train_launches),
             ("gather_bench", bench_launches),
             *objects["paths"].items(), ("raydrop", raydrop_launches))

    def entry(name, source, replaces, inputs, nums, **extra):
        """`inputs`: what the top-level numbers were measured on."""
        by_path = {p: counts[name] for p, counts in paths if name in counts}
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=sum(by_path.values()),
                    launches_by_path=by_path, inputs=inputs, **nums, **extra)

    kernels = [
        # trained_chunk_*: on the inputs of [9]'s first render chunk.
        entry("composite", KERNEL_SOURCE,
              "nerf_lidar_tpu/ops/render_pallas.py:109",
              "seeded uniform, R=16384 S=32 K=19, opaque", k1, **k1_trained),
        # Every grid's numbers on the path's and on uniform points under
        # "grids".
        # obj_grid: on the object grid's points of one [12] train step
        # (the JAX `hash_encode`, n = 1 and stds 0), with its launches.
        entry("hash_encode_ms", KERNEL_SOURCE,
              "nerf_lidar_tpu/ops/grid.py:366",
              "NeRF grid, the first 16,384-ray chunk of a [5] sweep "
              "(uniform_*: uniform points of the same shape)", h1,
              obj_grid=obj_grid["hash_encode_ms"]),
        # Against the written-out twin; prop0 also vs autograd; obj_grid
        # d_table and d_x01 vs both.
        entry("hash_encode_ms_bwd", KERNEL_SOURCE,
              "nerf_lidar_tpu/ops/grid.py:366",
              "NeRF grid, d_table of one warm [8] train step (uniform_*: "
              "uniform points of the same shape)", h1_bwd,
              obj_grid=obj_grid["hash_encode_ms_bwd"]),
        # Every grid's hash-decay level sums under "grids", every own
        # shape under "own_shapes".
        entry("scatter_add_rows", KERNEL_SOURCE,
              "experiments/scatter_variants.py:81",
              "NeRF grid's hash-decay level sums (train path); K3's own "
              "shape beside", k3_path,
              k3_shape_rows131072_n4194304_c16=k3_own,
              obj_grid=obj_grid["scatter_add_rows"]),
        # K2, on the bench's path as K4's form 1 (which computes the same).
        entry("tile_lane_gather", GATHER_SOURCE,
              "nerf_lidar_tpu/ops/grid_pallas.py:51",
              "seeded indices, tbl [8, 128]", gathers["K2"]),
        # K4's forms 2-5 (wrappers take_along_axis and take_rows), summed;
        # take_rows at the gather bench's (2^19, 16) <- 2^20 beside.
        entry("mosaic_gather_forms", GATHER_SOURCE,
              "experiments/gather_bench.py:263",
              "seeded indices at the TPU kernel's four shapes, summed",
              gathers["K4"]),
        entry("tile_grid_gather", GATHER_SOURCE,
              "experiments/gather_bench.py:327",
              "seeded indices, tbl [8, 128], idx [1024, 8, 128]",
              gathers["K5"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
