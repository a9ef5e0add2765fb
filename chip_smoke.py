#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`nerf_lidar_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases (each raises on failure, so the script exits non-zero):
1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
2. build: compiles csrc/*.cu with nvcc (sm_90a) and loads the library;
3. K1 `composite` vs its plain torch version at the slice's chunk
   (R = 16,384, S = 32, K = 19; opaque on/off; ragged R = 700);
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
   onto one output row) and at K3's own shapes (rows 4,096 and 2^17, N 2^20
   and 2^22, C 16);
8. the port's `train` entry, in-process, in a fresh experiment directory,
   fits `nuscenes_single` on the synthetic scene at full width for 30 steps
   with the kernels on: finite losses, a non-zero gradient on every hash
   table, the launch counts of H1, its backward and K3, warm ms/step,
   rays/s and peak memory; records the encode backward's inputs of one more
   step (for [6]); then 3 steps kernels on vs off from the same
   weights, batches and randomness (every gradient and the hash-decay term
   of the first, the loss of each); then 100 steps at the full learning
   rate (no warm-up), where the data loss must fall;
9. train -> render: `render_lidar --params` renders one full sweep from the
   params_<step>.npz that [8] wrote, through K1 and H1;
10. the in-tile gathers (`ops/tile_gather.py`, `csrc/gather.cu`) at the TPU
   kernels' own shapes: K2 `tile_lane_gather` [8, 128], K4's other four
   forms (`take_along_axis` on (256, 128), (128, 128) axis 0 and (8, 2^15);
   `take_rows` (512, 128) <- 256) and K5 (`tile_grid_gather`, tbl [8, 128],
   idx [1024, 8, 128]), each exactly equal to its plain version, NaN
   positions included, on in-range indices and on negative and
   out-of-range ones; kernel, plain and library-call (`take_along_dim` /
   `index_select`) device times from torch.profiler, kernel and library
   call in turns (kernel, library, library, kernel; 50 calls each);
11. the port's gather-bench entry (`experiments/gather_bench.py`),
   in-process, at the JAX bench's sizes: every probe line prints, the K4
   forms pass, and the launch counts of that run; then the device time of
   one call of its row gather (both layouts) and row scatter-add at the
   hash grid's 2^19 x 16, without the bench's host loop.
The phases run in the order 1, 2, 3, 5, 4, 7, 8, 6, 9, 10, 11: [4] and [6]
time the encode on the inputs that [5] and [8] record. Then it fails if any
module of jax, jaxlib, flax, optax or the JAX package
(`nerf_lidar_tpu`, `nerf_lidar_tpu.*`) was imported. Prints the kernels'
JSON line (every kernel's launches on each path, times, and its bound: the
larger of its bytes over the card's memory rate and its operations over
its float32 rate; H1 and its backward per grid too), the nvidia-smi line,
then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

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
    count. Fails if three sessions record no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # A session now and then records no device activity at all on this
    # card's tracer: take another one, up to three in all.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    fail("torch.profiler recorded no device time in three sessions")


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


def phase_composite(dev):
    """K1 vs plain on the card. Returns the numbers of its kernels line at
    R = 16,384 (opaque, no intensity)."""
    import torch
    from nerf_lidar_tpu_torch.ops import render_fused

    tol = dict(weights=(1e-5, 1e-6), depth=(1e-4, 1e-5), acc=(1e-5, 1e-6),
               rgb=(1e-5, 1e-5), semantic=(1e-5, 1e-5),
               intensity=(1e-5, 1e-5))
    g = torch.Generator(device=dev).manual_seed(0)
    worst, timed = 0.0, None
    for r, opaque, with_int in ((16384, True, False), (16384, False, True),
                                (700, True, True)):
        s, k = 32, 19
        args = dict(
            density=torch.rand(r, s, device=dev, generator=g) * 3,
            tdist=torch.sort(torch.rand(r, s + 1, device=dev, generator=g)
                             * 5, dim=-1).values,
            dirs=torch.randn(r, 3, device=dev, generator=g),
            rgb=torch.rand(r, s, 3, device=dev, generator=g),
            semantic=torch.rand(r, s, k, device=dev, generator=g),
            intensity=(torch.rand(r, s, device=dev, generator=g)
                       if with_int else None),
            opaque_background=opaque, bg_value=1.0)
        got = render_fused.fused_composite(**args)
        want = render_fused.fused_composite_plain(**args)
        torch.cuda.synchronize()
        if set(got) != set(want):
            fail(f"composite outputs {sorted(got)} != {sorted(want)}")
        for key in want:
            worst = max(worst, close(f"composite R={r} opaque={opaque} {key}",
                                     got[key], want[key], *tol[key]))
        if timed is None:
            timed = args
    ms = cuda_ms(lambda: render_fused.fused_composite(**timed))
    plain_ms = cuda_ms(lambda: render_fused.fused_composite_plain(**timed))
    # Bound: every input read once, every output written once; operations,
    # the weighted sums of depth, rgb and semantics (2 per sample each).
    out = render_fused.fused_composite(**timed)
    r, s = timed["density"].shape
    k = timed["semantic"].shape[-1]
    lim = bound(nbytes(*(v for v in timed.values()
                         if isinstance(v, torch.Tensor)), *out.values()),
                2 * r * s * (4 + k))
    print(f"[3] composite vs plain: max abs err {worst:.3e}; "
          f"R=16384 S=32 K=19: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"bound {lim['bound_ms']:.4f} ms ({lim['bound_by']})")
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
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    u = {k: torch.from_numpy(v) for k, v in b.items()}
    errs = dict(depth=close("slice depth", t["depth"], u["depth"], 1e-3, 0),
                rgb=close("slice rgb", t["rgb"], u["rgb"], 0, 1e-4),
                semantic=close("slice semantic", t["semantic"],
                               u["semantic"], 0, 1e-4))
    spread = {k: float(v.std()) for k, v in t.items()
              if k in ("depth", "rgb", "semantic")}
    print(f"[5] kernels on vs off (uniform(-1, 1) tables), max abs diff "
          f"{errs}; std across rays of the kernels' render {spread}")
    return launches, render_inputs


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
    sums of each grid, table uniform(-1, 1)) and at K3's own. Returns the
    numbers of its kernels line for the NeRF grid's level sums, and the
    same at K3's rows 2^17, N 2^22."""
    import torch
    from nerf_lidar_tpu_torch.ops import grid

    g = torch.Generator(device=dev).manual_seed(7)
    path = None
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
        ms = cuda_ms(lambda: grid.scatter_add_rows(ids, vals, rows))
        plain_ms = cuda_ms(lambda: grid.scatter_add_rows_plain(ids, vals,
                                                               rows))
        line = (f"[7] scatter_add_rows hash decay {name}: N={spec.total_rows}"
                f" rows onto {rows} C={spec.level_dim}: max abs err "
                f"{err:.3e} ({rel:.2e} of max; index_add_ in float32 "
                f"{plain32:.2e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if path is None:
            ids64 = ids.long()
            library_ms = cuda_ms(lambda: vals.new_zeros(
                rows, spec.level_dim).index_add_(0, ids64, vals), iters=5,
                warmup=1)
            # Bound: idx and vals read, the sums written; one add a value.
            lim = bound(nbytes(ids, vals, got), vals.numel())
            path = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, **lim)
            line += (f", index_add_ alone {library_ms:.4f} ms; bound "
                     f"{lim['bound_ms']:.4f} ms ({lim['bound_by']})")
            del ids64
        print(line)
        del table, vals, got, want

    c, own = 16, None
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
            ms = cuda_ms(lambda: grid.scatter_add_rows(idx, vals, rows))
            plain_ms = cuda_ms(plain)
            print(f"[7] scatter_add_rows rows={rows} N={n} C={c}: max abs "
                  f"err {err:.3e} ({rel:.2e} of max); kernel {ms:.4f} ms, "
                  f"index_add_ {plain_ms:.4f} ms")
            own = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=plain_ms,
                       **bound(nbytes(idx, vals, got), vals.numel()))
    return path, own


def _table_grads_nonzero(model, what):
    for name, mlp in [("nerf", model.nerf_mlp)] + [
            (f"prop{i}", p) for i, p in enumerate(model.prop_mlps)]:
        grad = mlp.table.grad
        if grad is None or float(grad.abs().max()) == 0.0:
            fail(f"{what}: the {name} hash table got no gradient")


# Kernels on vs off, the first step from the same weights: every
# parameter's gradient relative to its largest value (a zero, wrong-sign
# or misplaced table gradient is off by 1 or more; summation order moves
# it by ~1e-5), and each step's loss (measured spread 1.5e-5 over 3 steps).
GRAD_TOL = 1e-3
LOSS_TOL = 1e-4
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
    for mlp in (model.nerf_mlp, *model.prop_mlps):
        spec, table = mlp.spec, mlp.table.detach().double()
        sums = torch.stack([table[o:o + r].square().sum(0) / r for o, r in
                            zip(spec.offsets, spec.rows_per_level)])
        total += float(sums.mean())
    return cfg.hash_decay_mults * total


def _grads_close(model, model_p, what):
    """Max over parameters of max |grad - grad_p| / max |grad_p|; fails
    above GRAD_TOL, on a non-finite gradient, or where one side has none."""
    import torch
    worst, where = 0.0, None
    for (name, p), q in zip(model.named_parameters(), model_p.parameters()):
        if (p.grad is None) != (q.grad is None):
            fail(f"{what}: {name} has a gradient on one side only")
        if p.grad is None:
            continue
        scale = float(q.grad.abs().max())
        err = float((p.grad - q.grad).abs().max())
        if not bool(torch.isfinite(p.grad).all()) or err > GRAD_TOL * scale:
            fail(f"{what}: {name} gradient differs by {err} against max "
                 f"|grad| {scale} (tolerance {GRAD_TOL} of it)")
        if scale > 0 and err / scale > worst:
            worst, where = err / scale, name
    return worst, where


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
    opt_p.load_state_dict(run.optimizer.state_dict())
    batches = [cli.to_device(run.batcher.next(), dev) for _ in range(3)]
    gens = [torch.Generator(device=dev).manual_seed(99) for _ in range(2)]
    decay_ref = hash_decay_f64(run.model, cfg)
    worst_loss = 0.0
    step_s = dict(on=[], off=[])
    torch.cuda.reset_peak_memory_stats(dev)
    for i, batch in enumerate(batches):
        step = TRAIN_STEPS + 1 + i
        t0 = time.perf_counter()
        on = train_step.train_step(run.model, run.optimizer, cfg, batch,
                                   step, run.batcher.num_patch_rays, gens[0])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
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
            grad_err = _grads_close(run.model, model_p,
                                    f"train step {step}, kernels on vs off")
            decay = [abs(float(stats["hash_decay"]) - decay_ref) / decay_ref
                     for stats in (on, off)]
            if not decay[0] <= HASH_DECAY_TOL:
                fail(f"train step {step}: hash decay (K3 on the path) "
                     f"{float(on['hash_decay'])} vs {decay_ref} in float64")
    _table_grads_nonzero(model_p, "kernels-off steps")
    med = {k: 1e3 * statistics.median(v) for k, v in step_s.items()}
    print(f"[8] 3 steps kernels on vs off: loss rel diff {worst_loss:.2e} "
          f"(tol {LOSS_TOL}); first step's gradients, worst relative to max "
          f"{grad_err[0]:.2e} ({grad_err[1]}; tol {GRAD_TOL}); hash decay vs "
          f"float64 slice sums, relative: K3 {decay[0]:.2e} (tol "
          f"{HASH_DECAY_TOL}), index_add_ {decay[1]:.2e}; ms/step (median "
          f"of 3, host clock, synchronised) kernels {med['on']:.1f} "
          f"({rays / med['on'] * 1e3:,.0f} rays/s), plain {med['off']:.1f} "
          f"({rays / med['off'] * 1e3:,.0f} rays/s); peak memory of the "
          f"two models and the plain steps "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    params = run.params
    del run, model_p, opt_p, batches
    torch.cuda.empty_cache()

    learn = cli.main(LEARN_ARGV)
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


def phase_train_to_render(dev, params):
    """render_lidar --params <the weights [8] trained>: one full sweep."""
    import numpy as np
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.ops import grid, render_fused

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
    k2 = "take_along_axis (8,128)"
    k4 = {k: v for k, v in result.items() if k not in (k2, k5)}
    sums = {key: sum(v[key] for v in k4.values())
            for key in ("max_abs_err", "ms", "plain_ms", "library_ms",
                        "bound_ms")}
    return {"K2": dict(result[k2], shape=k2),
            "K4": dict(sums, bound_by="bytes", forms=k4),
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
    # gather and scatter-add at the hash grid's size (2^19 x 16), alone:
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
        ms = device_ms(fn, iters=20)
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

    k1 = timed("[3]", phase_composite, dev)
    render_launches, render_inputs = timed("[5]", phase_slice, dev)
    h1 = timed("[4]", phase_hash_encode, dev, cfg, render_inputs)
    del render_inputs
    k3_path, k3_own = timed("[7]", phase_scatter, dev, cfg)
    train_launches, params, train_inputs = timed("[8]", phase_train, dev)
    h1_bwd = timed("[6]", phase_hash_encode_bwd, dev, cfg, train_inputs)
    del train_inputs
    timed("[9]", phase_train_to_render, dev, params)
    gathers = timed("[10]", phase_gathers, dev)
    bench_launches = timed("[11]", phase_gather_bench, dev)
    barred = sorted(m for m in sys.modules
                    if m.split(".")[0] in MODULES_BARRED)
    if barred:
        fail(f"the port imported JAX or the JAX package: {barred[:10]}")

    # Launches per main path: the render entry's run [5], the train entry's
    # run [8] and the gather bench's run [11]; `launches` is their sum.
    paths = (("render_lidar", render_launches), ("train", train_launches),
             ("gather_bench", bench_launches))

    def entry(name, source, replaces, inputs, nums, **extra):
        """`inputs`: what the top-level numbers were measured on."""
        by_path = {p: counts[name] for p, counts in paths if name in counts}
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=sum(by_path.values()),
                    launches_by_path=by_path, inputs=inputs, **nums, **extra)

    kernels = [
        entry("composite", KERNEL_SOURCE,
              "nerf_lidar_tpu/ops/render_pallas.py:109",
              "seeded uniform, R=16384 S=32 K=19, opaque", k1),
        # Every grid's numbers on the path's and on uniform points under
        # "grids".
        entry("hash_encode_ms", KERNEL_SOURCE,
              "nerf_lidar_tpu/ops/grid.py:366",
              "NeRF grid, the first 16,384-ray chunk of a [5] sweep "
              "(uniform_*: uniform points of the same shape)", h1),
        # Against the written-out twin; prop0 also vs autograd.
        entry("hash_encode_ms_bwd", KERNEL_SOURCE,
              "nerf_lidar_tpu/ops/grid.py:366",
              "NeRF grid, d_table of one warm [8] train step (uniform_*: "
              "uniform points of the same shape)", h1_bwd),
        entry("scatter_add_rows", KERNEL_SOURCE,
              "experiments/scatter_variants.py:81",
              "NeRF grid's hash-decay level sums (train path); K3's own "
              "shape beside", k3_path,
              k3_shape_rows131072_n4194304_c16=k3_own),
        # K2, on the bench's path as K4's form 1 (which computes the same).
        entry("tile_lane_gather", GATHER_SOURCE,
              "nerf_lidar_tpu/ops/grid_pallas.py:51",
              "seeded indices, tbl [8, 128]", gathers["K2"]),
        # K4's forms 2-5 (wrappers take_along_axis and take_rows), summed.
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
