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
   samples), n = 7 multisamples, with out-of-range points;
5. the slice: the port's `render_lidar` entry, in-process, renders two
   full 35,200-ray sweeps of `nuscenes_single` at full width (seeded fresh
   weights) with the kernels on; checks the files and values and counts the
   kernel launches of that run; times one sweep kernels on and off
   (`use_kernels=False`); then gives every hash table seeded uniform(-1, 1)
   values, so that the encode moves density, colour and the resampling,
   and compares the kernels-on render with the kernels-off one;
6. the H1 backward `hash_encode_ms_bwd` at the train step's shapes (20,480
   rays x 32 NeRF or 64 proposal samples, n = 7) vs its written-out plain
   twin (`index_add_`) on every grid: d_table, and d_x01 / d_stds on the
   smallest proposal grid, where it is also held against plain autograd
   through the plain encode;
7. K3 `scatter_add_rows` vs `index_add_` at the shapes the train path gives
   it (the hash-decay level sums of the three grids: every row of a level
   onto one output row) and at K3's own shapes (rows 4,096 and 2^17, N 2^20
   and 2^22, C 16);
8. the port's `train` entry, in-process, in a fresh experiment directory,
   fits `nuscenes_single` on the synthetic scene at full width for 30 steps
   with the kernels on: finite losses, a non-zero gradient on every hash
   table, the launch counts of H1, its backward and K3, warm ms/step,
   rays/s and peak memory; then 3 steps kernels on vs off from the same
   weights, batches and randomness (every gradient and the hash-decay term
   of the first, the loss of each); then 100 steps at the full learning
   rate (no warm-up), where the data loss must fall;
9. train -> render: `render_lidar --params` renders one full sweep from the
   params_<step>.npz that [8] wrote, through K1 and H1.
Prints the kernels' JSON line, the nvidia-smi line, then as its last line
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


def phase_composite(dev):
    """K1 vs plain on the card. Returns (max_abs_err, ms, plain_ms)."""
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
    print(f"[3] composite vs plain: max abs err {worst:.3e}; "
          f"R=16384 S=32 K=19: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return worst, ms, plain_ms


def phase_hash_encode(dev, cfg):
    """H1 vs plain on the card, each grid at the batch the main path gives
    it: a render chunk times that level's samples. Returns (max_abs_err, ms,
    plain_ms) of the NeRF grid."""
    import torch
    from nerf_lidar_tpu_torch.ops import grid

    g = torch.Generator(device=dev).manual_seed(1)
    m, n = cfg.model, cfg.model.sample_n
    grids = [("nerf", m.nerf_mlp.grid, m.num_nerf_samples)] + [
        (f"prop{i}", m.prop_mlp_for_level(i).grid, samples)
        for i, samples in enumerate(m.num_prop_samples)]
    worst, result = 0.0, None
    for name, grid_cfg, samples in grids:
        b = cfg.render_chunk_size * samples
        spec = grid.spec_for(grid_cfg)
        table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                           generator=g) * 2 - 1
        x01 = torch.rand(b, n, 3, device=dev, generator=g) * 1.1 - 0.05
        stds = torch.rand(b, n, device=dev, generator=g) * 0.01 + 1e-5
        got = grid.hash_encode_multisample(table, x01, stds, spec)
        want = grid.hash_encode_multisample_plain(table, x01, stds, spec)[0]
        torch.cuda.synchronize()
        err = close(f"hash_encode_ms {name}", got, want, 1e-5, 1e-6)
        worst = max(worst, err)
        ms = cuda_ms(lambda: grid.hash_encode_multisample(
            table, x01, stds, spec), iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: grid.hash_encode_multisample_plain(
            table, x01, stds, spec), iters=5, warmup=1)
        oob = float(((x01 < 0) | (x01 > 1)).any(-1).float().mean())
        print(f"[4] hash_encode_ms {name}: {spec.num_levels} levels x "
              f"C{spec.level_dim}, {spec.total_rows} rows, B={b} n={n} "
              f"(out of range {oob:.3f}): max abs err {err:.3e}; "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if result is None:
            result = (ms, plain_ms)
        del table, x01, stds, got, want
    return (worst,) + result


def phase_slice(dev):
    """The port's render_lidar entry at full width, kernels on; then the
    same sweep kernels off. Returns the launch counts of the entry's run."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
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
    return launches


# Atomics sum each gradient row in an order that changes from run to run:
# relative to the largest value, 1e-4 leaves room for the coarse levels,
# where thousands of fp32 terms land on one row.
BWD_TOL = 1e-4
GRADS = ("d_table", "d_x01", "d_stds")


def phase_hash_encode_bwd(dev, cfg):
    """H1 backward vs its written-out plain twin, each grid at the train
    step's batch; on prop0 (the smallest grid) also vs plain autograd
    through the plain encode, which takes seconds there (an accumulating
    index_put_ per corner and level). Returns {"nerf": (max abs err of
    d_table, kernel ms, twin ms), "prop0": (max abs err over the three
    gradients, kernel ms, autograd ms)}."""
    import torch
    from nerf_lidar_tpu_torch.ops import grid

    g = torch.Generator(device=dev).manual_seed(6)
    m, n = cfg.model, cfg.model.sample_n
    rays = cfg.batch_size + cfg.batch_size // cfg.lidar_batch_ratio
    grids = [("nerf", m.nerf_mlp.grid, m.num_nerf_samples)] + [
        (f"prop{i}", m.prop_mlp_for_level(i).grid, samples)
        for i, samples in enumerate(m.num_prop_samples)]
    result = {}
    for name, grid_cfg, samples in grids:
        b = rays * samples
        spec = grid.spec_for(grid_cfg)
        table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                           generator=g) * 2 - 1
        x01 = torch.rand(b, n, 3, device=dev, generator=g) * 1.1 - 0.05
        stds = torch.rand(b, n, device=dev, generator=g) * 0.01 + 1e-5
        g_out = torch.randn(b, spec.output_dim, device=dev, generator=g)
        inputs = name == "prop0"
        needs = (True, inputs, inputs)
        got = grid.hash_encode_multisample_bwd(table, x01, stds, g_out, spec,
                                               needs=needs)
        twin_ms, want = cuda_ms_once(
            lambda: grid.hash_encode_multisample_bwd_plain(
                table, x01, stds, g_out, spec, needs=needs))
        errs = {key: rel_err(f"hash_encode_ms_bwd {name} {key} vs twin",
                             got[i], want[i], BWD_TOL)
                for i, key in enumerate(GRADS) if needs[i]}
        ms = cuda_ms(lambda: grid.hash_encode_multisample_bwd(
            table, x01, stds, g_out, spec, needs=(True, False, False)),
            iters=3, warmup=1)
        line = (f"[6] hash_encode_ms_bwd {name}: {spec.num_levels} levels x "
                f"C{spec.level_dim}, B={b} n={n}: vs written-out twin "
                f"(max abs err, relative to max) {errs}; kernel {ms:.3f} ms "
                f"(d_table only), twin {twin_ms:.1f} ms"
                f"{' (all three inputs)' if inputs else ''}")
        if name == "nerf":
            result[name] = (errs["d_table"][0], ms, twin_ms)
        if inputs:
            ms_all = cuda_ms(lambda: grid.hash_encode_multisample_bwd(
                table, x01, stds, g_out, spec, needs=needs), iters=3,
                warmup=1)
            leaves = [t.clone().requires_grad_(True)
                      for t in (table, x01, stds)]
            out = grid.hash_encode_multisample_plain(*leaves, spec)[0]
            auto_ms, auto = cuda_ms_once(lambda: torch.autograd.grad(
                out, leaves, g_out))
            auto_errs = {key: rel_err(f"hash_encode_ms_bwd {name} {key} vs "
                                      "autograd", got[i], auto[i], BWD_TOL)
                         for i, key in enumerate(GRADS)}
            line += (f"; vs plain autograd {auto_errs}; all three inputs: "
                     f"kernel {ms_all:.3f} ms, autograd {auto_ms:.1f} ms")
            result[name] = (max(e[0] for e in auto_errs.values()), ms_all,
                            auto_ms)
            del leaves, out, auto
        print(line)
        del table, x01, stds, g_out, want, got
        torch.cuda.empty_cache()
    return result


# Relative to the largest sum. At K3's own shapes (~1,000 values a row),
# against index_add_. On the path a level of up to 2^21 values lands on
# one row: the kernel adds ~16,000 partial sums there in any order, so it
# is held against index_add_ in float64, to 1e-4; index_add_ in float32,
# the timed plain version, is itself ~1e-3 off there.
SCATTER_TOL = 1e-5
PATH_SCATTER_TOL = 1e-4


def phase_scatter(dev, cfg):
    """K3 vs index_add_, at the train path's shapes (the hash-decay level
    sums of each grid, table uniform(-1, 1)) and at K3's own. Returns
    (max abs err, kernel ms, plain ms) of the NeRF grid's level sums, and
    the same at K3's rows 2^17, N 2^22."""
    import torch
    from nerf_lidar_tpu_torch.ops import grid

    g = torch.Generator(device=dev).manual_seed(7)
    m = cfg.model
    path = None
    for name, grid_cfg in [("nerf", m.nerf_mlp.grid)] + [
            (f"prop{i}", m.prop_mlp_for_level(i).grid)
            for i in range(len(m.num_prop_samples))]:
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
        print(f"[7] scatter_add_rows hash decay {name}: N={spec.total_rows} "
              f"rows onto {rows} C={spec.level_dim}: max abs err {err:.3e} "
              f"({rel:.2e} of max; index_add_ in float32 {plain32:.2e}); "
              f"kernel {ms:.4f} ms, index_add_ {plain_ms:.4f} ms")
        if path is None:
            path = (err, ms, plain_ms)
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
            own = (err, ms, plain_ms)
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
    wrote)."""
    import numpy as np
    import torch
    from nerf_lidar_tpu_torch import cli
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
        step = TRAIN_STEPS + i
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
    return launches, params


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
    h1 = timed("[4]", phase_hash_encode, dev, cfg)
    render_launches = timed("[5]", phase_slice, dev)
    h1_bwd = timed("[6]", phase_hash_encode_bwd, dev, cfg)
    k3_path, k3_own = timed("[7]", phase_scatter, dev, cfg)
    train_launches, params = timed("[8]", phase_train, dev)
    timed("[9]", phase_train_to_render, dev, params)
    if any(m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
           for m in sys.modules):
        fail("the port imported JAX")

    # Launches per main path: the render entry's run [5] and the train
    # entry's run [8]; `launches` is their sum.
    by_path = {name: {p: counts.get(name, 0) for p, counts in (
        ("render_lidar", render_launches), ("train", train_launches))}
        for name in ("composite", "hash_encode_ms", "hash_encode_ms_bwd",
                     "scatter_add_rows")}

    def entry(name, replaces, err_ms_plain, **extra):
        return dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=replaces,
                    launches=sum(by_path[name].values()),
                    launches_by_path=by_path[name],
                    max_abs_err=err_ms_plain[0], ms=err_ms_plain[1],
                    plain_ms=err_ms_plain[2], **extra)

    def timing(err_ms_plain):
        return dict(zip(("max_abs_err", "ms", "plain_ms"), err_ms_plain))

    kernels = [
        entry("composite", "nerf_lidar_tpu/ops/render_pallas.py:109", k1),
        # At the render path's chunk (NeRF grid).
        entry("hash_encode_ms", "nerf_lidar_tpu/ops/grid.py:366", h1),
        # NeRF grid, d_table, vs the written-out twin; prop0 vs autograd.
        entry("hash_encode_ms_bwd", "nerf_lidar_tpu/ops/grid.py:366",
              h1_bwd["nerf"], prop0_vs_autograd=timing(h1_bwd["prop0"])),
        # The NeRF grid's hash-decay level sums; K3's own shape beside.
        entry("scatter_add_rows", "experiments/scatter_variants.py:81",
              k3_path, k3_shape_rows131072_n4194304_c16=timing(k3_own)),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
