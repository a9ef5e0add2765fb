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
   and compares the kernels-on render with the kernels-off one.
Prints the kernels' JSON line, the nvidia-smi line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "nerf_lidar_tpu_torch/csrc/kernels.cu"
# The main path: the port's `render_lidar` entry, as a user would call it.
SLICE_ARGV = ["render_lidar", "--config", "nuscenes_single",
              "--set", "dataset_loader=synthetic", "--mode", "simu",
              "--num_sweeps", "2", "--allow_fresh", "--device", "cuda",
              "--exp_name", "chip_smoke"]


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
    k1 = phase_composite(dev)
    h1 = phase_hash_encode(dev, cfg)
    launches = phase_slice(dev)
    if any(m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
           for m in sys.modules):
        fail("the port imported JAX")

    kernels = [
        dict(name="composite", route="cuda", source=KERNEL_SOURCE,
             replaces="nerf_lidar_tpu/ops/render_pallas.py:109",
             launches=launches["composite"], max_abs_err=k1[0], ms=k1[1],
             plain_ms=k1[2]),
        dict(name="hash_encode_ms", route="cuda", source=KERNEL_SOURCE,
             replaces="nerf_lidar_tpu/ops/grid.py:366",
             launches=launches["hash_encode_ms"], max_abs_err=h1[0],
             ms=h1[1], plain_ms=h1[2]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
