"""Kernels K3 (`scatter_add_rows`) and `take_rows` (K4's row form) at the
shapes the port gives them, on one GPU.

    python nerf_lidar_tpu_torch/experiments/row_kernels_bench.py \
        [--root DIR] [--sass] [--set KEY=VALUE ...]

K3 at the hash-decay level sums of every `nuscenes_single` grid (every row
of a level onto one output row; table seeded uniform(-1, 1)) and at its own
random-row shapes (C16), against `index_add_` (float64 on the level sums);
`take_rows` at the TPU kernel's (512, 128) <- 256 and at the gather bench's
(2^19, 16) <- 2^20, exactly against its plain version, in turns with
`index_select` (kernel, library, library, kernel). K3: CUDA-event means of
20 calls, twice (first and last of the run), and the device time of the
wrapper call (kernel and the fill of `out`) and of `index_add_` from
torch.profiler; at the own shapes also with every index moved out of range
(the same loads and run breaks, no atomics). `take_rows` and its library
call: device time per call from torch.profiler (50 calls). One JSON line a
measurement, after nvidia-smi's name and power limit of the card. Fails
(non-zero exit) on a wrong result.

--root DIR: import `nerf_lidar_tpu_torch` from the checkout at DIR (for
  example an earlier commit unpacked with `git archive`) to time its
  kernels the same way; they build into DIR. Run this file by its path, not
  with -m, for that.
--set KEY=VALUE: a config override of `nuscenes_single` (as the entries'
  `--set`) for the grids whose hash-decay level sums K3 takes, e.g.
  `--set model.nerf_mlp.grid.level_dim=3` (repeatable).
--sass: also print, per kernel function of the built library whose name
  holds `scatter_add_rows` or `take_rows`, its SASS instruction count and
  the subroutine calls in it (`cuobjdump -sass`, from nvcc's directory).
--det: K3's deterministic variant instead (`bench_det_scatter`): at the
  hash-decay level sums and K3's own shape (rows 2^17, N 2^22, C16), the
  wrapper (bound S, kernel, fixed_to_float) by device time in turns with
  torch's deterministic `index_add_`, split by kernel, the exponents
  against `fixed_exponents(_abs_bound(...))`; with --root, the int64 sums
  and flags of the --root checkout's `scatter_add_rows_fixed` and of this
  file's own checkout's at the same exponents, which must be bit-equal.
--det also times kernel `abs_bound` (the bound S of the deterministic
  sums, `bench_det_bound`) at the path's shapes: each grid's g_out of a
  `nuscenes_single` train step and of the refinement recipe's object grid,
  the hash-decay tables and K3's shape (seeded values): device time per
  call in turns with the --root checkout's (root, here, here, root) and
  beside its library yardstick, `torch.linalg.vector_norm(v, 1, dim=0,
  dtype=torch.float64)` (the same S on finite values, one call); its
  kernels a call; S against `abs_bound_plain` (bit-equal) and the
  yardstick.
--bound_steps: kernel `abs_bound` on every input one train step hands
  it (`bench_bound_steps`): one step under torch's deterministic switch,
  after one step of `train --deterministic`, of the refinement recipe and
  of the object recipe (hash_encode_bench.REFINE_RECIPES, on a synth_nusc
  scene), each input recorded as it is called; the step's calls summed,
  by device time in turns with the --root checkout's (root, here, here,
  root), and each distinct shape with its count a step; and the posenet's
  per-ray gathers on the refinement step's batch
  (hash_encode_bench.posenet_gathers).
--sink: the micro-benchmark of the deterministic kernels' int64 row sink
  (`bench_sinks`, this file's own checkout's kernel `fixed_sink`): the same
  rows and int64 terms added one lane a row with C scalar atomics (the
  earlier sink) and lane-transposed, in turns, at K3's shape and, with
  --inputs FILE (hash_encode_bench.py --save_inputs), on the merged
  corner runs of a train step's NeRF encode backward.
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

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Published peak of one H100 SXM at 700 W: 3.35 TB/s (per millisecond).
HBM_BYTES_PER_MS = 3.35e9
# K3 against index_add_ in float64 on the level sums, relative to the
# largest sum (as chip_smoke.py holds it), and in float32 at its own shapes.
PATH_TOL, OWN_TOL = 1e-4, 1e-5


def emit(**rec):
    print(json.dumps(rec), flush=True)


def cuda_ms(fn, iters=20, warmup=3):
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


def device_ms(fn, iters=50):
    """Device milliseconds per call: the summed device activities of
    `iters` calls under torch.profiler (host gaps do not count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no device time
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    raise SystemExit("torch.profiler recorded no device time")


def fixed_sink(rows, terms, acc, transposed, lib=None):
    """The deterministic kernels' int64 row sink alone (`fixed_sink`):
    terms [M, C] int64 added at rows [M] (int32, in range) of acc [*, C]
    int64, C = 1, 2, 4, 8 or 16, one thread an update, by C scalar atomics
    of its own (transposed False: the earlier sink) or lane-transposed. lib:
    the kernel library (default: this package's)."""
    if lib is None:
        from nerf_lidar_tpu_torch.ops import _build
        lib = _build.library()
    from nerf_lidar_tpu_torch.ops import _build as build
    rc = lib.nl_fixed_sink(rows.data_ptr(), terms.data_ptr(), rows.numel(),
                           terms.shape[1], acc.data_ptr(), int(transposed),
                           acc.device.index, build.stream_of(acc))
    build.check(lib, rc, "fixed_sink")


def rel_err(name, got, want, tol):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > tol * scale:
        raise SystemExit(f"{name}: max abs err {err} against max |want| "
                         f"{scale} (tolerance {tol} of it)")
    return err / scale


def bench_model(sets=()):
    """`nuscenes_single`'s model config with the `--set` overrides."""
    from nerf_lidar_tpu_torch import cli
    argv = ["train", "--config", "nuscenes_single"]
    for kv in sets:
        argv += ["--set", kv]
    return cli.build_config(cli.parse_args(argv)).model


def bench_scatter(root, dev, sets=()):
    from nerf_lidar_tpu_torch.ops import grid
    g = torch.Generator(device=dev).manual_seed(7)
    m = bench_model(sets)
    grids = [("nerf", m.nerf_mlp.grid)] + [
        (f"prop{i}", m.prop_mlp_for_level(i).grid)
        for i in range(len(m.num_prop_samples))]
    cases = []
    for name, grid_cfg in grids:
        spec = grid.spec_for(grid_cfg)
        table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                           generator=g) * 2 - 1
        cases.append((f"hash decay {name} C{spec.level_dim}",
                      grid.level_ids(spec, dev),
                      table**2, spec.num_levels, PATH_TOL))
    for rows in (4096, 1 << 17):
        for n in (1 << 20, 1 << 22):
            cases.append((f"rows={rows} N={n} C=16", torch.randint(
                0, rows, (n,), device=dev, generator=g, dtype=torch.int32),
                torch.randn(n, 16, device=dev, generator=g), rows, OWN_TOL))
    for shape, idx, vals, rows, tol in cases:
        kern = lambda: grid.scatter_add_rows(idx, vals, rows)
        idx64 = idx.long()
        library = lambda: vals.new_zeros(rows, vals.shape[1]).index_add_(
            0, idx64, vals)
        want = (grid.scatter_add_rows_plain(idx, vals.double(), rows)
                if tol == PATH_TOL else library())
        err = rel_err(f"scatter_add_rows {shape}", kern().to(want.dtype),
                      want, tol)
        first = cuda_ms(kern)
        rec = dict(max_rel_err=err, device_ms=device_ms(kern),
                   library_device_ms=device_ms(library, iters=5))
        n_bytes = (idx.numel() * 4 + vals.numel() * 4
                   + rows * vals.shape[1] * 4)
        emit(root=root, kernel="scatter_add_rows", shape=shape,
             event_ms=[first, cuda_ms(kern)], **rec,
             bound_ms=n_bytes / HBM_BYTES_PER_MS)
        if tol == OWN_TOL:
            # The same loads and run breaks with every index out of range:
            # each run is dropped, so no atomic is issued.
            dropped = idx + rows
            if float(grid.scatter_add_rows(dropped, vals, rows).abs().max()):
                raise SystemExit(f"scatter_add_rows {shape}: an index out "
                                 "of range was not dropped")
            emit(root=root, kernel="scatter_add_rows", shape=shape,
                 every_index_dropped_device_ms=device_ms(
                     lambda: grid.scatter_add_rows(dropped, vals, rows)))
        del idx64, want


def here_grid():
    """This file's own checkout's `ops.grid` (hash_encode_bench.here_grid)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import hash_encode_bench
    return hash_encode_bench.here_grid()


def det_split(fn, iters=20):
    """{kernel: device ms per call} of fn, names cut before their
    arguments, and their sum under "total"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = re.sub(r"^void |\(anonymous namespace\)::|at::native::",
                         "", e.name).split("(")[0][:50]
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    out["total"] = sum(out.values())
    return out


def fixed_scatter_sums(lib, idx, vals, k, rows):
    """(sums [rows, C] int64, flags) of one `nl_scatter_add_rows_fixed` of
    `lib` on zeroed buffers at exponents k [C] (the same interface in this
    checkout and its parent)."""
    from nerf_lidar_tpu_torch.ops import _build
    c = vals.shape[1]
    acc = torch.zeros((rows, c), dtype=torch.int64, device=vals.device)
    flags = torch.zeros(((rows * c + 7) // 8,), dtype=torch.int32,
                        device=vals.device)
    rc = lib.nl_scatter_add_rows_fixed(
        idx.data_ptr(), vals.data_ptr(), k.data_ptr(), acc.data_ptr(),
        flags.data_ptr(), vals.shape[0], c, rows, vals.device.index,
        _build.stream_of(vals))
    _build.check(lib, rc, "scatter_add_rows_fixed")
    return acc, flags


def det_cases(dev, sets=()):
    """[(shape, idx, vals, rows)]: the hash-decay level sums of every
    `nuscenes_single` grid (with the `--set` overrides; table seeded
    uniform(-1, 1)) and K3's shape."""
    from nerf_lidar_tpu_torch.ops import grid
    g = torch.Generator(device=dev).manual_seed(19)
    m = bench_model(sets)
    out = []
    for name, grid_cfg in [("nerf", m.nerf_mlp.grid)] + [
            (f"prop{i}", m.prop_mlp_for_level(i).grid)
            for i in range(len(m.num_prop_samples))]:
        spec = grid.spec_for(grid_cfg)
        table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                           generator=g) * 2 - 1
        out.append((f"hash decay {name} C{spec.level_dim}",
                    grid.level_ids(spec, dev),
                    table**2, spec.num_levels))
    rows, n = 1 << 17, 1 << 22
    out.append((f"rows={rows} N={n} C=16", torch.randint(
        0, rows, (n,), device=dev, generator=g, dtype=torch.int32),
        torch.randn(n, 16, device=dev, generator=g), rows))
    return out


def bench_det_scatter(root, dev, sets=()):
    from nerf_lidar_tpu_torch.ops import _build, grid
    here = here_grid()
    other = os.path.abspath(root) != os.path.abspath(HERE)
    for shape, idx, vals, rows in det_cases(dev, sets):
        k_torch = grid.fixed_exponents(grid._abs_bound(vals))
        _, k_here = here.bound_exponents(vals)
        rec = dict(root=root, kernel="scatter_add_rows_det", shape=shape,
                   k_equal=bool(torch.equal(k_here, k_torch)))
        if other:
            want = fixed_scatter_sums(_build.library(), idx, vals, k_torch,
                                      rows)
            got = fixed_scatter_sums(here._build.library(), idx, vals,
                                     k_torch, rows)
            rec["sums_bit_equal_to_here"] = bool(
                torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
            del want, got
            if not rec["sums_bit_equal_to_here"]:
                raise SystemExit(f"scatter_add_rows_fixed {shape}: the int64 "
                                 f"sums of {HERE} differ from {root}'s")
        ok = (idx >= 0) & (idx < rows)
        ids64 = idx.long().clamp(0, rows - 1)
        kept = vals * ok[:, None].to(vals.dtype)
        library = lambda: vals.new_zeros(rows, vals.shape[1]).index_add_(
            0, ids64, kept)
        fns = {"root": lambda: grid.scatter_add_rows_det(idx, vals, rows),
               "here": lambda: here.scatter_add_rows_det(idx, vals, rows)}
        turns = {"kernel": [], "library": []}
        for turn in ("kernel", "library", "library", "kernel"):
            if turn == "kernel":
                turns[turn].append(device_ms(fns["here"], iters=20))
                continue
            torch.use_deterministic_algorithms(True)
            try:  # torch's deterministic index_add_
                turns[turn].append(device_ms(library, iters=3))
            finally:
                torch.use_deterministic_algorithms(False)
        if other:
            turns["root_kernel"] = [device_ms(fns["root"], iters=20)]
        rec.update(turns_device_ms=turns, split=det_split(fns["here"]))
        if other:
            rec["root_split"] = det_split(fns["root"])
        n_bytes = idx.numel() * 4 + vals.numel() * 4 + rows * vals.shape[1] * 4
        emit(**rec, bound_ms=n_bytes / HBM_BYTES_PER_MS)


def bound_cases(dev):
    """[(name, v)]: seeded values of the shapes kernel `abs_bound` takes on
    the train path: g_out of each `nuscenes_single` grid at a train step's
    B (20,480 rays x 32 NeRF / 64 proposal samples), of the object grid
    (B = 81,920, 7 levels x C2), the hash-decay tables (each grid's
    [rows, C]) and K3's shape."""
    from nerf_lidar_tpu_torch import configs
    from nerf_lidar_tpu_torch.ops import grid
    g = torch.Generator(device=dev).manual_seed(23)
    m = configs.nuscenes_single().model
    grids = [("nerf", m.nerf_mlp.grid, 655_360)] + [
        (f"prop{i}", m.prop_mlp_for_level(i).grid, 1_310_720)
        for i in range(len(m.num_prop_samples))] + [
        ("obj", m.obj_mlp.grid, 81_920)]
    out = []
    for name, grid_cfg, b in grids:
        spec = grid.spec_for(grid_cfg)
        out.append((f"g_out {name}", torch.randn(
            b, spec.output_dim, device=dev, generator=g)))
        if name != "obj":
            out.append((f"hash decay {name}", torch.rand(
                spec.total_rows, spec.level_dim, device=dev,
                generator=g) ** 2))
    out.append(("K3 shape", torch.randn(1 << 22, 16, device=dev,
                                        generator=g)))
    return out


def kernels_a_call(fn, iters=10):
    """{device kernel name: launches a call} of fn under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = re.sub(r"^void |\(anonymous namespace\)::", "",
                         e.name).split("(")[0][:50]
            out[key] = out.get(key, 0) + 1 / iters
    return out


def bench_det_bound(root, dev):
    from nerf_lidar_tpu_torch.ops import grid
    here = here_grid()
    other = os.path.abspath(root) != os.path.abspath(HERE)
    for name, v in bound_cases(dev):
        s, k = here.bound_exponents(v)
        plain = here.abs_bound_plain(v)
        if not (torch.equal(s, plain)
                and torch.equal(k, here.fixed_exponents(plain))):
            raise SystemExit(f"abs_bound {name}: S differs from its plain "
                             "version")
        library = lambda: torch.linalg.vector_norm(v, 1, dim=0,
                                                   dtype=torch.float64)
        lib_s = library()
        fns = {"here": lambda: here.bound_exponents(v),
               "root": lambda: grid.bound_exponents(v)}
        order = ("root", "here", "here", "root") if other else ("here",
                                                                "here")
        turns = {k: [] for k in dict.fromkeys(order)}
        for turn in order:
            turns[turn].append(device_ms(fns[turn], iters=20))
        emit(root=root, kernel="abs_bound", shape=name,
             size=list(v.shape), plan=list(here._bound_plan(*v.shape)),
             turns_device_ms=turns,
             library_device_ms=device_ms(library, iters=20),
             kernels_a_call=kernels_a_call(fns["here"]),
             s_rel_to_library=float(((s - lib_s).abs()
                                     / lib_s.clamp(min=1e-300)).max()),
             bound_ms=v.numel() * 4 / HBM_BYTES_PER_MS)
        del plain, lib_s


@contextlib.contextmanager
def recording_bound(grid):
    """Within the block, every call of grid.bound_exponents appends a clone
    of its input to the list it yields. The wrapper carries the function's
    launch count, and gives it back."""
    orig, calls = grid.bound_exponents, []

    def wrapper(v):
        calls.append(v.detach().clone())
        return orig(v)

    wrapper.launches = orig.launches
    grid.bound_exponents = wrapper
    try:
        yield calls
    finally:
        orig.launches = wrapper.launches
        grid.bound_exponents = orig


def step_bound_inputs(recipes=("refine", "objects")):
    """({recipe: [v, ...]}, (camera indices, images)): every input of
    kernel `abs_bound` in one train step under torch's deterministic switch
    (after one step of `train --deterministic`) of each recipe of
    hash_encode_bench.REFINE_RECIPES named, on a synth_nusc scene it writes
    and removes; and the refinement step's batch's camera indices and the
    posenet's image count."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import hash_encode_bench as heb
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.data import synth_nusc
    from nerf_lidar_tpu_torch.ops import grid
    from nerf_lidar_tpu_torch.train import train_step
    tag = f"row_kernels_bench_{os.getpid()}"
    scene = os.path.join("exp", tag + "_scene")
    synth_nusc.write_scene_dir(scene, sensor_num=1)
    out, cams = {}, None
    try:
        for recipe in recipes:
            args = heb.REFINE_RECIPES[recipe][0]
            argv = ["train", *(scene if a == "<scene>" else a for a in args),
                    "--steps", "1", "--device", "cuda", "--exp_name", tag,
                    "--deterministic"]
            out_dir = cli.exp_dir(cli.build_config(cli.parse_args(argv)))
            shutil.rmtree(out_dir, ignore_errors=True)
            try:
                run = cli.main(argv)
                dev = next(run.model.parameters()).device
                batch = cli.to_device(run.batcher.next(), dev)
                with cli.deterministic_mode(), recording_bound(grid) as calls:
                    stats = train_step.train_step(
                        run.model, run.optimizer, run.cfg, batch, 1,
                        run.batcher.num_patch_rays, run.generator,
                        posenet=run.posenet, tracknet=run.tracknet,
                        tracks=run.tracks, track_mask=run.track_mask)
                    float(stats["loss"])
                out[recipe] = calls
                if run.posenet is not None:
                    cams = (batch["cam_idx"][..., 0].cpu().numpy(),
                            run.posenet.r.shape[0])
                del run, batch
            finally:
                shutil.rmtree(out_dir, ignore_errors=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(scene, ignore_errors=True)
    return out, cams


def bench_bound_steps(root, dev):
    """--bound_steps: the module docstring's."""
    from nerf_lidar_tpu_torch.ops import grid
    here = here_grid()
    other = os.path.abspath(root) != os.path.abspath(HERE)
    order = ("root", "here", "here", "root") if other else ("here", "here")
    steps, cams = step_bound_inputs()
    for recipe, calls in steps.items():
        for v in calls:
            if not torch.equal(here.bound_exponents(v)[0],
                               here.abs_bound_plain(v)):
                raise SystemExit(f"abs_bound {recipe} {list(v.shape)}: S "
                                 "differs from its plain version")
        fns = {"here": lambda: [here.bound_exponents(v) for v in calls],
               "root": lambda: [grid.bound_exponents(v) for v in calls]}
        turns = {k: [] for k in dict.fromkeys(order)}
        for turn in order:
            turns[turn].append(device_ms(fns[turn], iters=20))
        emit(root=root, kernel="abs_bound", recipe=recipe, what="step",
             calls=len(calls), turns_device_ms=turns,
             bound_ms=sum(v.numel() for v in calls) * 4 / HBM_BYTES_PER_MS)
        shapes = {}
        for v in calls:
            shapes.setdefault(tuple(v.shape), []).append(v)
        for shape, vs in shapes.items():
            v = vs[0]
            fns = {"here": lambda: here.bound_exponents(v),
                   "root": lambda: grid.bound_exponents(v)}
            turns = {k: [] for k in dict.fromkeys(order)}
            for turn in order:
                turns[turn].append(device_ms(fns[turn], iters=20))
            emit(root=root, kernel="abs_bound", recipe=recipe, what="shape",
                 size=list(shape), per_step=len(vs),
                 plan=list(here._bound_plan(*shape)), turns_device_ms=turns,
                 bound_ms=v.numel() * 4 / HBM_BYTES_PER_MS)
        del calls, shapes
    del steps
    import hash_encode_bench
    hash_encode_bench.posenet_gathers(*cams)


# K3's shape for the sink micro-benchmark: rows and updates of C16.
SINK_ROWS, SINK_UPDATES = 1 << 17, 1 << 22


def nerf_runs(rec):
    """[(level, rows [M] int32, terms [M, C] int64)] of the NeRF grid's
    recorded train inputs `rec`: per level and corner, the rows and
    fixed-point terms of every merged run (`grid._table_runs`, at the
    exponents of `grid.fixed_exponents(grid._abs_bound(g))`), in sample
    order, the order in which the kernel's lanes hold them."""
    from nerf_lidar_tpu_torch.ops import grid
    table, x01, stds, g_out, spec = rec[:5]
    c = spec.level_dim
    g = g_out.reshape(-1, spec.output_dim)
    k = grid.fixed_exponents(grid._abs_bound(g)).reshape(spec.num_levels, c)
    by_level = {}
    for l, ids, cells, w in grid._table_runs(spec, x01, stds, 0):
        by_level.setdefault(l, []).append((ids, cells, w))
    out = []
    for l, parts in sorted(by_level.items()):
        ids = torch.cat([p[0] for p in parts])
        order = torch.sort(ids, stable=True).indices
        ids = ids[order]
        cells = torch.cat([p[1] for p in parts])[order]
        w = torch.cat([p[2] for p in parts])[order]
        gl = g[ids, l * c:(l + 1) * c]
        rows, terms = [], []
        for corner, offset in enumerate(grid._CORNERS3):
            cc = cells + torch.tensor(offset, device=cells.device)
            rows.append(grid._corner_index(spec, l, cc[:, 0], cc[:, 1],
                                           cc[:, 2]).to(torch.int32))
            terms.append(grid._to_fixed(w[:, corner, None] * gl, k[l]))
        out.append((l, torch.cat(rows), torch.cat(terms)))
    return out


def bench_sinks(root, dev, inputs):
    """The two row sinks on the same rows and terms, in turns (one lane a
    row, transposed, transposed, one lane a row), device ms from
    torch.profiler, and their results against each other."""
    lib = here_grid()._build.library()
    g = torch.Generator(device=dev).manual_seed(15)
    cases = [(f"K3 shape rows={SINK_ROWS} M={SINK_UPDATES} C=16",
              torch.randint(0, SINK_ROWS, (SINK_UPDATES,), device=dev,
                            generator=g, dtype=torch.int32),
              torch.randint(-2**40, 2**40, (SINK_UPDATES, 16), device=dev,
                            generator=g, dtype=torch.int64), SINK_ROWS)]
    if inputs:
        rec = torch.load(inputs, weights_only=False)["nerf"]
        spec = rec[4]
        for l, rows, terms in nerf_runs(rec):
            cases.append((f"NeRF level {l} runs", rows, terms,
                          spec.rows_per_level[l]))
        del rec
    for shape, rows, terms, n_rows in cases:
        accs = {}
        turns = {"lane_per_row": [], "transposed": []}
        for turn in ("lane_per_row", "transposed", "transposed",
                     "lane_per_row"):
            acc = torch.zeros((n_rows, terms.shape[1]), dtype=torch.int64,
                              device=dev)
            fixed_sink(rows, terms, acc, turn == "transposed", lib)
            accs[turn] = acc
            turns[turn].append(device_ms(lambda: fixed_sink(
                rows, terms, acc, turn == "transposed", lib), iters=10))
        if not torch.equal(accs["lane_per_row"], accs["transposed"]):
            raise SystemExit(f"fixed_sink {shape}: the two sinks differ")
        emit(root=root, kernel="fixed_sink", shape=shape, updates=len(rows),
             distinct_rows=int(torch.unique(rows).numel()),
             turns_device_ms=turns)
        del accs


def bench_take_rows(root, dev):
    from nerf_lidar_tpu_torch.ops import tile_gather as tg
    g = torch.Generator(device=dev).manual_seed(10)
    for rows, c, n in ((512, 128, 256), (2**19, 16, 2**20)):
        tbl = torch.randn(rows, c, device=dev, generator=g)
        idx = torch.randint(0, rows, (n,), device=dev, generator=g,
                            dtype=torch.int32)
        bad = torch.randint(-2 * rows, 2 * rows, (n,), device=dev,
                            generator=g, dtype=torch.int32)
        for case in (idx, bad):
            if not tg.same_values(tg.take_rows(tbl, case),
                                  tg.take_rows_plain(tbl, case)):
                raise SystemExit(f"take_rows ({rows},{c})<-{n}: the kernel "
                                 "differs from its plain version")
        kern = lambda: tg.take_rows(tbl, idx)
        library = lambda: tbl.index_select(0, idx)
        turns = [device_ms(f) for f in (kern, library, library, kern)]
        read = int(torch.unique(idx).numel()) * c * 4
        emit(root=root, kernel="take_rows", shape=f"({rows},{c})<-{n}",
             turns_kernel_library_library_kernel=turns,
             bound_ms=(n * 4 + n * c * 4 + read) / HBM_BYTES_PER_MS)


def sass_summary(root, lib_path):
    from nerf_lidar_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    for block in re.split(r"\n\s*Function : ", out)[1:]:
        name = block.split("\n", 1)[0].strip()
        if "scatter_add_rows" not in name and "take_rows" not in name:
            continue
        lines = re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);", block)
        calls = sorted({ln.strip() for ln in lines if "CALL" in ln})
        emit(root=root, sass=name, instructions=len(lines), calls=calls)


def main(argv=None):
    p = argparse.ArgumentParser("row_kernels_bench")
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    p.add_argument("--sass", action="store_true")
    p.add_argument("--det", action="store_true")
    p.add_argument("--sink", action="store_true")
    p.add_argument("--bound_steps", action="store_true")
    p.add_argument("--inputs")
    p.add_argument("--set", action="append", default=[])
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import nerf_lidar_tpu_torch
    if not os.path.abspath(nerf_lidar_tpu_torch.__file__).startswith(
            os.path.join(root, "")):
        raise SystemExit(f"nerf_lidar_tpu_torch was imported from "
                         f"{nerf_lidar_tpu_torch.__file__}, not {root}: run "
                         "this file by its path")
    from nerf_lidar_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        raise SystemExit("row_kernels_bench needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    _build.library()
    if args.sass:
        sass_summary(root, _build.library_path())
    if args.det or args.sink or args.bound_steps:
        if args.bound_steps:
            bench_bound_steps(root, dev)
        if args.sink:
            bench_sinks(root, dev, args.inputs)
        if args.det:
            bench_det_bound(root, dev)
            bench_det_scatter(root, dev, args.set)
        return
    bench_scatter(root, dev, args.set)
    bench_take_rows(root, dev)


if __name__ == "__main__":
    main()
