"""Kernel H1 (`hash_encode_ms`) and its backward on the points the main
paths give them, on one GPU.

    python nerf_lidar_tpu_torch/experiments/hash_encode_bench.py \
        [--root DIR] [--copies] [--profile] [--steps N]
        [--config NAME [--set KEY=VALUE ...]] [--det]

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
--det: the deterministic d_table instead (`det_grid`), per grid on the
  recorded train inputs: each level alone in both block orders, the
  fixed-point kernel beside the atomic one and, with --root, the --root
  checkout's fixed-point kernel; the whole call in turns with the atomic
  kernel, at the block sizes of `DET_THREADS`, on fresh copies, and with
  --root its call; the bound S kernel's
  exponents against `fixed_exponents(_abs_bound(...))`; with --root, the
  int64 sums and flags of the two checkouts' kernels at the same
  exponents, which must be bit-equal. With --root the package is still
  imported from DIR (the other checkout), and this file's own checkout's
  `ops` beside it (`here_grid`).
--det --refine: the position gradients (d_x01 / d_stds, `refine_grid`)
  instead, on the calls train steps hand the encode backward, each
  recorded under torch's deterministic switch after --steps steps of
  `train --deterministic`: the shipped refinement recipe's (nuscenes_single
  with pose and track refinement from the first step, on a synth_nusc
  scene with one moving car: its NeRF, proposal and object grids), the
  object recipe's object grid (track refinement alone) and
  nuscenes_single_fast's NeRF grid (C16, tetrahedral, mean-point levels).
  Per call, this checkout's H1 in its residual mode and H1, the
  contraction `hash_encode_ms_pos_grads` and its library yardstick (one
  `torch.einsum` over the same R), the atomic backward's d_table; with
  --root, that checkout's kernels beside them in turns (root, here, here,
  root): H1, its residual mode, its d_x01 / d_stds as both its modes
  compute them (the deterministic call asked for d_x01 / d_stds alone, the
  atomic backward at the call's needs and at d_table alone, the
  deterministic d_table alone). Checks: R
  against its plain version at BWD_TOL, the contraction the same bits as
  its plain version and on fresh copies, d_x01 / d_stds against the --root
  checkout's, and whether R, the features and the deterministic d_table
  are its bits. `--set
  KEY=VALUE` goes to every recipe's train entry. The bounds. Beside them: the posenet's gather (advanced indexing against
  `grid.select_rows`, forward and backward, with and without the switch,
  `posenet_gathers`).
--save_inputs FILE / --inputs FILE: write the recorded train inputs to
  FILE, or read them from FILE instead of training (with --det only; with
  --refine, its calls and camera indices).
--config NAME: the train-step and render-chunk inputs of that preset
  (`--set KEY=VALUE` passed on to its entries; the synthetic scene, full
  width), then per grid H1 (render chunk) and H1-bwd (train step, d_table)
  each level alone, and the whole calls, all on the same recorded inputs;
  with --root, the --root checkout's kernels and this file's checkout's
  (`here_grid`) in turns (root, here, here, root), and whether H1's
  features and the deterministic d_table (whose whole call is timed too)
  are the same bits in both. Beside each level's bound: the row updates
  its backward issues after merging, counted on the recorded inputs
  (`row_updates`). Where the general path's atomic backward may sum into
  rows padded to 16 bytes, the call both ways in turns (`pad_turns`).
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


def level_points(spec, x01, cutoff=0):
    """Per level, the in-range points the encode of x01 interpolates at:
    every in-range multisample point, or at a mean-point level (resolution
    <= cutoff) each sample's in-range mean point."""
    from nerf_lidar_tpu_torch.ops import grid
    x = x01.reshape(-1, 3)
    x = x[~((x < 0) | (x > 1)).any(-1)]
    mean = None
    out = []
    for at_mean in grid.mean_levels(spec, cutoff):
        if at_mean and mean is None:
            m, oob = grid._in_range(grid._seq_mean(
                x01.reshape(-1, x01.shape[-2], 3)))
            mean = m[~oob]
        out.append(mean if at_mean else x)
    return out


def _corners_per_point(spec):
    return 4 if spec.interp == "tetra" else 8


def rows_read(spec, x01, cutoff=0):
    """Distinct table rows the encode of x01 reads (4 simplex vertices or 8
    cube corners per point and level)."""
    from nerf_lidar_tpu_torch.ops import grid
    read = torch.zeros(spec.total_rows, dtype=torch.bool, device=x01.device)
    for l, pts in enumerate(level_points(spec, x01, cutoff)):
        for idx, _, _ in grid._corners(spec, l, pts):
            read[spec.offsets[l] + idx] = True
    return int(read.sum())


def _interp_flops(spec, x01, cutoff):
    """A multiply-add per corner channel at every interpolated point."""
    return sum(2 * pts.shape[0] * _corners_per_point(spec) * spec.level_dim
               for pts in level_points(spec, x01, cutoff))


def fwd_bound(spec, x01, stds, cutoff=0):
    """Bytes and operations of the encode: the points, the features and the
    distinct rows read; a multiply-add per corner channel."""
    out = stds.numel() // stds.shape[-1] * spec.output_dim * 4
    n_bytes = (nbytes(x01, stds) + out
               + rows_read(spec, x01, cutoff) * spec.level_dim * 4)
    return n_bytes, _interp_flops(spec, x01, cutoff)


def bwd_bound(spec, x01, stds, g_out, cutoff=0):
    """Bytes and operations of the backward: the points and g_out read, the
    whole d_table written; a multiply and an add per corner channel."""
    n_bytes = (nbytes(x01, stds, g_out)
               + spec.total_rows * spec.level_dim * 4)
    return n_bytes, _interp_flops(spec, x01, cutoff)


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

    def wrapper(*args, **kw):
        grid_name = names.get(args[0].data_ptr())
        if grid_name is not None and grid_name not in calls:
            calls[grid_name] = tuple(
                a.detach().clone() if isinstance(a, torch.Tensor) else a
                for a in args)
        return orig(*args, **kw)

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
    """Within the block, H1 and its backward (and the deterministic d_table,
    where `grid.fixed_level_major` exists) run in the block order that
    `grid.level_major` (`fixed_level_major`) does not pick."""
    names = [n for n in ("level_major", "fixed_level_major")
             if hasattr(grid, n)]
    picked = {n: getattr(grid, n) for n in names}
    for n in names:
        setattr(grid, n, lambda spec, l2_bytes, f=picked[n]:
                not f(spec, l2_bytes))
    try:
        yield
    finally:
        for n in names:
            setattr(grid, n, picked[n])


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


HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Block sizes that --det times the whole deterministic call at.
DET_THREADS = (64, 128, 256)


def here_grid():
    """The `ops.grid` module of this file's own checkout: the imported
    package's when that is this checkout, else the checkout's `ops`
    imported as `nl_here_ops` beside the --root one's (its kernels build
    into this checkout)."""
    import importlib
    import importlib.util
    import nerf_lidar_tpu_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(
            nerf_lidar_tpu_torch.__file__))) == HERE:
        return importlib.import_module("nerf_lidar_tpu_torch.ops.grid")
    name = "nl_here_ops"
    if name not in sys.modules:
        path = os.path.join(HERE, "nerf_lidar_tpu_torch", "ops")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(path, "__init__.py"),
            submodule_search_locations=[path])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(name + ".grid")


def fixed_sums(lib, x, s, g, k, arrays, levels, c, tetra, level_major_order,
               threads=128):
    """(sums [rows, C] int64, flags): one call of `nl_hash_encode_ms_bwd_fixed`
    of `lib` (the same interface in this checkout and its parent) on zeroed
    buffers, for (x [B, n, 3], s [B, n], g [B, levels * C]) at exponents
    k [levels, C]; arrays: the levels' constants (`grid._kernel_levels`, or
    a slice of them; rows from their offsets)."""
    rows = int(arrays[4][-1]) + int(arrays[3][-1])
    acc = torch.zeros((rows, c), dtype=torch.int64, device=x.device)
    flags = torch.zeros(((rows * c + 7) // 8,), dtype=torch.int32,
                        device=x.device)
    call_fixed(lib, x, s, g, k, acc, flags, arrays, levels, c, tetra,
               level_major_order, threads)
    return acc, flags


def plan_slices(lib, fn, c, walk_plan=None, kernel="encode"):
    """The general path's plan arguments that `lib`'s C function `fn` takes
    after its block order / size: (slices[, lanes]) of `walk_plan` (the
    library's own checkout's; default this checkout's) where the library
    takes them (checkouts before the walks take none)."""
    base = dict(nl_hash_encode_ms=20, nl_hash_encode_ms_bwd=20,
                nl_hash_encode_ms_bwd_fixed=22)[fn]
    extra = len(getattr(lib, fn).argtypes) - base
    if extra <= 0:
        return ()
    plan = (walk_plan or here_grid().walk_plan)(c, kernel)
    args = (plan.slices, plan.lanes) if plan is not None else (0, 0)
    return args[:extra]


def call_fixed(lib, x, s, g, k, acc, flags, arrays, levels, c, tetra,
               level_major_order, threads=128, walk_plan=None):
    """One launch of `lib`'s `nl_hash_encode_ms_bwd_fixed` (see
    `fixed_sums`), adding into acc and flags."""
    from nerf_lidar_tpu_torch.ops import _build
    b, n_ms = s.shape
    rc = lib.nl_hash_encode_ms_bwd_fixed(
        x.data_ptr(), s.data_ptr(), g.data_ptr(), k.data_ptr(),
        acc.data_ptr(), flags.data_ptr(), b, n_ms, levels, c,
        *(a.ctypes.data for a in arrays), tetra, bool(level_major_order),
        threads, *plan_slices(lib, "nl_hash_encode_ms_bwd_fixed", c,
                              walk_plan, "deterministic"),
        x.device.index, _build.stream_of(x))
    _build.check(lib, rc, "hash_encode_ms_bwd_fixed")


def call_float(lib, table, x, s, g, d_table, arrays, levels, c, tetra,
               level_major_order, scratch=None, walk_plan=None):
    """One launch of the atomic H1 backward (`nl_hash_encode_ms_bwd`),
    d_table only, adding into d_table (or, where the library takes a
    padded scratch, `scratch` at a general-path C % 4 != 0: summed there,
    d_table written from it); checkouts older than the residual mode take
    the table and two null gradient pointers besides."""
    from nerf_lidar_tpu_torch.ops import _build
    b, n_ms = s.shape
    ptrs = [x.data_ptr(), s.data_ptr(), g.data_ptr(), d_table.data_ptr()]
    argc = len(lib.nl_hash_encode_ms_bwd.argtypes)
    if argc == 21:  # the padded scratch and the plan
        ptrs.append(None if scratch is None else scratch.data_ptr())
    elif argc > 19:
        ptrs = [table.data_ptr(), *ptrs, None, None]
    rc = lib.nl_hash_encode_ms_bwd(
        *ptrs, b, n_ms, levels, c, *(a.ctypes.data for a in arrays), tetra,
        bool(level_major_order),
        *plan_slices(lib, "nl_hash_encode_ms_bwd", c, walk_plan,
                     "backward")[:1],
        x.device.index, _build.stream_of(x))
    _build.check(lib, rc, "hash_encode_ms_bwd")


def det_grid(root, name, rec, copies):
    """--det on one grid's recorded train inputs `rec` (table, x01, stds,
    g_out, spec, ...): emits the per-level split, the whole call's turns,
    the exponents' check and, with --root, the bit-equality of the int64
    sums of the two checkouts' kernels."""
    from nerf_lidar_tpu_torch.ops import _build, grid
    here = here_grid()
    table, x01, stds, g_out, spec = rec[:5]
    cutoff = rec[6] if len(rec) > 6 else 0
    other = os.path.abspath(root) != HERE
    c, levels = spec.level_dim, spec.num_levels
    tetra = spec.interp == "tetra"
    n_ms = x01.shape[-2]
    x = x01.reshape(-1, n_ms, 3).contiguous()
    s = stds.reshape(-1, n_ms).contiguous()
    g = g_out.reshape(s.shape[0], spec.output_dim).contiguous()
    arrays = here._kernel_levels(spec, cutoff)
    here_lib = here._build.library()
    root_lib = _build.library()
    dev = x.device.index
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    picked = here.fixed_level_major(spec, l2)
    s_kernel, k_here = here.bound_exponents(g)
    k_torch = grid.fixed_exponents(grid._abs_bound(g))
    k_here = k_here.reshape(levels, c)
    emit(root=root, what="det_exponents", grid=name,
         k_equal=bool(torch.equal(k_here, k_torch.reshape(levels, c))),
         s_max_rel_diff=float(((s_kernel - grid._abs_bound(g)).abs()
                               / grid._abs_bound(g).clamp(min=1e-300))
                              .max()),
         level_major=bool(picked))
    if other:
        # The two checkouts' kernels at the same exponents.
        k = k_torch.reshape(levels, c).contiguous()
        want = fixed_sums(root_lib, x, s, g, k, arrays, levels, c, tetra,
                          picked)
        same = {}
        for order in (True, False):
            for threads in DET_THREADS:
                got = fixed_sums(here_lib, x, s, g, k, arrays, levels, c,
                                 tetra, order, threads)
                same[f"level_major={order} threads={threads}"] = bool(
                    torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1]))
                del got
        del want
        emit(root=root, what="det_sums_vs_here", grid=name, here=HERE,
             bit_equal=same)
        if not all(same.values()):
            raise SystemExit(f"{name}: the int64 sums of {HERE} differ from "
                             f"those of {root} at the same exponents: {same}")
    # Each level alone: slices of g, k and the level constants.
    acc = torch.zeros((spec.total_rows, c), dtype=torch.int64,
                      device=x.device)
    flags = torch.zeros(((spec.total_rows * c + 7) // 8,), dtype=torch.int32,
                        device=x.device)
    d_table = torch.zeros_like(table)
    for l in range(levels):
        gl = g[:, l * c:(l + 1) * c].contiguous()
        kl = k_here[l:l + 1].contiguous()
        al = tuple(np.ascontiguousarray(a[l:l + 1]) for a in arrays)
        rec_l = dict(root=root, what="det_level", grid=name, level=l,
                     rows=spec.rows_per_level[l], tiled=spec.is_tiled(l),
                     slice_mb=spec.rows_per_level[l] * c * 8 / 2**20)
        for order in (True, False):
            key = "level_major" if order else "tile_major"
            rec_l[f"{key}_fixed_ms"] = cuda_ms(
                lambda: call_fixed(here_lib, x, s, gl, kl, acc, flags, al, 1,
                                   c, tetra, order))
            rec_l[f"{key}_atomic_ms"] = cuda_ms(
                lambda: call_float(here_lib, table, x, s, gl, d_table, al, 1,
                                   c, tetra, order))
            if other:
                rec_l[f"{key}_root_fixed_ms"] = cuda_ms(
                    lambda: call_fixed(root_lib, x, s, gl, kl, acc, flags,
                                       al, 1, c, tetra, order))
        emit(**rec_l)
    del acc, flags, d_table
    torch.cuda.empty_cache()
    # The whole call, in turns: this checkout's deterministic wrapper and
    # the atomic one (and --root's deterministic one).
    only = (True, False, False)
    det = lambda *t: here.hash_encode_multisample_bwd_det(*t, spec, only,
                                                          cutoff)
    args = (table, x01, stds, g_out)
    turns = {"det": [], "atomic": [], "root_det": []}
    turns.update({f"det_threads_{t}": [] for t in DET_THREADS})
    order = (("root_det", "det", "det", "root_det") if other
             else ("det", "atomic", "atomic", "det",
                   *(f"det_threads_{t}" for t in DET_THREADS)))
    fns = dict(det=lambda: det(*args),
               **{f"det_threads_{t}": lambda t=t:
                  here.hash_encode_multisample_bwd_det(
                      *args, spec, only, cutoff, threads=t)
                  for t in DET_THREADS},
               atomic=lambda: grid.hash_encode_multisample_bwd(
                   *args, spec, only, cutoff),
               root_det=lambda: grid.hash_encode_multisample_bwd_det(
                   *args, spec, only, cutoff))
    for turn in order:
        turns[turn].append(cuda_ms(fns[turn]))
    if other:
        turns["atomic"].append(cuda_ms(fns["atomic"]))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    det(*args)
    torch.cuda.synchronize()
    emit(root=root, what="det_call", grid=name, ms=turns,
         peak_gib_above_held=(torch.cuda.max_memory_allocated(dev) - held)
         / 2**30, pool_bytes=here.fixed_pool_bytes())
    if copies:
        emit(root=root, what="det_call", grid=name, copies_ms=on_copies(
            det, args, lambda got: None))


# The calls --det --refine records: {name: (train arguments, the grids
# it keeps)}; "<scene>" is the synth_nusc scene it writes.
REFINE_RECIPES = {
    "refine": (["--config", "nuscenes_single", "--set", "dataset_loader=nusc",
                "--data_dir", "<scene>", "--set", "track_start_opt=0",
                "--set", "pose_refine=true", "--set", "learn_R=true",
                "--set", "learn_t=true", "--set", "start_step=0"],
               ("nerf", "prop0", "prop1", "obj")),
    "objects": (["--config", "nuscenes_single", "--set",
                 "dataset_loader=nusc", "--data_dir", "<scene>", "--set",
                 "track_start_opt=0"], ("obj",)),
    "fast": (["--config", "nuscenes_single_fast", "--set",
              "dataset_loader=synthetic"], ("nerf",)),
}


def record_refine_inputs(steps, sets=()):
    """{"<recipe> <grid>": recorded encode-backward call} of every recipe
    of REFINE_RECIPES (one step under the switch after `steps` steps of
    `train --deterministic`, `sets` passed on as --set arguments), and the
    refinement recipe's ray batch's camera indices (for
    `posenet_gathers`)."""
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.data import synth_nusc
    tag = f"hash_encode_bench_{os.getpid()}"
    scene = os.path.join("exp", tag + "_scene")
    synth_nusc.write_scene_dir(scene, sensor_num=1)
    out, cams = {}, None
    try:
        for recipe, (args, keep) in REFINE_RECIPES.items():
            argv = ["train", *(scene if a == "<scene>" else a for a in args),
                    *(a for kv in sets for a in ("--set", kv)),
                    "--steps", str(steps), "--device", "cuda",
                    "--exp_name", tag, "--deterministic"]
            out_dir = cli.exp_dir(cli.build_config(cli.parse_args(argv)))
            shutil.rmtree(out_dir, ignore_errors=True)
            try:
                run = cli.main(argv)
                with cli.deterministic_mode():
                    rec = record_train_inputs(run, steps)
                if recipe == "refine":
                    cams = run.batcher.next()["cam_idx"][..., 0].copy()
                    n_cams = run.posenet.r.shape[0]
                del run
            finally:
                shutil.rmtree(out_dir, ignore_errors=True)
            for name, call in rec.items():
                if name.startswith(keep):
                    out[f"{recipe} {name}"] = call
            del rec
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(scene, ignore_errors=True)
    return out, (cams, n_cams)


POS_ASKED = (False, True, True)


def pos_errs(name, got, want):
    """{"d_x01", "d_stds": error of max} of got against want; where want is
    all zero (the object grid's stds are 0), the same zeros. Raises above
    BWD_TOL."""
    out = {}
    for i, key in ((1, "d_x01"), (2, "d_stds")):
        if not bool(want[i].any()):
            if bool(got[i].any()):
                raise AssertionError(f"{name} {key}: not the zeros")
            out[key] = 0.0
            continue
        out[key] = max_rel_err(got[i], want[i])
        if not out[key] <= BWD_TOL:
            raise AssertionError(f"{name} {key}: error {out[key]} of max")
    return out


def residual_einsum(res, g_out):
    """The contraction's library yardstick: one `torch.einsum` over R [L, n,
    4, B, C] and g_out viewed as [B, L, C] ([B, n, 4]: d_x01 and d_stds)."""
    levels, _, _, b, c = res.shape
    return torch.einsum("ljqbc,blc->bjq", res, g_out.reshape(b, levels, c))


def refine_grid(root, name, rec):
    """--det --refine on one recorded call `rec` (table, x01, stds, g_out,
    spec, needs, cutoff): emits the call's times in turns with the --root
    checkout's where it is another, with the checks and yardsticks of the
    module docstring."""
    from nerf_lidar_tpu_torch.ops import grid
    here = here_grid()
    other = os.path.abspath(root) != HERE
    table, x01, stds, g_out, spec, needs = rec[:6]
    cutoff = rec[6] if len(rec) > 6 else 0
    n_ms = x01.shape[-2]
    b = stds.numel() // n_ms
    common = dict(root=root, what="pos_grads", grid=name,
                  mode=f"{spec.interp} C{spec.level_dim} cutoff {cutoff}",
                  B=b, n=n_ms, needs=list(needs))
    out, res = here.hash_encode_ms_residuals(table, x01, stds, spec, cutoff)
    if not torch.equal(out, here.hash_encode_multisample(table, x01, stds,
                                                          spec, cutoff)):
        raise SystemExit(f"{name}: residual-mode features are not H1's")
    res_err = max_rel_err(res, here.hash_encode_ms_residuals_plain(
        table, x01, stds, spec, cutoff))
    if not res_err <= BWD_TOL:
        raise SystemExit(f"{name}: R error {res_err} of max")
    got = here.pos_grads_from_residuals(res, g_out)
    runs = [here.pos_grads_from_residuals(res.clone(), g_out.clone())
            for _ in range(COPIES)]
    same = all(torch.equal(a, b_) for run in runs for a, b_ in zip(run, got))
    plain_same = all(torch.equal(a, b_) for a, b_ in zip(
        got, here.pos_grads_from_residuals_plain(res, g_out)))
    del runs
    if not (same and plain_same):
        raise SystemExit(f"hash_encode_ms_pos_grads {name}: not the same "
                         f"bits on copies ({same}) or as plain ({plain_same})")
    got = (None, got[0].reshape(x01.shape), got[1].reshape(stds.shape))
    fns = dict(
        h1=lambda: here.hash_encode_multisample(table, x01, stds, spec,
                                                cutoff),
        h1_resid=lambda: here.hash_encode_ms_residuals(table, x01, stds,
                                                       spec, cutoff),
        pos_grads=lambda: here.pos_grads_from_residuals(res, g_out),
        einsum=lambda: residual_einsum(res, g_out),
        atomic_table=lambda: here.hash_encode_multisample_bwd(
            table, x01, stds, g_out, spec, (True, False, False), cutoff),
        det_table=lambda: here.hash_encode_multisample_bwd_det(
            table, x01, stds, g_out, spec, (True, False, False), cutoff))
    errs, bits = {}, {}
    if other:
        root_det = grid.hash_encode_multisample_bwd_det(
            table, x01, stds, g_out, spec, POS_ASKED, cutoff)
        errs["vs root det"] = pos_errs(name, got, root_det)
        del root_det
        root_out, root_res = grid.hash_encode_ms_residuals(table, x01, stds,
                                                           spec, cutoff)
        bits = dict(features_as_root=torch.equal(out, root_out),
                    R_as_root=torch.equal(res, root_res),
                    det_table_as_root=torch.equal(
                        fns["det_table"]()[0],
                        grid.hash_encode_multisample_bwd_det(
                            table, x01, stds, g_out, spec,
                            (True, False, False), cutoff)[0]))
        del root_out, root_res
        root_fns = dict(
            h1=lambda: grid.hash_encode_multisample(table, x01, stds, spec,
                                                    cutoff),
            h1_resid=lambda: grid.hash_encode_ms_residuals(
                table, x01, stds, spec, cutoff),
            pos_det=lambda: grid.hash_encode_multisample_bwd_det(
                table, x01, stds, g_out, spec, POS_ASKED, cutoff),
            atomic_needs=lambda: grid.hash_encode_multisample_bwd(
                table, x01, stds, g_out, spec, needs, cutoff),
            atomic_table=lambda: grid.hash_encode_multisample_bwd(
                table, x01, stds, g_out, spec, (True, False, False), cutoff),
            det_table=lambda: grid.hash_encode_multisample_bwd_det(
                table, x01, stds, g_out, spec, (True, False, False), cutoff))
    turns = {}
    for tree in ("root", "here", "here", "root") if other else ("here",):
        for k, fn in (root_fns if tree == "root" else fns).items():
            turns.setdefault(f"{tree} {k}", []).append(
                queued_ms(fn, iters=10) or cuda_ms(fn))
    pad_turns(here, name, spec, stds.numel(), fns["atomic_table"])
    n_bytes, flops = fwd_bound(spec, x01, stds, cutoff)
    r_bytes = nbytes(res)
    emit(**common, ms=turns, max_rel_err=dict(errs, R=res_err),
         same_bits_on_copies=same, same_bits_as_plain=plain_same, **bits,
         r_gib=r_bytes / 2**30,
         h1_bound_ms=bound_ms(n_bytes, flops),
         h1_resid_bound_ms=bound_ms(n_bytes + r_bytes, flops),
         pos_grads_bound_ms=bound_ms(
             r_bytes + nbytes(g_out, x01, stds), 2 * res.numel()))
    del res


def posenet_gathers(cams, n_cams):
    """The posenet's per-ray gathers of a refinement step, forward and
    backward (an upstream gradient of ones), by CUDA events: advanced
    indexing (r[cam_id]), index_select (the posenet's) and
    `grid.select_rows`, outside and under torch's deterministic switch."""
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.ops import grid
    dev = torch.device("cuda", 0)
    cam = torch.as_tensor(cams, device=dev).long().reshape(-1)
    r = torch.zeros(n_cams, 3, device=dev, requires_grad=True)
    up = torch.ones(cam.shape[0], 3, device=dev)
    forms = dict(index=lambda: r[cam].backward(up),
                 index_select=lambda: r.index_select(0, cam).backward(up),
                 select_rows=lambda: grid.select_rows(r, cam).backward(up))
    out = {}
    for mode in ("default", "deterministic"):
        with (cli.deterministic_mode() if mode == "deterministic"
              else contextlib.nullcontext()):
            for k, f in forms.items():
                out[f"{mode} {k}"] = cuda_ms(f, iters=5, warmup=1)
    emit(what="posenet_gathers", rays=int(cam.shape[0]), images=n_cams,
         distinct=int(torch.unique(cam).numel()), ms=out)


def queued_ms(fn, iters=20):
    """Device ms per call of fn by CUDA events around `iters` calls queued
    behind a device sleep (`torch.cuda._sleep`), so the kernels run back
    to back and a wrapper's host side, longer than a short kernel, does not
    count. The sleep outlasts the host's enqueueing by twice its measured
    time, doubled up to twice more while the host outlasts it; None if it
    still does."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10**6)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10**6 / start.elapsed_time(end)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    sleep_ms = 2e3 * (time.perf_counter() - t) + 5
    for _ in range(3):
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        t = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = 1e3 * (time.perf_counter() - t)
        torch.cuda.synchronize()
        if queued < sleep_ms:
            return start.elapsed_time(end) / iters
        sleep_ms *= 2
    return None


def level_kind(spec, cutoff, l):
    """"mean-tiled", "point-hashed", ...: how level l encodes."""
    from nerf_lidar_tpu_torch.ops import grid
    return (("mean" if grid.mean_levels(spec, cutoff)[l] else "point") + "-"
            + ("tiled" if spec.is_tiled(l) else "hashed"))


def level_runs(spec, x01, cutoff, l):
    """The runs H1-bwd forms at level l: (sample ids [M], end step [M],
    cells [M, 3], corner weights [M, 8]), a run being a sample's
    consecutive in-range points in one cell (out-of-range points break
    none), ending at the step of the next in-range point in another cell
    (or n after the last point); a mean-point level has one run a sample at
    step 0. The erf weights are left out: they scale a run's corners
    alike and only decide which are non-zero where they underflow."""
    from nerf_lidar_tpu_torch.ops import grid
    n = x01.shape[-2]
    x = x01.reshape(-1, n, 3)
    b = x.shape[0]
    if grid.mean_levels(spec, cutoff)[l]:
        pts, oob = grid._in_range(grid._seq_mean(x))
        ids = torch.nonzero(~oob)[:, 0]
        return (ids, torch.zeros_like(ids), grid._cells(spec, l, pts[ids]),
                grid._cube_weights(spec, l, pts[ids]))
    pts, oob = grid._in_range(x.reshape(-1, 3))
    inside = (~oob).reshape(b, n)
    cells = grid._cells(spec, l, pts).reshape(b, n, 3)
    weights = grid._cube_weights(spec, l, pts).reshape(b, n, 8)
    have = torch.zeros(b, dtype=torch.bool, device=x.device)
    cur = torch.zeros((b, 3), dtype=torch.int64, device=x.device)
    acc = torch.zeros((b, 8), dtype=weights.dtype, device=x.device)
    out = []

    def emit(mask, step):
        ids = torch.nonzero(mask)[:, 0]
        out.append((ids, torch.full_like(ids, step), cur[ids], acc[ids]))

    for j in range(n):
        ins = inside[:, j]
        ends = ins & have & (cells[:, j] != cur).any(-1)
        emit(ends, j)
        start = ins & ~(have & ~ends)
        cur = torch.where(start[:, None], cells[:, j], cur)
        acc = torch.where(start[:, None], 0.0, acc)
        have = have | ins
        acc = torch.where(ins[:, None], acc + weights[:, j], acc)
    emit(have, n)
    return tuple(torch.cat([o[i] for o in out]) for i in range(4))


def row_updates(spec, x01, cutoff, l, warp=32):
    """Row updates of H1-bwd's d_table at level l on these points, counted
    on the host: "points" (every in-range point's corners of non-zero
    weight), "runs" (each run's), "issued" (after the merge of neighbouring
    lanes whose runs end at the same step in the same cell: what the
    atomic kernel adds), and the floors of a merge by row: the distinct
    (sample, row) and (warp, row) pairs. A warp is `warp` consecutive
    samples."""
    from nerf_lidar_tpu_torch.ops import grid
    ids, step, cells, w = level_runs(spec, x01, cutoff, l)
    nz = w != 0
    cc = cells[:, None, :] + torch.tensor(grid._CORNERS3,
                                          device=cells.device)
    rows = grid._corner_index(spec, l, cc[..., 0], cc[..., 1], cc[..., 2])
    r, b = rows[nz], ids[:, None].expand(-1, 8)[nz]
    per = spec.rows_per_level[l]
    order = torch.argsort(step * (1 << 40) + ids)
    ids, step, cells, w = ids[order], step[order], cells[order], w[order]
    joins = torch.zeros(len(ids), dtype=torch.bool, device=ids.device)
    joins[1:] = ((ids[1:] == ids[:-1] + 1) & (step[1:] == step[:-1])
                 & (cells[1:] == cells[:-1]).all(-1)
                 & (ids[1:] // warp == ids[:-1] // warp))
    seg = torch.cumsum(~joins, 0) - 1
    sums = torch.zeros((len(ids) and int(seg[-1]) + 1, 8), dtype=w.dtype,
                       device=w.device).index_add_(0, seg, w)
    pts = level_points(spec, x01, cutoff)[l]
    return dict(
        points=int((grid._cube_weights(spec, l, pts) != 0).sum()),
        runs=int(nz.sum()), issued=int((sums != 0).sum()),
        distinct_sample_rows=int(torch.unique(b * per + r).numel()),
        distinct_warp_rows=int(torch.unique((b // warp) * per + r).numel()))


def call_row_updates(spec, x01, cutoff=0):
    """`row_updates` summed over the levels: the row updates of one H1-bwd
    call on these points (its "runs" count is also the rows H1 reads, a
    run's corners of non-zero weight each)."""
    out = {}
    for l in range(spec.num_levels):
        for k, v in row_updates(spec, x01, cutoff, l).items():
            out[k] = out.get(k, 0) + v
    return out


def call_encode(lib, table, x, s, out, arrays, levels, c, tetra,
                level_major_order, walk_plan=None):
    """One launch of `lib`'s H1 (`nl_hash_encode_ms`) into out [B, levels
    * C]; arrays: the levels' constants (`grid._kernel_levels`, or a slice
    of them)."""
    from nerf_lidar_tpu_torch.ops import _build
    b, n_ms = s.shape
    ptrs = [table.data_ptr(), x.data_ptr(), s.data_ptr(), out.data_ptr()]
    if len(lib.nl_hash_encode_ms.argtypes) > 19:  # the residual pointer
        ptrs.append(None)
    rc = lib.nl_hash_encode_ms(
        *ptrs, b, n_ms, levels, c, *(a.ctypes.data for a in arrays), tetra,
        bool(level_major_order),
        *plan_slices(lib, "nl_hash_encode_ms", c, walk_plan),
        x.device.index, _build.stream_of(x))
    _build.check(lib, rc, "hash_encode_ms")


def in_turns(fns, other):
    """{name: [ms, ...]}: fns["here"] and, where `other`, fns["root"] timed
    in turns (root, here, here, root; else here, here) by `queued_ms`."""
    order = ("root", "here", "here", "root") if other else ("here", "here")
    times = {k: [] for k in dict.fromkeys(order)}
    for k in order:
        times[k].append(queued_ms(fns[k], iters=10) or cuda_ms(fns[k]))
    return times


def pad_turns(here, name, spec, points, fn):
    """Where this checkout's atomic backward may sum into padded rows (a
    general-path C % 4 != 0, `grid.pad_rows`): fn's (a call of `points`
    multisamples) device ms with the padded rows and without, in turns
    (pad, d_table, d_table, pad), and which the wrapper picks."""
    plan = here.walk_plan(spec.level_dim, "backward")
    if plan is None or not plan.padded:
        return
    real = here.pad_rows
    times = {}
    try:
        for mode in ("padded", "d_table", "d_table", "padded"):
            here.pad_rows = lambda *a, on=mode == "padded": on
            times.setdefault(mode, []).append(queued_ms(fn, iters=10)
                                              or cuda_ms(fn))
    finally:
        here.pad_rows = real
    emit(what="pad_rows", grid=name, C=spec.level_dim, rows=spec.total_rows,
         points=points, padded_by_the_wrapper=bool(real(spec, points, plan)),
         ms=times)


def config_grid(root, name, train, render):
    """--config on one grid: `train` (table, x01, stds, g_out, spec, needs,
    cutoff) of a train step's encode backward, `render` (table, x01, stds,
    spec, cutoff) of a render chunk's encode. Emits one line per level of
    each kernel and one per whole call."""
    from nerf_lidar_tpu_torch.ops import _build, grid
    here = here_grid()
    other = os.path.abspath(root) != HERE
    table, x01, stds, g_out, spec, needs, cutoff = train
    c, levels, tetra = spec.level_dim, spec.num_levels, spec.interp == "tetra"
    dev = x01.device.index
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    widths = getattr(grid, "_KERNEL_LEVEL_DIMS", None)
    if other and widths is not None and c not in widths:
        other = False  # the --root checkout's kernels do not take this C
    libs = dict(here=here._build.library(),
                **(dict(root=_build.library()) if other else {}))
    walks = dict(here=here.walk_plan,
                 root=getattr(grid, "walk_plan", None))
    order = here.level_major(spec, l2)
    arrays = here._kernel_levels(spec, cutoff)
    common = dict(root=root, grid=name, interp=spec.interp, C=c,
                  level_major=bool(order))
    for kernel, rec in (("hash_encode_ms_bwd", train),
                        ("hash_encode_ms", render)):
        x01, stds = rec[1], rec[2]
        n_ms = x01.shape[-2]
        x = x01.reshape(-1, n_ms, 3).contiguous()
        s = stds.reshape(-1, n_ms).contiguous()
        b = s.shape[0]
        g = g_out.reshape(b, spec.output_dim).contiguous() \
            if kernel == "hash_encode_ms_bwd" else None
        sink = (torch.zeros_like(table) if g is not None
                else torch.empty((b, c), device=x.device))
        plan = here.walk_plan(c, "backward")
        scratch = (torch.zeros((table.shape[0], plan.padded),
                               device=x.device)
                   if g is not None and here.pad_rows(spec, b * n_ms, plan)
                   else None)
        pts = level_points(spec, x01, cutoff)
        for l in range(levels):
            al = tuple(np.ascontiguousarray(a[l:l + 1]) for a in arrays)
            flops = 2 * pts[l].shape[0] * _corners_per_point(spec) * c
            if g is not None:
                gl = g[:, l * c:(l + 1) * c].contiguous()
                fns = {k: lambda lib=lib, k=k: call_float(
                    lib, table, x, s, gl, sink, al, 1, c, tetra, order,
                    scratch if k == "here" else None, walks[k])
                    for k, lib in libs.items()}
                n_bytes = (nbytes(x, s, gl)
                           + spec.rows_per_level[l] * c * 4)
                extra = dict(row_updates=row_updates(spec, x01, cutoff, l))
            else:
                fns = {k: lambda lib=lib, k=k: call_encode(
                    lib, table, x, s, sink, al, 1, c, tetra, order,
                    walks[k])
                    for k, lib in libs.items()}
                read = torch.zeros(spec.rows_per_level[l], dtype=torch.bool,
                                   device=x.device)
                for idx, _, _ in grid._corners(spec, l, pts[l]):
                    read[idx] = True
                n_bytes = nbytes(x, s, sink) + int(read.sum()) * c * 4
                extra = dict(rows_read=int(read.sum()))
            emit(**common, what="level", kernel=kernel, level=l,
                 kind=level_kind(spec, cutoff, l),
                 resolution=spec.resolutions[l],
                 rows=spec.rows_per_level[l], B=b, n=n_ms,
                 ms=in_turns(fns, other), bound_ms=bound_ms(n_bytes, flops),
                 bytes=n_bytes, flops=flops, **extra)
        del sink, scratch
        torch.cuda.empty_cache()
    # The whole calls through each checkout's wrapper, against the plain
    # versions.
    mods = dict(here=here, **(dict(root=grid) if other else {}))
    x01, stds = train[1], train[2]
    plain = grid.hash_encode_multisample_bwd_plain(
        table, x01, stds, g_out, spec, needs, cutoff)
    fns, errs = {}, {}
    for k, mod in mods.items():
        fns[k] = lambda mod=mod: mod.hash_encode_multisample_bwd(
            table, x01, stds, g_out, spec, needs, cutoff)
        errs[k] = check_bwd(fns[k](), plain, needs)
    del plain
    emit(**common, what="call", kernel="hash_encode_ms_bwd", inputs="train",
         needs=list(needs), ms=in_turns(fns, other), max_rel_err=errs,
         bound_ms=bound_ms(*bwd_bound(spec, x01, stds, g_out, cutoff)))
    pad_turns(here, name, spec, stds.numel(),
              lambda: here.hash_encode_multisample_bwd(
        table, x01, stds, g_out, spec, (True, False, False), cutoff))
    # The deterministic d_table through each checkout's wrapper: the same
    # bits in both (its int64 sums do not depend on their order).
    fns, dets = {}, {}
    for k, mod in mods.items():
        fns[k] = lambda mod=mod: mod.hash_encode_multisample_bwd_det(
            table, x01, stds, g_out, spec, (True, False, False), cutoff)[0]
        dets[k] = fns[k]()
    bits = (dict(d_table_as_root=torch.equal(dets["here"], dets["root"]))
            if other else {})
    del dets
    emit(**common, what="call", kernel="hash_encode_ms_bwd_det",
         inputs="train", ms=in_turns(fns, other), **bits,
         bound_ms=bound_ms(*bwd_bound(spec, x01, stds, g_out, cutoff)))
    for inputs, (rt, rx, rs) in (("render", render[:3]),
                                 ("train", (table, x01, stds))):
        want = grid.hash_encode_multisample_plain(rt, rx, rs, spec,
                                                  cutoff)[0]
        fns, errs, outs = {}, {}, {}
        for k, mod in mods.items():
            fns[k] = lambda mod=mod: mod.hash_encode_multisample(
                rt, rx, rs, spec, cutoff)
            outs[k] = fns[k]()
            errs[k] = check_fwd(f"hash_encode_ms {name} {inputs} {k}",
                                outs[k], want)
        bits = (dict(features_as_root=torch.equal(outs["here"],
                                                  outs["root"]))
                if other else {})
        del outs
        emit(**common, what="call", kernel="hash_encode_ms", inputs=inputs,
             B=rs.numel() // rs.shape[-1], ms=in_turns(fns, other),
             max_abs_err=errs, **bits,
             bound_ms=bound_ms(*fwd_bound(spec, rx, rs, cutoff)))
        del want


def config_bench(root, config, sets, steps):
    """--config: train `config` (the synthetic scene, `sets` as --set
    arguments) for `steps` steps, record one more step's encode-backward
    inputs and the first render chunk's encode inputs per grid, then
    `config_grid` on each."""
    from nerf_lidar_tpu_torch import cli
    tag = f"hash_encode_bench_{os.getpid()}"
    base = ["--config", config, "--set", "dataset_loader=synthetic",
            *(a for kv in sets for a in ("--set", kv)), "--device", "cuda",
            "--exp_name", tag]
    train_argv = ["train", *base, "--steps", str(steps)]
    out_dir = cli.exp_dir(cli.build_config(cli.parse_args(train_argv)))
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        run = cli.main(train_argv)
        train = record_train_inputs(run, steps)
        render_run = cli.main(["render_lidar", *base, "--mode", "simu",
                               "--num_sweeps", "1", "--params", run.params])
        render = record_render_inputs(
            render_run.renderer, render_run.sweeps[0], render_run.near,
            render_run.far, render_run.frame)
        del run, render_run
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    for name in list(train):
        config_grid(root, name, train.pop(name), render.pop(name))
        torch.cuda.empty_cache()


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
             ("sin_cos", r"\bsin|\bcos|sincos"),
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


_WAITS = r"cuda(Stream|Device)Synchronize|cudaMemcpy"


def wait_sites(events, steps: int):
    """{site: count per step} of the host's waits among profiler `events`
    (the runtime calls that `_WAITS` names): each wait is placed by
    time in the innermost op of its thread that encloses it, and named by
    that op and the innermost frame of the port on the stack of it or of
    an op around it."""
    from torch.autograd import DeviceType
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and not re.fullmatch(_WAITS, e.name)]
    sites = {}
    for w in events:
        if w.device_type == DeviceType.CUDA or not re.fullmatch(_WAITS,
                                                                w.name):
            continue
        # Innermost first, the wait's own thread before the others (the
        # Python tracer's events may carry another thread id).
        around = sorted(
            (e for e in ops if e.time_range.start <= w.time_range.start
             and e.time_range.end >= w.time_range.end),
            key=lambda e: (e.thread == w.thread, e.time_range.start),
            reverse=True)
        frame = next((f for e in around for f in [e.name, *(e.stack or [])]
                      if "nerf_lidar_tpu_torch/" in f
                      and "experiments" not in f), "outside the port")
        op = next((e.name for e in around if e.name.startswith("aten::")),
                  "no op")
        site = f"{w.name} in {op} at {frame}"
        sites[site] = sites.get(site, 0) + 1 / steps
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def host_wait_sites(run, step, steps=2):
    """Where warm train steps of the train entry's `run` make the host wait
    for the device: torch.profiler with Python stacks over `steps` steps
    (their batches staged before, no synchronisation after), the waits
    named by `wait_sites`."""
    from torch.profiler import ProfilerActivity, profile
    from nerf_lidar_tpu_torch import cli
    from nerf_lidar_tpu_torch.train import train_step
    dev = next(run.model.parameters()).device
    batches = [cli.to_device(run.batcher.next(), dev) for _ in range(steps)]
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities, with_stack=True) as prof:
        for i in range(steps):
            train_step.train_step(
                run.model, run.optimizer, run.cfg, batches[i], step + i,
                run.batcher.num_patch_rays, run.generator,
                posenet=run.posenet, tracknet=run.tracknet,
                tracks=run.tracks, track_mask=run.track_mask)
    torch.cuda.synchronize()
    return wait_sites(prof.events(), steps)


def record_inputs(steps):
    """{grid: (table, x01, stds, g_out, spec, needs)}: what one warm step of
    the train entry (nuscenes_single, synthetic scene, `steps` steps first)
    hands the encode backward."""
    from nerf_lidar_tpu_torch import cli
    argv = ["train", "--config", "nuscenes_single", "--set",
            "dataset_loader=synthetic", "--device", "cuda", "--exp_name",
            f"hash_encode_bench_{os.getpid()}", "--steps", str(steps)]
    out_dir = cli.exp_dir(cli.build_config(cli.parse_args(argv)))
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        run = cli.main(argv)
        train = record_train_inputs(run, steps)
        del run
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return train


def main(argv=None):
    p = argparse.ArgumentParser("hash_encode_bench")
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--copies", action="store_true")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--det", action="store_true")
    p.add_argument("--refine", action="store_true")
    p.add_argument("--save_inputs")
    p.add_argument("--inputs")
    p.add_argument("--config")
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
    if args.config:
        config_bench(root, args.config, args.set, args.steps)
        return
    if args.det and args.refine:
        if args.inputs:
            calls, cams = torch.load(args.inputs, weights_only=False)
        else:
            calls, cams = record_refine_inputs(args.steps, args.set)
            if args.save_inputs:
                torch.save((calls, cams), args.save_inputs)
        posenet_gathers(*cams)
        for name in list(calls):
            refine_grid(root, name, calls.pop(name))
            torch.cuda.empty_cache()
        return
    if args.det:
        if args.inputs:
            train = torch.load(args.inputs, weights_only=False)
        else:
            train = record_inputs(args.steps)
            if args.save_inputs:
                torch.save(train, args.save_inputs)
        for name in GRIDS:
            det_grid(root, name, train.pop(name), args.copies)
            torch.cuda.empty_cache()
        return
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
        # nuscenes_single's grids: no coarse cutoff.
        table, x01, stds, g_out, spec, needs = train[name][:6]
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
        table, x01, stds, spec = render[name][:4]
        for inputs, (x, s) in (("render", (x01, stds)),
                               ("uniform", uniform_like(x01, stds, 1))):
            measure_fwd(root, name, inputs, table, x, s, spec, args.copies)
        del render[name]
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
