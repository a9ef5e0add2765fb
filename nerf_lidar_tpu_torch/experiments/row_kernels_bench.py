"""Kernels K3 (`scatter_add_rows`) and `take_rows` (K4's row form) at the
shapes the port gives them, on one GPU.

    python nerf_lidar_tpu_torch/experiments/row_kernels_bench.py \
        [--root DIR] [--sass]

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
--sass: also print, per kernel function of the built library whose name
  holds `scatter_add_rows` or `take_rows`, its SASS instruction count and
  the subroutine calls in it (`cuobjdump -sass`, from nvcc's directory).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch

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


def rel_err(name, got, want, tol):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > tol * scale:
        raise SystemExit(f"{name}: max abs err {err} against max |want| "
                         f"{scale} (tolerance {tol} of it)")
    return err / scale


def bench_scatter(root, dev):
    from nerf_lidar_tpu_torch import configs
    from nerf_lidar_tpu_torch.ops import grid
    g = torch.Generator(device=dev).manual_seed(7)
    m = configs.nuscenes_single().model
    grids = [("nerf", m.nerf_mlp.grid)] + [
        (f"prop{i}", m.prop_mlp_for_level(i).grid)
        for i in range(len(m.num_prop_samples))]
    cases = []
    for name, grid_cfg in grids:
        spec = grid.spec_for(grid_cfg)
        table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                           generator=g) * 2 - 1
        cases.append((f"hash decay {name}", grid.level_ids(spec, dev),
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
    bench_scatter(root, dev)
    bench_take_rows(root, dev)


if __name__ == "__main__":
    main()
