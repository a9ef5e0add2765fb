"""Kernel K1 (`composite`) and `take_along_axis` (K2, K4's forms 2, 4, 5,
K5) at the shapes the port gives them, on one GPU.

    python nerf_lidar_tpu_torch/experiments/composite_gather_bench.py \
        [--root DIR] [--chunk PATH] [--sass]

K1 at a render chunk (R = 16,384, S = 32, K = 19, opaque, no intensity) on
seeded inputs (densities uniform in [0, 3), as `chip_smoke.py` [3]) and on
seeded trained-like ones (log-normal densities up to 1e4, rays opaque at
their first sample, rays of zero density); `--chunk PATH`: also on the
inputs `chip_smoke.py` [9] recorded from a trained field's first render
chunk (`torch.save`d dict of `fused_composite` arguments). Each against
its plain version at `chip_smoke.py`'s tolerances. The gathers at the
gather bench's shapes, exactly against their plain versions, in turns with
`take_along_dim` (kernel, library, library, kernel). Device time per call
from torch.profiler (50 calls): CUDA events would time the wrappers' host
side, which is longer than these kernels. One JSON line a measurement,
after nvidia-smi's name and power limit of the card. Fails (non-zero exit)
on a wrong result.

--root DIR: import `nerf_lidar_tpu_torch` from the checkout at DIR (for
  example an earlier commit unpacked with `git archive`) to time its
  kernels the same way; they build into DIR. Run this file by its path, not
  with -m, for that.
--sass: also print, per kernel function of the built library whose name
  holds `composite` or `take_along_axis`, its SASS instruction count and
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
# K1 against its plain version, per output: (rtol, atol), as chip_smoke.py.
COMPOSITE_TOL = dict(weights=(1e-5, 1e-6), depth=(1e-4, 1e-5),
                     acc=(1e-5, 1e-6), rgb=(1e-5, 1e-5),
                     semantic=(1e-5, 1e-5), intensity=(1e-5, 1e-5))


def emit(**rec):
    print(json.dumps(rec), flush=True)


def device_ms(fn, iters=50):
    """Device milliseconds per call: the summed device activities of
    `iters` calls under torch.profiler (host gaps do not count). The
    tracer now and then drops activities from a session: a session counts
    only if each activity name appears a whole multiple of `iters` times;
    up to five are taken, then the last one counts each name's mean
    duration times its launches per call, rounded (as chip_smoke.py); if
    that is zero too, it fails."""
    import statistics
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
    if us <= 0:
        raise SystemExit("torch.profiler recorded no whole launch in five "
                         "sessions")
    return us / 1e3


def composite_inputs(dev, trained, seed, r=16384, s=32, k=19):
    """Seeded K1 inputs (opaque, no intensity), as chip_smoke.py makes
    them."""
    g = torch.Generator(device=dev).manual_seed(seed)
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
                rgb=rand(r, s, 3), semantic=rand(r, s, k), intensity=None,
                opaque_background=True, bg_value=1.0)


def bench_composite(root, dev, chunk_path):
    from nerf_lidar_tpu_torch.ops import render_fused as rf
    cases = [("seeded uniform", composite_inputs(dev, False, 0)),
             ("seeded trained-like", composite_inputs(dev, True, 1))]
    if chunk_path:
        chunk = torch.load(chunk_path, map_location=dev)
        cases.append(("trained chunk", chunk))
    for name, args in cases:
        got, want = rf.fused_composite(**args), rf.fused_composite_plain(
            **args)
        torch.cuda.synchronize()
        err = 0.0
        for key, (rtol, atol) in COMPOSITE_TOL.items():
            if key not in want:
                continue
            diff = (got[key] - want[key]).abs()
            if bool((diff > atol + rtol * want[key].abs()).any()) or not \
                    bool(torch.isfinite(got[key]).all()):
                raise SystemExit(f"composite {name} {key}: max abs err "
                                 f"{float(diff.max())}")
            err = max(err, float(diff.max()))
        n_bytes = sum(t.numel() * 4 for t in (*args.values(), *got.values())
                      if isinstance(t, torch.Tensor))
        emit(root=root, kernel="composite", inputs=name,
             shape=list(args["semantic"].shape), max_abs_err=err,
             device_ms=device_ms(lambda: rf.fused_composite(**args)),
             bound_ms=n_bytes / HBM_BYTES_PER_MS)


def bench_gathers(root, dev):
    from nerf_lidar_tpu_torch.ops import tile_gather as tg
    g = torch.Generator(device=dev).manual_seed(10)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=g)
    ids = lambda hi, *shape: torch.randint(0, hi, shape, device=dev,
                                           generator=g, dtype=torch.int32)
    # (name, kernel, tbl, idx, axis): K2, K4's forms 2, 4, 5 and K5 at the
    # gather bench's shapes.
    cases = [("K2 (8,128)", tg.tile_lane_gather, rnd(8, 128),
              ids(128, 8, 128), 1),
             ("K4 form 2 (256,128)", tg.take_along_axis, rnd(256, 128),
              ids(128, 256, 128), 1),
             ("K4 form 4 (128,128) axis 0", tg.take_along_axis,
              rnd(128, 128), ids(128, 128, 128), 0),
             ("K4 form 5 (8,2^15)", tg.take_along_axis, rnd(8, 2**15),
              ids(2**15, 8, 128), 1),
             ("K5 (8,128) x 1024 tiles", tg.tile_grid_gather, rnd(8, 128),
              ids(128, 1024, 8, 128), 1)]
    for name, fn, tbl, idx, axis in cases:
        rest = () if fn is not tg.take_along_axis else (axis,)
        kern = lambda: fn(tbl, idx, *rest)
        size = tbl.shape[axis]
        bad = torch.randint(-2 * size, 2 * size, idx.shape, device=dev,
                            generator=g, dtype=torch.int32)
        for case in (idx, bad):
            if not tg.same_values(fn(tbl, case, *rest),
                                  tg.take_along_axis_plain(tbl, case, axis)):
                raise SystemExit(f"{name}: the kernel differs from its plain "
                                 "version")
        src = tbl if idx.dim() == 2 else tbl[None]
        idx64 = idx.long()
        library = lambda: torch.take_along_dim(src, idx64, dim=axis - 2)
        turns = [device_ms(f) for f in (kern, library, library, kern)]
        emit(root=root, kernel="take_along_axis", shape=name,
             turns_kernel_library_library_kernel=turns)


def sass_summary(root, lib_path):
    from nerf_lidar_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    for block in re.split(r"\n\s*Function : ", out)[1:]:
        name = block.split("\n", 1)[0].strip()
        if "composite" not in name and "take_along_axis" not in name:
            continue
        lines = re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);", block)
        calls = sorted({ln.strip() for ln in lines if "CALL" in ln})
        emit(root=root, sass=name, instructions=len(lines), calls=calls)


def main(argv=None):
    p = argparse.ArgumentParser("composite_gather_bench")
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    p.add_argument("--chunk", default=None)
    p.add_argument("--sass", action="store_true")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    chunk = os.path.abspath(args.chunk) if args.chunk else None
    sys.path.insert(0, root)
    import nerf_lidar_tpu_torch
    if not os.path.abspath(nerf_lidar_tpu_torch.__file__).startswith(
            os.path.join(root, "")):
        raise SystemExit(f"nerf_lidar_tpu_torch was imported from "
                         f"{nerf_lidar_tpu_torch.__file__}, not {root}: run "
                         "this file by its path")
    from nerf_lidar_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        raise SystemExit("composite_gather_bench needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    _build.library()
    if args.sass:
        sass_summary(root, _build.library_path())
    bench_composite(root, dev, chunk)
    bench_gathers(root, dev)


if __name__ == "__main__":
    main()
