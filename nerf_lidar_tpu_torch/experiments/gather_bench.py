"""Microbenchmarks of hash-table access primitives on one GPU (port of
`experiments/gather_bench.py`).

    python -m nerf_lidar_tpu_torch.experiments.gather_bench [--device cuda|cpu]

Runs every probe of the JAX bench's `main()` at its sizes, the hash grid's
production sizes (a 2^19-row x 16-channel table, 2^20 indices), and prints
one JSON line per probe: {"probe", "rate_M_per_s", "secs"}, or {"probe",
"result"} for the kernel forms of `probe_mosaic_gather`. On a card the
first line is nvidia-smi's name and power limit.

The probes that XLA ran as plain ops stay single torch calls: gathers
(`index_select`) on the [C, R] and [R, C] layouts, `index_add_`, the
segment sum (`scatter_add_`) and the bf16 one-hot and weighted one-hot
`torch.matmul` (bf16 output; XLA's kept float32). The Pallas probes run
through the port's CUDA kernels (`ops/tile_gather.py`):
`probe_mosaic_gather` holds each of its five forms exactly against its
plain version and raises on a mismatch; `bench_pallas_tile_gather` times
K5's counterpart.

Each timed probe chains LOOP iterations through its indices
(`(idx + 1 + chain) % R`, where `chain` is a zero computed from the
previous result) and reports the best of 3 runs after a warm-up: on a card
timed with CUDA events, on the CPU with the host clock.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import tile_gather

LOOP = 20


def timeit(fn, *args, iters=3):
    """Best seconds of fn(*args) (which returns a scalar tensor) over
    `iters` runs after one warm-up run."""
    dev = args[0].device
    float(fn(*args))  # warm-up
    best = float("inf")
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize(dev)
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            float(fn(*args))
            secs = time.perf_counter() - t0
        best = min(best, secs)
    return best


def report(name, n_ops, secs) -> Dict:
    rec = {"probe": name, "rate_M_per_s": round(n_ops / secs / 1e6, 1),
           "secs": round(secs, 4)}
    print(json.dumps(rec), flush=True)
    return rec


def chain_int(s: torch.Tensor) -> torch.Tensor:
    # int32 zero that depends on s, to chain loop iterations.
    return (s * 0).to(torch.int32)


def _gen(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def _randint(g, high, shape, device, dtype=torch.int32):
    return torch.randint(0, high, shape, generator=g, device=device,
                         dtype=dtype)


def _log2(r: int) -> int:
    return int(np.log2(r))


# ---------------------------------------------------------------- gathers
def bench_gather_lane(R, C, N, sort=False, device="cuda"):
    """tbl [C, R], gather along dim 1 — the JAX production form."""
    g = _gen(device)
    tbl = torch.randn(C, R, generator=g, device=device)
    idx = _randint(g, R, (N,), device)
    if sort:
        idx = torch.sort(idx).values

    def run(tbl, idx):
        acc = torch.zeros((), device=tbl.device)
        for _ in range(LOOP):
            out = tbl.index_select(1, idx)
            s = out[0].sum()
            idx, acc = (idx + 1 + chain_int(s)) % R, acc + s
        return acc

    secs = timeit(run, tbl, idx)
    return report(f"gather_lane R=2^{_log2(R)} C={C} N={N}"
                  + (" sorted" if sort else ""), N * LOOP, secs)


def bench_gather_row(R, C, N, device="cuda"):
    """tbl [R, C], gather rows along dim 0."""
    g = _gen(device)
    tbl = torch.randn(R, C, generator=g, device=device)
    idx = _randint(g, R, (N,), device)

    def run(tbl, idx):
        acc = torch.zeros((), device=tbl.device)
        for _ in range(LOOP):
            out = tbl.index_select(0, idx)
            s = out[:, 0].sum()
            idx, acc = (idx + 1 + chain_int(s)) % R, acc + s
        return acc

    secs = timeit(run, tbl, idx)
    return report(f"gather_row R=2^{_log2(R)} C={C} N={N}", N * LOOP, secs)


def bench_gather_2d_idx(R, C, N, device="cuda"):
    """idx shaped [N//128, 128] (2D) — lane-form gather of a 2D index."""
    g = _gen(device)
    tbl = torch.randn(C, R, generator=g, device=device)
    idx = _randint(g, R, (N // 128, 128), device)

    def run(tbl, idx):
        acc = torch.zeros((), device=tbl.device)
        for _ in range(LOOP):
            out = tbl.index_select(1, idx.reshape(-1)).reshape(
                (C,) + tuple(idx.shape))  # [C, N//128, 128]
            s = out[0].sum()
            idx, acc = (idx + 1 + chain_int(s)) % R, acc + s
        return acc

    secs = timeit(run, tbl, idx)
    return report(f"gather_2didx R=2^{_log2(R)} C={C} N={N}", N * LOOP,
                  secs)


def bench_gather_parallel_ops(R, C, N, k, device="cuda"):
    """k independent gather ops per iteration."""
    g = _gen(device)
    tbl = torch.randn(C, R, generator=g, device=device)
    idxs = [_randint(g, R, (N // k,), device) for _ in range(k)]

    def run(tbl, *idxs):
        acc = torch.zeros((), device=tbl.device)
        for _ in range(LOOP):
            s = 0.0
            for ix in idxs:
                s = s + tbl.index_select(1, ix)[0].sum()
            idxs = tuple((ix + 1 + chain_int(s)) % R for ix in idxs)
            acc = acc + s
        return acc

    secs = timeit(run, tbl, *idxs)
    return report(f"gather_{k}ops R=2^{_log2(R)} C={C} N={N}", N * LOOP,
                  secs)


# ---------------------------------------------------------------- scatter
def bench_scatter_add(R, C, N, device="cuda"):
    """zeros [C, R] index_add_ along dim 1 — the gather's transpose (lane
    form)."""
    g = _gen(device)
    idx = _randint(g, R, (N,), device)
    vals = torch.randn(C, N, generator=g, device=device)

    def run(idx, vals):
        acc = torch.zeros((), device=idx.device)
        for _ in range(LOOP):
            tbl = vals.new_zeros((C, R)).index_add_(1, idx, vals)
            s = tbl[0].sum()
            idx, acc = (idx + 1 + chain_int(s)) % R, acc + s
        return acc

    secs = timeit(run, idx, vals)
    return report(f"scatter_lane R=2^{_log2(R)} C={C} N={N}", N * LOOP,
                  secs)


def bench_scatter_row(R, C, N, device="cuda"):
    """zeros [R, C] index_add_ along dim 0 (the H1 backward's pattern)."""
    g = _gen(device)
    idx = _randint(g, R, (N,), device)
    vals = torch.randn(N, C, generator=g, device=device)

    def run(idx, vals):
        acc = torch.zeros((), device=idx.device)
        for _ in range(LOOP):
            tbl = vals.new_zeros((R, C)).index_add_(0, idx, vals)
            s = tbl[:, 0].sum()
            idx, acc = (idx + 1 + chain_int(s)) % R, acc + s
        return acc

    secs = timeit(run, idx, vals)
    return report(f"scatter_row R=2^{_log2(R)} C={C} N={N}", N * LOOP, secs)


def bench_segment_sum(R, C, N, device="cuda"):
    """The segment sum of unsorted ids, as `scatter_add_` (its index is
    int64, as torch requires)."""
    g = _gen(device)
    idx = _randint(g, R, (N,), device, torch.int64)
    vals = torch.randn(N, C, generator=g, device=device)

    def run(idx, vals):
        acc = torch.zeros((), device=idx.device)
        for _ in range(LOOP):
            tbl = vals.new_zeros((R, C)).scatter_add_(
                0, idx[:, None].expand(-1, C), vals)
            s = tbl[:, 0].sum()
            idx, acc = (idx + 1 + chain_int(s)) % R, acc + s
        return acc

    secs = timeit(run, idx, vals)
    return report(f"segment_sum R=2^{_log2(R)} C={C} N={N}", N * LOOP, secs)


# ---------------------------------------------------------- one-hot matmul
def bench_onehot_matmul(R, C, N, device="cuda"):
    """feats[n] = tbl[idx[n]] via one_hot(idx) @ tbl in bf16."""
    g = _gen(device)
    tbl = torch.randn(R, C, generator=g, device=device).to(torch.bfloat16)
    idx = _randint(g, R, (N,), device)

    def run(tbl, idx):
        acc = torch.zeros((), device=tbl.device)
        iota = torch.arange(R, device=tbl.device, dtype=torch.int32)
        for _ in range(LOOP):
            oh = (idx[:, None] == iota).to(torch.bfloat16)
            out = torch.matmul(oh, tbl).float()
            s = out[:, 0].sum()
            idx, acc = (idx + 1 + chain_int(s)) % R, acc + s
        return acc

    secs = timeit(run, tbl, idx)
    return report(f"onehot_matmul R=2^{_log2(R)} C={C} N={N} bfloat16",
                  N * LOOP, secs)


def bench_onehot_weighted(R, C, N, K=4, device="cuda"):
    """Fused interp: W[n, r] = sum_k w_k (idx_k[n] == r); feats = W @ tbl,
    one bf16 matmul for the gather and interpolation of K corners."""
    g = _gen(device)
    tbl = torch.randn(R, C, generator=g, device=device).to(torch.bfloat16)
    idx = _randint(g, R, (K, N), device)
    w = torch.rand(K, N, generator=g, device=device)

    def run(tbl, idx, w):
        acc = torch.zeros((), device=tbl.device)
        iota = torch.arange(R, device=tbl.device, dtype=torch.int32)[None]
        for _ in range(LOOP):
            W = 0.0
            for k in range(K):
                W = W + torch.where(idx[k][:, None] == iota, w[k][:, None],
                                    0.0)
            out = torch.matmul(W.to(torch.bfloat16), tbl).float()
            s = out[:, 0].sum()
            idx, acc = (idx + 1 + chain_int(s)) % R, acc + s
        return acc

    secs = timeit(run, tbl, idx, w)
    return report(f"onehot_weighted R=2^{_log2(R)} C={C} N={N} K={K}",
                  N * K * LOOP, secs)


# ------------------------------------------------------ in-kernel gathers
def mosaic_forms(device) -> Dict[str, tuple]:
    """The five gather forms of the JAX `probe_mosaic_gather`, at its shapes:
    name -> (wrapper, plain version, args)."""
    g = _gen(device)
    tg = tile_gather
    randn = lambda *shape: torch.randn(*shape, generator=g, device=device)
    return {
        # 1. lane gather within one (8, 128) tile: K2.
        "take_along_axis (8,128)": (
            tg.tile_lane_gather, tg.tile_lane_gather_plain,
            (randn(8, 128), _randint(g, 128, (8, 128), device))),
        # 2. lane gather on a taller tile.
        "take_along_axis (256,128)": (
            tg.take_along_axis, tg.take_along_axis_plain,
            (randn(256, 128), _randint(g, 128, (256, 128), device), 1)),
        # 3. row gather: out[n] = tbl[idx[n]].
        "take rows (512,128)<-256": (
            tg.take_rows, tg.take_rows_plain,
            (randn(512, 128), _randint(g, 512, (256,), device))),
        # 4. sublane gather on axis 0.
        "take_along_axis axis0 (128,128)": (
            tg.take_along_axis, tg.take_along_axis_plain,
            (randn(128, 128), _randint(g, 128, (128, 128), device), 0)),
        # 5. big-table lane gather.
        "take_along_axis (8, 2^15)": (
            tg.take_along_axis, tg.take_along_axis_plain,
            (randn(8, 2**15), _randint(g, 2**15, (8, 128), device), 1)),
    }


def probe_mosaic_gather(device="cuda") -> Dict[str, str]:
    """Each gather form of the JAX probe through the port's kernels, held
    exactly (NaN positions included) against its plain version; raises on
    a mismatch."""
    results = {}
    for name, (fn, plain, args) in mosaic_forms(device).items():
        got, want = fn(*args), plain(*args)
        if not tile_gather.same_values(got, want):
            raise RuntimeError(f"mosaic {name}: the kernel's output differs "
                               "from its plain version")
        results[name] = "ok"
        print(json.dumps({"probe": f"mosaic {name}", "result": "ok"}),
              flush=True)
    return results


def bench_pallas_tile_gather(N, device="cuda"):
    """The (8, 128) lane gather driven over a grid of N/128 index tiles
    (K5, `tile_grid_gather`)."""
    g = _gen(device)
    tbl = torch.randn(8, 128, generator=g, device=device)
    idx = _randint(g, 128, (N // 128, 8, 128), device)

    def run(tbl, idx):
        acc = torch.zeros((), device=tbl.device)
        for _ in range(LOOP):
            out = tile_gather.tile_grid_gather(tbl, idx)
            s = out[:, 0, 0].sum()
            idx, acc = (idx + 1 + chain_int(s)) % 128, acc + s
        return acc

    secs = timeit(run, tbl, idx)
    return report(f"pallas_tile_gather N={N} (8x128 lanes)", N * 8 * LOOP,
                  secs)


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    """Run every probe; returns the records printed."""
    p = argparse.ArgumentParser("gather_bench")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("gather_bench: no CUDA device is available "
                             "(pass --device cpu for a CPU run)")
        print(card_line(), flush=True)
        name = torch.cuda.get_device_name(0)
    else:
        name = "cpu"
    print(json.dumps({"devices": name}), flush=True)
    dev = torch.device(args.device)
    N = 2**20
    recs = [
        # Production-relevant sizes: fine level (2^19, C16), mid (2^17, C4).
        bench_gather_lane(2**19, 16, N, device=dev),
        bench_gather_lane(2**19, 16, N, sort=True, device=dev),
        bench_gather_lane(2**15, 16, N, device=dev),
        bench_gather_lane(2**12, 16, N, device=dev),
        bench_gather_row(2**19, 16, N, device=dev),
        bench_gather_2d_idx(2**19, 16, N, device=dev),
        bench_gather_parallel_ops(2**19, 16, N, 4, device=dev),
        bench_gather_lane(2**19, 16, N // 8, device=dev),
        bench_scatter_add(2**19, 16, N // 4, device=dev),
        bench_scatter_row(2**19, 16, N // 4, device=dev),
        bench_segment_sum(2**19, 16, N // 4, device=dev),
        bench_onehot_matmul(2**12, 16, 2**17, device=dev),
        bench_onehot_matmul(2**13, 16, 2**17, device=dev),
        bench_onehot_matmul(2**14, 16, 2**16, device=dev),
        bench_onehot_weighted(2**12, 16, 2**17, K=4, device=dev),
        bench_onehot_weighted(2**13, 16, 2**16, K=4, device=dev),
    ]
    recs += [{"probe": f"mosaic {k}", "result": v}
             for k, v in probe_mosaic_gather(device=dev).items()]
    recs.append(bench_pallas_tile_gather(2**17, device=dev))
    return recs


if __name__ == "__main__":
    main()
