"""The port's in-tile gathers (`nerf_lidar_tpu_torch/ops/tile_gather.py`)
against the Pallas kernels K2, K4 and K5, run in interpret mode on the CPU;
and the port's gather bench at tiny sizes.

Every comparison is exact, NaN positions included: a gather copies values.
K4 and K5 live inside `experiments/gather_bench.py`; its `pl` is swapped for
a shim whose `pallas_call` forwards to the real one with `interpret=True`
and records each call, so their kernels run unchanged.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_lidar_tpu.ops import grid_pallas
from nerf_lidar_tpu_torch.experiments import gather_bench as tbench
from nerf_lidar_tpu_torch.ops import tile_gather

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from experiments import gather_bench as jbench  # noqa: E402


def _same(got: torch.Tensor, want) -> bool:
    return tile_gather.same_values(got, torch.from_numpy(np.array(want)))


def _indices(rng, shape, size, bad: bool) -> np.ndarray:
    """In-range int32 indices, or ones in [-2 size, 2 size) with the int32
    extremes, -size, size and -1 in the first cells."""
    if not bad:
        return rng.randint(0, size, shape).astype(np.int32)
    idx = rng.randint(-2 * size, 2 * size, shape).astype(np.int32)
    idx.reshape(-1)[:5] = [-2**31, 2**31 - 1, -size, size, -1]
    return idx


@pytest.mark.parametrize("bad", [False, True])
def test_tile_lane_gather_vs_pallas(bad):
    rng = np.random.RandomState(1 + bad)
    tbl = rng.randn(8, 128).astype(np.float32)
    idx = _indices(rng, (8, 128), 128, bad)
    want = np.asarray(grid_pallas.tile_lane_gather(jnp.asarray(tbl),
                                                   jnp.asarray(idx)))
    got = tile_gather.tile_lane_gather(torch.from_numpy(tbl),
                                       torch.from_numpy(idx))
    assert _same(got, want)
    assert np.isnan(want).any() == bad
    if bad:
        # -1 wraps to the last lane, size gives NaN.
        assert want[0, 4] == tbl[0, 127] and np.isnan(want[0, 3])


class _PallasShim:
    """Stands in for `pallas` in the JAX bench: forwards `pallas_call` with
    interpret=True and records (kernel, kwargs, args, out) of each call."""
    BlockSpec = pl.BlockSpec

    def __init__(self):
        self.calls = []

    def pallas_call(self, kernel, **kwargs):
        call = pl.pallas_call(kernel, interpret=True, **kwargs)

        def run(*args):
            out = call(*args)
            self.calls.append((kernel, kwargs, args, out))
            return out
        return run


# The port's counterpart of each form of the JAX `probe_mosaic_gather`,
# with the table axis its indices run along.
_FORMS = [
    (lambda t, i: tile_gather.tile_lane_gather(t, i), 1),
    (lambda t, i: tile_gather.take_along_axis(t, i, 1), 1),
    (lambda t, i: tile_gather.take_rows(t, i), 0),
    (lambda t, i: tile_gather.take_along_axis(t, i, 0), 0),
    (lambda t, i: tile_gather.take_along_axis(t, i, 1), 1),
]


def test_mosaic_forms_vs_pallas(monkeypatch, capsys):
    shim = _PallasShim()
    monkeypatch.setattr(jbench, "pl", shim)
    results = jbench.probe_mosaic_gather()
    assert list(results.values()) == ["ok"] * 5
    assert len(shim.calls) == 5
    for (form, _), (_, _, args, out) in zip(_FORMS, shim.calls):
        tbl, idx = (torch.from_numpy(np.array(a)) for a in args)
        assert _same(form(tbl, idx), out)
    # The port's bench builds the same five forms, in the same order.
    assert list(tbench.mosaic_forms("cpu")) == list(results)
    capsys.readouterr()


@pytest.mark.parametrize("bad", [False, True])
def test_k4_forms_out_of_range_vs_pallas(monkeypatch, capsys, bad):
    """Each K4 kernel body rerun in interpret mode on seeded indices, with
    negative and out-of-range ones when `bad`."""
    shim = _PallasShim()
    monkeypatch.setattr(jbench, "pl", shim)
    jbench.probe_mosaic_gather()
    capsys.readouterr()
    rng = np.random.RandomState(3 + bad)
    for (form, axis), (kernel, kwargs, args, _) in zip(_FORMS, shim.calls):
        tbl = rng.randn(*args[0].shape).astype(np.float32)
        idx = _indices(rng, args[1].shape, tbl.shape[axis], bad)
        want = pl.pallas_call(kernel, interpret=True, **kwargs)(
            jnp.asarray(tbl), jnp.asarray(idx))
        assert _same(form(torch.from_numpy(tbl), torch.from_numpy(idx)),
                     want)
        assert np.isnan(np.asarray(want)).any() == bad


@pytest.mark.parametrize("bad", [False, True])
def test_k5_tile_grid_vs_pallas(monkeypatch, capsys, bad):
    shim = _PallasShim()
    monkeypatch.setattr(jbench, "pl", shim)
    jbench.bench_pallas_tile_gather(512)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["probe"].startswith("pallas_tile_gather")
    kernel, kwargs, _, _ = shim.calls[0]
    assert kwargs["grid"] == (4,)
    rng = np.random.RandomState(5 + bad)
    tbl = rng.randn(8, 128).astype(np.float32)
    idx = _indices(rng, (4, 8, 128), 128, bad)
    want = pl.pallas_call(kernel, interpret=True, **kwargs)(
        jnp.asarray(tbl), jnp.asarray(idx))
    for port in (tile_gather.tile_grid_gather,
                 lambda t, i: tile_gather.take_along_axis(t, i, 1)):
        assert _same(port(torch.from_numpy(tbl), torch.from_numpy(idx)),
                     want)


def test_shape_checks():
    t, i = torch.zeros(8, 128), torch.zeros(8, 128, dtype=torch.int32)
    with pytest.raises(ValueError):
        tile_gather.tile_lane_gather(torch.zeros(16, 128), i)
    with pytest.raises(ValueError):
        tile_gather.tile_lane_gather(t, i[None])
    with pytest.raises(ValueError):
        tile_gather.tile_grid_gather(t, i)
    with pytest.raises(ValueError):
        tile_gather.tile_grid_gather(t, torch.zeros(2, 8, 64,
                                                    dtype=torch.int32))
    with pytest.raises(ValueError):
        tile_gather.take_along_axis(t, torch.zeros(4, 128, dtype=torch.int32),
                                    1)
    with pytest.raises(ValueError):
        tile_gather.take_along_axis(t, i, 2)
    with pytest.raises(ValueError):
        tile_gather.take_rows(t, i)


def _records(out: str):
    return [json.loads(line) for line in out.strip().splitlines()]


@pytest.mark.parametrize("probe, args, name", [
    (tbench.bench_gather_lane, (2**8, 4, 512), "gather_lane R=2^8 C=4 N=512"),
    (tbench.bench_gather_row, (2**8, 4, 512), "gather_row R=2^8 C=4 N=512"),
    (tbench.bench_gather_2d_idx, (2**8, 4, 512),
     "gather_2didx R=2^8 C=4 N=512"),
    (tbench.bench_gather_parallel_ops, (2**8, 4, 512, 4),
     "gather_4ops R=2^8 C=4 N=512"),
    (tbench.bench_scatter_add, (2**8, 4, 512), "scatter_lane R=2^8 C=4 N=512"),
    (tbench.bench_scatter_row, (2**8, 4, 512), "scatter_row R=2^8 C=4 N=512"),
    (tbench.bench_segment_sum, (2**8, 4, 512), "segment_sum R=2^8 C=4 N=512"),
    (tbench.bench_onehot_matmul, (2**6, 4, 256),
     "onehot_matmul R=2^6 C=4 N=256 bfloat16"),
    (tbench.bench_onehot_weighted, (2**6, 4, 256),
     "onehot_weighted R=2^6 C=4 N=256 K=4"),
    (tbench.bench_pallas_tile_gather, (512,),
     "pallas_tile_gather N=512 (8x128 lanes)"),
])
def test_bench_probes_on_cpu(probe, args, name, capsys):
    """Each probe prints one JSON line named as the JAX bench names it."""
    rec = probe(*args, device="cpu")
    (line,) = _records(capsys.readouterr().out)
    assert line == rec and set(line) == {"probe", "rate_M_per_s", "secs"}
    assert line["probe"] == name
    # Both are rounded (to 0.1 M/s and 0.1 ms): a slow CPU may print 0.
    assert line["rate_M_per_s"] >= 0 and line["secs"] >= 0


def test_bench_sorted_lane_name(capsys):
    tbench.bench_gather_lane(2**8, 4, 512, sort=True, device="cpu")
    assert _records(capsys.readouterr().out)[0]["probe"] == \
        "gather_lane R=2^8 C=4 N=512 sorted"


def test_bench_mosaic_probe_on_cpu(capsys):
    assert list(tbench.probe_mosaic_gather("cpu").values()) == ["ok"] * 5
    lines = _records(capsys.readouterr().out)
    assert [line["result"] for line in lines] == ["ok"] * 5


def test_bench_scatter_matches_reference():
    """The scatter probes' ops sum what a numpy loop sums."""
    rng = np.random.RandomState(7)
    idx = rng.randint(0, 16, 64).astype(np.int32)
    vals = rng.randn(64, 4).astype(np.float32)
    want = np.zeros((16, 4), np.float32)
    for i, v in zip(idx, vals):
        want[i] += v
    t_idx, t_vals = torch.from_numpy(idx), torch.from_numpy(vals)
    row = t_vals.new_zeros((16, 4)).index_add_(0, t_idx, t_vals)
    seg = t_vals.new_zeros((16, 4)).scatter_add_(
        0, t_idx.long()[:, None].expand(-1, 4), t_vals)
    lane = t_vals.new_zeros((4, 16)).index_add_(1, t_idx, t_vals.T)
    for got in (row, seg, lane.T):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_bench_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tbench.main([])
