"""The block order of kernel H1 and its backward
(`nerf_lidar_tpu_torch/ops/grid.py:level_major`) for the port's preset grids.

A hash table larger than the card's L2 runs level-major (and the kernels
stage each block's x01 / stds through shared memory); a smaller one runs a
tile's levels in neighbouring blocks. The wrapper reads the L2's size from
`torch.cuda.get_device_properties`: 50 MiB on the H100.
"""

import pytest
import torch

from nerf_lidar_tpu_torch import configs
from nerf_lidar_tpu_torch.ops import grid

H100_L2_BYTES = 50 * 2**20


def _grids(cfg):
    """{name: HashGridSpec} of a config's NeRF and proposal grids."""
    m = cfg.model
    return {"nerf": grid.spec_for(m.nerf_mlp.grid), **{
        f"prop{i}": grid.spec_for(m.prop_mlp_for_level(i).grid)
        for i in range(len(m.num_prop_samples))}}


def _table_bytes(spec):
    return spec.total_rows * spec.level_dim * 4


@pytest.mark.parametrize("name,table_bytes,major", [
    ("nerf", 239_928_960, True), ("prop0", 26_427_808, False),
    ("prop1", 43_205_024, False)])
def test_nuscenes_single_plan(name, table_bytes, major):
    """The reference recipe's grids on the H100: the NeRF grid (14,995,560
    rows x C4) runs level-major, the proposal grids side by side."""
    spec = _grids(configs.nuscenes_single())[name]
    assert _table_bytes(spec) == table_bytes
    assert grid.level_major(spec, H100_L2_BYTES) is major


@pytest.mark.parametrize("name", ["nerf", "prop0"])
def test_tiny_debug_plan(name):
    """tiny_debug's tables (105 KB and 12 KB) run side by side on the H100;
    the order turns level-major exactly when the table outgrows the L2."""
    spec = _grids(configs.tiny_debug())[name]
    size = _table_bytes(spec)
    assert not grid.level_major(spec, H100_L2_BYTES)
    assert not grid.level_major(spec, size)
    assert grid.level_major(spec, size - 1)


def test_wrapper_refuses_misaligned_rows():
    """Kernel H1 reads a row of C floats as one vector: the wrapper raises
    before a launch on a table or g_out that does not start on a 4C-byte
    boundary."""
    buf = torch.zeros(9)
    with pytest.raises(ValueError, match="16-byte aligned"):
        grid._aligned("table", buf[1:].view(2, 4), 4)
    assert grid._aligned("table", buf[:8].view(2, 4), 4) is not None
