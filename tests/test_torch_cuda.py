"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc: it carries the `cuda` marker
and skips without a card. This file imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: as tests/test_torch_render_fused.py for K1; features rtol 1e-5
/ atol 1e-6 for H1 (the kernels change only the order of float sums).
"""

import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu_torch.ops import grid, render_fused

pytestmark = pytest.mark.cuda

TOL = dict(weights=(1e-5, 1e-6), depth=(1e-4, 1e-5), acc=(1e-5, 1e-6),
           rgb=(1e-5, 1e-5), semantic=(1e-5, 1e-5), intensity=(1e-5, 1e-5))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda", 0)


def _composite_args(dev, r, s, k, with_int, opaque, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.rand(*shape, device=dev, generator=g)
    return dict(
        density=rand(r, s) * 3,
        tdist=torch.sort(rand(r, s + 1) * 5, dim=-1).values,
        dirs=torch.randn(r, 3, device=dev, generator=g),
        rgb=rand(r, s, 3), semantic=rand(r, s, k) if k else None,
        intensity=rand(r, s) if with_int else None,
        opaque_background=opaque, bg_value=0.5)


@pytest.mark.parametrize("r,s,k,with_int,opaque", [
    (1, 32, 19, True, True), (513, 32, 19, False, True),
    (700, 16, 5, True, False), (300, 64, 0, False, True)])
def test_composite_kernel_matches_plain(dev, r, s, k, with_int, opaque):
    args = _composite_args(dev, r, s, k, with_int, opaque)
    before = render_fused.fused_composite.launches
    got = render_fused.fused_composite(**args)
    assert render_fused.fused_composite.launches == before + 1
    want = render_fused.fused_composite_plain(**args)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for key, (rtol, atol) in TOL.items():
        if key in want:
            torch.testing.assert_close(got[key], want[key], rtol=rtol,
                                       atol=atol, msg=key)


def test_composite_kernel_takes_strided_inputs(dev):
    args = _composite_args(dev, 64, 8, 3, True, True)
    strided = dict(args, rgb=args["rgb"].transpose(0, 1).contiguous()
                   .transpose(0, 1))
    assert not strided["rgb"].is_contiguous()
    got = render_fused.fused_composite(**strided)
    want = render_fused.fused_composite(**args)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


@pytest.mark.parametrize("level_dim", [1, 2, 4])
def test_hash_encode_kernel_matches_plain(dev, level_dim):
    spec = grid.spec_for(configs.GridConfig(
        level_dim=level_dim, base_resolution=4, desired_resolution=96,
        log2_hashmap_size=9))
    g = torch.Generator(device=dev).manual_seed(level_dim)
    table = torch.rand(spec.total_rows, level_dim, device=dev,
                       generator=g) * 2 - 1
    x01 = torch.rand(3, 50, 7, 3, device=dev, generator=g) * 1.2 - 0.1
    stds = torch.rand(3, 50, 7, device=dev, generator=g) * 0.05 + 1e-4
    before = grid.hash_encode_multisample.launches
    got = grid.hash_encode_multisample(table, x01, stds, spec)
    assert grid.hash_encode_multisample.launches == before + 1
    want = grid.hash_encode_multisample_plain(table, x01, stds, spec)[0]
    torch.cuda.synchronize()
    assert got.shape == (3, 50, spec.output_dim)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_kernel_wrappers_reject_what_they_do_not_take(dev):
    spec = grid.spec_for(configs.tiny_debug().model.nerf_mlp.grid)
    table = torch.zeros(spec.total_rows, spec.level_dim, device=dev)
    x01 = torch.rand(4, 3, 3, device=dev)
    stds = torch.rand(4, 3, device=dev)
    with pytest.raises(ValueError, match="float32"):
        grid.hash_encode_multisample(table.double(), x01, stds, spec)
    with pytest.raises(ValueError, match="shape"):
        grid.hash_encode_multisample(table[:-8], x01, stds, spec)
    wide = grid.spec_for(configs.GridConfig(level_dim=8, base_resolution=4,
                                            desired_resolution=96,
                                            log2_hashmap_size=9))
    with pytest.raises(NotImplementedError, match="level_dim"):
        grid.hash_encode_multisample(
            torch.zeros(wide.total_rows, 8, device=dev), x01, stds, wide)
    args = _composite_args(dev, 8, 4, 2, False, True)
    with pytest.raises(ValueError, match="shape"):
        render_fused.fused_composite(**dict(args, tdist=args["tdist"][:, 1:]))
    with pytest.raises(ValueError, match="CUDA"):
        render_fused.fused_composite(**dict(args, dirs=args["dirs"].cpu()))
