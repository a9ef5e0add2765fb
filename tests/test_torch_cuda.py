"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc: it carries the `cuda` marker
and skips without a card. This file imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: as tests/test_torch_render_fused.py for K1; features rtol 1e-5
/ atol 1e-6 for H1 (the kernels change only the order of float sums, also
where they merge the corner weights of same-cell multisamples; cells,
fractions, tetrahedral ranks and mean points are computed with the plain
version's roundings, so both pick the same corners); the
H1 backward and K3 sum with atomics, in an order that changes from run to
run: gradients and scatter sums rtol 1e-4 / atol 1e-5 of the largest value.
The in-tile gathers copy values: exactly equal, NaN positions included.
The deterministic H1 backward and K3 (fixed-point terms summed in int64):
the same bits on fresh copies of their inputs, in both block orders and
at block sizes 64, 128 and 256; against the atomic kernels at the
tolerance above. The H1 backward's d_table against the float sum of the
same terms (the written-out twin, `index_add_`) at 4096 float32 eps of
each entry's summed |terms| plus half a quantum (2^-k) per term, and
against its plain twin (which rounds the same terms, each side once,
after the kernel's fused multiply-adds) at 4096 eps plus one quantum per
term. K3's variant rounds the same float32 values as its plain twin:
bit-identical to it, and within half a quantum a term of the float64 sum
plus the sum's one rounding to float32 (half its float32 ulp).
"""

import contextlib
import dataclasses

import pytest
import torch

from nerf_lidar_tpu_torch import configs
from nerf_lidar_tpu_torch.ops import grid, render_fused, tile_gather

pytestmark = pytest.mark.cuda

TOL = dict(weights=(1e-5, 1e-6), depth=(1e-4, 1e-5), acc=(1e-5, 1e-6),
           rgb=(1e-5, 1e-5), semantic=(1e-5, 1e-5), intensity=(1e-5, 1e-5))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda", 0)


def _composite_args(dev, r, s, k, with_int, opaque, seed=0, trained=False):
    """Seeded K1 inputs; `trained`: what a trained field hands K1 (log-normal
    densities up to 1e4, every 8th ray opaque at its first sample, every
    16th of zero density)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.rand(*shape, device=dev, generator=g)
    density = rand(r, s) * 3
    if trained:
        density = torch.exp(torch.randn(r, s, device=dev, generator=g) * 3
                            ).clamp(max=1e4)
        density[::8, 0] = 1e4
        density[::16] = 0.0
    return dict(
        density=density,
        tdist=torch.sort(rand(r, s + 1) * 5, dim=-1).values,
        dirs=torch.randn(r, 3, device=dev, generator=g),
        rgb=rand(r, s, 3), semantic=rand(r, s, k) if k else None,
        intensity=rand(r, s) if with_int else None,
        opaque_background=opaque, bg_value=0.5)


def _check_composite(args):
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


@pytest.mark.parametrize("r", [1, 2432, 16384])
@pytest.mark.parametrize("k", [0, 1, 19])
@pytest.mark.parametrize("s", [1, 31, 32, 33, 64, 128])
def test_composite_kernel_at_sample_and_class_counts(dev, s, k, r):
    """One warp per ray over 32-sample chunks (S = 1, a partial chunk, one
    whole chunk, a chunk and one sample, 2 and 4 chunks), with no, one and
    the slice's 19 classes; opaque and intensity alternate."""
    _check_composite(_composite_args(dev, r, s, k, with_int=s % 2 == 1,
                                     opaque=s != 33, seed=s + k))


@pytest.mark.parametrize("s", [32, 33])
@pytest.mark.parametrize("opaque", [True, False])
def test_composite_kernel_on_trained_like_inputs(dev, opaque, s):
    """Densities in the thousands, rays opaque at their first sample (T
    underflows to 0), rays of zero density (opaque: all weight on the last
    sample; not opaque: acc 0, depth 0, rgb = background)."""
    args = _composite_args(dev, 4096, s, 19, True, opaque, seed=5,
                           trained=True)
    _check_composite(args)
    out = render_fused.fused_composite(**args)
    zero = slice(None, None, 16)
    if opaque:
        assert bool((out["weights"][zero, -1] == 1).all())
    else:
        assert float(out["acc"][zero].abs().max()) == 0
        assert float(out["depth"][zero].abs().max()) == 0
        assert bool((out["rgb"][zero] == args["bg_value"]).all())


@pytest.mark.parametrize("k", [40, 2000, 13000])
def test_composite_kernel_at_wide_class_counts(dev, k):
    """More than 32 classes (a lane takes k, k + 32, ...), and channel sums
    that fit 6 rays in a block's 48 KiB (K = 2,000) or need one ray with
    more shared memory (K = 13,000)."""
    _check_composite(_composite_args(dev, 37, 33, k, True, True, seed=k))


@pytest.mark.parametrize("key", ["semantic", "rgb", "density"])
def test_composite_kernel_on_views_off_16_bytes(dev, key):
    """An input that starts 4 bytes into its storage (a contiguous view of
    a sliced buffer), with S K = 33 x 19 not a multiple of 4."""
    args = _composite_args(dev, 300, 33, 19, False, True, seed=3)
    t = args[key]
    buf = torch.empty(t.numel() + 1, device=dev)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    _check_composite(dict(args, **{key: view}))


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


def _close_to_max(got, want, name):
    scale = float(want.abs().max())
    assert scale > 0, name
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale,
                               msg=name)


@pytest.mark.parametrize("level_dim", [1, 2, 4])
def test_hash_encode_bwd_kernel_matches_plain(dev, level_dim):
    spec = grid.spec_for(configs.GridConfig(
        level_dim=level_dim, base_resolution=4, desired_resolution=96,
        log2_hashmap_size=9))
    g = torch.Generator(device=dev).manual_seed(10 + level_dim)
    table = torch.rand(spec.total_rows, level_dim, device=dev,
                       generator=g) * 2 - 1
    x01 = torch.rand(3, 50, 7, 3, device=dev, generator=g) * 1.2 - 0.1
    stds = torch.rand(3, 50, 7, device=dev, generator=g) * 0.05 + 1e-4
    g_out = torch.randn(3, 50, spec.output_dim, device=dev, generator=g)
    grads = {}
    for name, encode in (
            ("kernel", grid.hash_encode_multisample),
            ("plain", lambda *a: grid.hash_encode_multisample_plain(*a)[0])):
        leaves = [t.clone().requires_grad_(True) for t in (table, x01, stds)]
        out = encode(*leaves, spec)
        assert out.grad_fn is not None
        before = grid.hash_encode_multisample_bwd.launches
        out.backward(g_out)
        launched = grid.hash_encode_multisample_bwd.launches - before
        assert launched == (1 if name == "kernel" else 0)
        grads[name] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    written = grid.hash_encode_multisample_bwd_plain(table, x01, stds, g_out,
                                                     spec)
    for i, name in enumerate(("table", "x01", "stds")):
        _close_to_max(grads["kernel"][i], grads["plain"][i], name)
        _close_to_max(written[i], grads["plain"][i], f"bwd_plain {name}")


def _ray_points(dev, rays, samples, n, g):
    """[rays * samples, n, 3] points and stds along rays, as `cast_rays`
    makes them (the spiral of n multisamples per interval), mapped into the
    unit cube as the model's contraction leaves them."""
    from nerf_lidar_tpu_torch.ops import render
    normal = torch.nn.functional.normalize
    origins = torch.rand(rays, 3, device=dev, generator=g) * 0.4 - 0.2
    dirs = normal(torch.randn(rays, 3, device=dev, generator=g), dim=-1)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev).expand_as(dirs)
    base_x = normal(torch.cross(dirs, up, dim=-1), dim=-1)
    base_y = torch.cross(dirs, base_x, dim=-1)
    tdist = torch.linspace(0.05, 1.5, samples + 1, device=dev).expand(
        rays, samples + 1)
    radii = torch.full((rays, 1), 0.002, device=dev)
    means, stds = render.cast_rays(tdist, origins, dirs, base_x, base_y,
                                   radii, n=n)
    return ((means / 2 + 1) / 2).reshape(-1, n, 3), stds.reshape(-1, n)


def _merge_case(dev, spec, case, g):
    """Points that stress the corner-run merge of H1 and its backward."""
    b, n = 3000, 1 if case == "n1" else 7
    rand = lambda *shape: torch.rand(*shape, device=dev, generator=g)
    stds = rand(b, n) * 0.05 + 1e-4
    if case == "rays":
        return _ray_points(dev, 40, 75, n, g)
    if case in ("one_cell", "oob_breaks"):
        # All n points of a sample within 1e-4 of one point: one cell at
        # every coarse level.
        x01 = rand(b, 1, 3) * 0.9 + 0.05 + (rand(b, n, 3) - 0.5) * 2e-4
        if case == "oob_breaks":
            x01[:, 1::2, 0] = 1.5  # runs broken by out-of-range points
            x01[::3, :, 1] = -0.2  # samples with no point in range
        return x01, stds
    if case == "faces":
        # pos = x * scale + 0.5 exactly integral at level 2, and x = 1.0 or
        # 0.0 on some axes.
        k = torch.randint(0, int(spec.scales[2]), (b, n, 3), device=dev,
                          generator=g).float()
        x01 = (k + 0.5) / spec.scales[2]
        x01[:, 0, :] = 1.0
        x01[:, 1, 0] = 0.0
        return x01, stds
    return rand(b, n, 3) * 1.2 - 0.1, stds  # n1: uniform, one point each


def _check_encode_kernels(dev, spec, x01, stds, g, cutoff=0):
    """H1 vs plain (rtol 1e-5 / atol 1e-6) and its backward vs the
    written-out twin, d_table alone and all three gradients."""
    table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                       generator=g) * 2 - 1
    g_out = torch.randn(x01.shape[0], spec.output_dim, device=dev,
                        generator=g)
    before = grid.hash_encode_multisample.launches
    got = grid.hash_encode_multisample(table, x01, stds, spec, cutoff)
    assert grid.hash_encode_multisample.launches == before + 1
    want = grid.hash_encode_multisample_plain(table, x01, stds, spec,
                                              cutoff)[0]
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for needs in ((True, False, False), (True, True, True)):
        got = grid.hash_encode_multisample_bwd(table, x01, stds, g_out, spec,
                                               needs, cutoff)
        want = grid.hash_encode_multisample_bwd_plain(
            table, x01, stds, g_out, spec, needs, cutoff)
        torch.cuda.synchronize()
        for i, name in enumerate(("table", "x01", "stds")):
            if needs[i]:
                _close_to_max(got[i], want[i], f"{name} {needs}")


@pytest.mark.parametrize("case", ["one_cell", "rays", "oob_breaks", "faces",
                                  "n1"])
@pytest.mark.parametrize("level_dim", [1, 2, 4])
def test_hash_encode_kernels_on_merge_cases(dev, level_dim, case):
    """Tiled coarse levels (merged runs, aggregated updates on shared cells)
    and hashed fine ones."""
    spec = grid.spec_for(configs.GridConfig(
        level_dim=level_dim, base_resolution=4, desired_resolution=128,
        log2_hashmap_size=16))
    tiled = [spec.is_tiled(l) for l in range(spec.num_levels)]
    assert any(tiled) and not all(tiled)
    g = torch.Generator(device=dev).manual_seed(20 + level_dim)
    x01, stds = _merge_case(dev, spec, case, g)
    _check_encode_kernels(dev, spec, x01, stds, g)


def _mode_points(dev, spec, case, g):
    """Points of the new modes' cases: "ties" (x == y, and x == y == z on
    a third of the samples: tied fractional parts at every level, where
    the tetrahedral ranks break by axis order), "faces" (of _merge_case),
    "rays" (of _merge_case), "oob_mean" (clusters straddling x = 1, whose
    mean is out of range on some samples while points are in)."""
    if case in ("faces", "rays"):
        return _merge_case(dev, spec, case, g)
    b, n = 3000, 7
    rand = lambda *shape: torch.rand(*shape, device=dev, generator=g)
    stds = rand(b, n) * 0.05 + 1e-4
    if case == "ties":
        x01 = rand(b, n, 3) * 1.1 - 0.05
        x01[:, :, 1] = x01[:, :, 0]
        x01[::3, :, 2] = x01[::3, :, 0]
        return x01, stds
    x01 = rand(b, 1, 3) * 0.9 + 0.05 + (rand(b, n, 3) - 0.5) * 4e-3
    x01[::2, :, 0] = 1.0 + (rand(b // 2, n) - 0.5) * 4e-3
    return x01, stds


@pytest.mark.parametrize("case", ["ties", "faces", "rays", "oob_mean"])
@pytest.mark.parametrize("cutoff", [0, 40])
@pytest.mark.parametrize("interp", ["linear", "tetra"])
@pytest.mark.parametrize("level_dim", [1, 2, 4, 16])
def test_hash_encode_kernels_in_the_preset_modes(dev, level_dim, interp,
                                                 cutoff, case):
    """The presets' modes of H1 and its backward: tetrahedral
    interpolation, mean-point levels (cutoff 40: levels 5, 9, 17 and 33 at
    the mean; d_x01 / d_stds through the mean too) and C16 rows, on tiled
    and hashed levels, against the plain versions."""
    spec = grid.spec_for(configs.GridConfig(
        level_dim=level_dim, base_resolution=4, desired_resolution=128,
        log2_hashmap_size=16, interp=interp))
    assert any(grid.mean_levels(spec, cutoff)) == (cutoff > 0)
    g = torch.Generator(device=dev).manual_seed(60 + level_dim)
    x01, stds = _mode_points(dev, spec, case, g)
    _check_encode_kernels(dev, spec, x01, stds, g, cutoff)


@pytest.mark.parametrize("level_major", [False, True])
@pytest.mark.parametrize("preset", ["fast", "mxu"])
def test_hash_encode_kernels_on_the_preset_grids(dev, preset, level_major,
                                                 monkeypatch):
    """The fast NeRF grid (4 x C16, tetra, 8193 hashed at 2^17 rows, two
    mean-point levels) and the spectral band (17, 49 tiled C16, both at the
    mean), scatter-only (d_table), on ray points, in both block orders."""
    monkeypatch.setattr(grid, "level_major", lambda spec, l2: level_major)
    cfg = (configs.nuscenes_single_fast() if preset == "fast"
           else configs.nuscenes_single_mxu())
    mcfg = cfg.model.nerf_mlp
    spec = grid.spec_for(mcfg.grid)
    g = torch.Generator(device=dev).manual_seed(70)
    x01, stds = _ray_points(dev, 64, 32, 7, g)
    table = torch.rand(spec.total_rows, 16, device=dev, generator=g) * 0.2
    g_out = torch.randn(x01.shape[0], spec.output_dim, device=dev,
                        generator=g)
    cutoff = mcfg.ms_coarse_res_cutoff
    got = grid.hash_encode_multisample(table, x01, stds, spec, cutoff)
    want = grid.hash_encode_multisample_plain(table, x01, stds, spec,
                                              cutoff)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    leaf = table.clone().requires_grad_(True)
    before = grid.hash_encode_multisample_bwd.launches
    grid.hash_encode_multisample(leaf, x01.requires_grad_(True), stds, spec,
                                 cutoff).backward(g_out)
    assert grid.hash_encode_multisample_bwd.launches == before + 1
    assert x01.grad is None  # diff_inputs=False: no position gradient
    twin = grid.hash_encode_multisample_bwd_plain(
        table, x01.detach(), stds, g_out, spec, (True, False, False),
        cutoff)[0]
    torch.cuda.synchronize()
    _close_to_max(leaf.grad, twin, "d_table")


@pytest.mark.parametrize("level_major", [False, True])
@pytest.mark.parametrize("level_dim", [1, 4])
def test_hash_encode_kernels_in_both_block_orders(dev, level_dim,
                                                  level_major, monkeypatch):
    """Both block orders (`grid.level_major`: level-major with staged
    x01 / stds for tables larger than the L2, as the NeRF grid's; a tile's
    levels side by side, unstaged, for the others), forced on a small
    grid."""
    monkeypatch.setattr(grid, "level_major", lambda spec, l2: level_major)
    spec = grid.spec_for(configs.GridConfig(
        level_dim=level_dim, base_resolution=4, desired_resolution=128,
        log2_hashmap_size=16))
    g = torch.Generator(device=dev).manual_seed(40)
    x01, stds = _ray_points(dev, 30, 50, 7, g)
    _check_encode_kernels(dev, spec, x01, stds, g)


@pytest.mark.parametrize("n", [24, 25])
@pytest.mark.parametrize("level_dim", [1, 4])
def test_hash_encode_kernels_at_the_shared_memory_budget(dev, level_dim, n,
                                                         monkeypatch):
    """Level-major blocks stage their tile of x01 / stds (16 bytes a
    multisample, 128 samples) while it fits the 48 KB a block gets without
    opting in: n = 24 fills it exactly (49,152 bytes, staged), n = 25 does
    not (read from device memory)."""
    monkeypatch.setattr(grid, "level_major", lambda spec, l2: True)
    spec = grid.spec_for(configs.GridConfig(
        level_dim=level_dim, base_resolution=4, desired_resolution=128,
        log2_hashmap_size=16))
    g = torch.Generator(device=dev).manual_seed(30)
    x01, stds = _ray_points(dev, 16, 24, n, g)
    _check_encode_kernels(dev, spec, x01, stds, g)


@pytest.mark.parametrize("level_major", [False, True])
def test_hash_encode_kernels_as_the_object_encode(dev, level_major,
                                                  monkeypatch):
    """The object MLPs' encode (the JAX `hash_encode`): n = 1 and stds 0,
    where H1's erf weight is exactly 1, on the object grid's levels (C2,
    17 -> 1025) at a small hash size, points clustered in the unit box as
    the sample budget gives them; H1 vs plain, and H1-bwd's d_table and
    d_x01 (what track refinement asks) vs the written-out twin and vs
    plain autograd, in both block orders."""
    monkeypatch.setattr(grid, "level_major", lambda spec, l2: level_major)
    spec = grid.spec_for(dataclasses.replace(
        configs.nuscenes_single().model.obj_mlp.grid, log2_hashmap_size=14))
    g = torch.Generator(device=dev).manual_seed(50)
    x01 = (torch.rand(4000, 1, 3, device=dev, generator=g) * 0.3 + 0.35)
    x01[:1000] = x01[0]  # the budget's padding repeats one sample
    stds = torch.zeros(4000, 1, device=dev)
    table = torch.rand(spec.total_rows, 2, device=dev, generator=g) * 2 - 1
    g_out = torch.randn(4000, spec.output_dim, device=dev, generator=g)
    got = grid.hash_encode_multisample(table, x01, stds, spec)
    want = grid.hash_encode_multisample_plain(table, x01, stds, spec)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    needs = (True, True, False)
    got = grid.hash_encode_multisample_bwd(table, x01, stds, g_out, spec,
                                           needs)
    twin = grid.hash_encode_multisample_bwd_plain(table, x01, stds, g_out,
                                                  spec, needs)
    leaves = [t.clone().requires_grad_(True) for t in (table, x01)]
    auto = torch.autograd.grad(grid.hash_encode_multisample_plain(
        *leaves, stds, spec)[0], leaves, g_out)
    torch.cuda.synchronize()
    assert got[2] is None
    for i, name in enumerate(("table", "x01")):
        _close_to_max(got[i], twin[i], f"{name} vs twin")
        _close_to_max(got[i], auto[i], f"{name} vs autograd")


def test_hash_encode_bwd_kernel_table_only(dev):
    """The train path: positions need no gradient, so the kernel writes
    d_table alone."""
    spec = grid.spec_for(configs.tiny_debug().model.nerf_mlp.grid)
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.rand(spec.total_rows, spec.level_dim, device=dev,
                       generator=g).requires_grad_(True)
    x01 = torch.rand(64, 3, 3, device=dev, generator=g)
    stds = torch.rand(64, 3, device=dev, generator=g) * 0.01
    grid.hash_encode_multisample(table, x01, stds, spec).square().sum() \
        .backward()
    want = torch.autograd.grad(
        grid.hash_encode_multisample_plain(table, x01, stds, spec)[0]
        .square().sum(), table)[0]
    _close_to_max(table.grad, want, "table")


@pytest.mark.parametrize("rows,n,c", [(4096, 1 << 16, 16), (1 << 17, 5000, 1),
                                      (10, 100_000, 4), (7, 3, 2),
                                      (3, 100_003, 32)])
def test_scatter_add_rows_kernel_matches_index_add(dev, rows, n, c):
    g = torch.Generator(device=dev).manual_seed(rows)
    idx = torch.randint(-2, rows + 2, (n,), device=dev, generator=g,
                        dtype=torch.int32)
    vals = torch.randn(n, c, device=dev, generator=g, requires_grad=True)
    before = grid.scatter_add_rows.launches
    got = grid.scatter_add_rows(idx, vals, rows)
    assert grid.scatter_add_rows.launches == before + 1
    want = grid.scatter_add_rows_plain(idx, vals.detach(), rows)
    torch.cuda.synchronize()
    _close_to_max(got.detach(), want, "sum")
    g_out = torch.randn(rows, c, device=dev, generator=g)
    got.backward(g_out)
    ok = (idx >= 0) & (idx < rows)
    want_grad = torch.where(ok[:, None], g_out[idx.clamp(0, rows - 1).long()],
                            0.0)
    torch.testing.assert_close(vals.grad, want_grad, rtol=0, atol=0)


def test_kernel_wrappers_reject_what_they_do_not_take(dev):
    spec = grid.spec_for(configs.tiny_debug().model.nerf_mlp.grid)
    table = torch.zeros(spec.total_rows, spec.level_dim, device=dev)
    x01 = torch.rand(4, 3, 3, device=dev)
    stds = torch.rand(4, 3, device=dev)
    with pytest.raises(ValueError, match="float32"):
        grid.hash_encode_multisample(table.double(), x01, stds, spec)
    with pytest.raises(ValueError, match="shape"):
        grid.hash_encode_multisample(table[:-8], x01, stds, spec)
    # C8 is no preset's width: the kernel takes 1, 2, 4 and 16.
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

    # The H1 backward.
    g_out = torch.rand(4, spec.output_dim, device=dev)
    with pytest.raises(ValueError, match="g_out"):
        grid.hash_encode_multisample_bwd(table, x01, stds, g_out[:, 1:], spec)
    with pytest.raises(ValueError, match="float32"):
        grid.hash_encode_multisample_bwd(table, x01, stds, g_out.double(),
                                         spec)
    with pytest.raises(ValueError, match="CUDA"):
        grid.hash_encode_multisample_bwd(table, x01.cpu(), stds, g_out, spec)
    with pytest.raises(NotImplementedError, match="level_dim"):
        grid.hash_encode_multisample_bwd(
            torch.zeros(wide.total_rows, 8, device=dev), x01, stds,
            torch.rand(4, wide.output_dim, device=dev), wide)

    # K3.
    idx = torch.zeros(5, dtype=torch.int32, device=dev)
    vals = torch.rand(5, 16, device=dev)
    with pytest.raises(ValueError, match="int32"):
        grid.scatter_add_rows(idx.long(), vals, 8)
    with pytest.raises(ValueError, match="float32"):
        grid.scatter_add_rows(idx, vals.double(), 8)
    with pytest.raises(ValueError, match="CUDA"):
        grid.scatter_add_rows(idx, vals.cpu(), 8)
    with pytest.raises(ValueError, match="idx"):
        grid.scatter_add_rows(idx[:4], vals, 8)
    with pytest.raises(NotImplementedError, match="C in"):
        grid.scatter_add_rows(idx, vals[:, :3], 8)


def _sorted_case(dev, case, c, g):
    """(idx, vals, rows) of sorted-run cases of K3. "levels": the hash-decay
    use, every row of a level of tiny_debug's NeRF grid onto one output row;
    "long": 5 rows over 1,000,003 values, runs far longer than a block's
    chunk; "ones": every row once (runs of length 1); "oob": sorted runs
    with runs of out-of-range ids (-1, -7, rows + 2) cut into them. N * C
    is not a multiple of 4 for C = 1, 2 except in "levels"."""
    if case == "levels":
        spec = grid.spec_for(configs.tiny_debug().model.nerf_mlp.grid)
        table = torch.rand(spec.total_rows, c, device=dev, generator=g) * 2 - 1
        return grid.level_ids(spec, dev), table**2, spec.num_levels
    n, rows = {"long": (1_000_003, 5), "ones": (100_003, 100_003),
               "oob": (300_001, 40)}[case]
    if case == "ones":
        idx = torch.arange(n, device=dev, dtype=torch.int32)
    else:
        idx = torch.randint(0, rows, (n,), device=dev, generator=g,
                            dtype=torch.int32).sort().values
    if case == "oob":
        for start, bad in ((0, -1), (5_000, -7), (77_777, rows + 2),
                           (150_000, -1), (n - 3, rows + 2)):
            idx[start:start + 1_000] = bad
    return idx, torch.randn(n, c, device=dev, generator=g), rows


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("case", ["levels", "long", "ones", "oob"])
def test_scatter_add_rows_kernel_sums_sorted_segments(dev, case, c):
    """Sorted runs, which K3 sums per thread, per block and then with one
    atomic per channel group, against index_add_ in float64; then K3 through
    its C function into an `out` that already holds that sum."""
    from nerf_lidar_tpu_torch.ops import _build
    g = torch.Generator(device=dev).manual_seed(4 + c)
    idx, vals, rows = _sorted_case(dev, case, c, g)
    got = grid.scatter_add_rows(idx, vals, rows)
    want = grid.scatter_add_rows_plain(idx, vals.double(), rows)
    torch.cuda.synchronize()
    _close_to_max(got.double(), want, f"{case} sums")
    twice = got.clone()
    lib = _build.library()
    _build.check(lib, lib.nl_scatter_add_rows(
        idx.data_ptr(), vals.data_ptr(), twice.data_ptr(), idx.shape[0], c,
        rows, dev.index, _build.stream_of(vals)), "scatter_add_rows")
    torch.cuda.synchronize()
    _close_to_max(twice.double(), 2 * want, f"{case} added to a sum")


def test_scatter_add_rows_kernel_refuses_misaligned_inputs(dev):
    """K3 loads 16 bytes at a time: a view that starts 4 bytes into its
    storage is refused, not read by a slower path."""
    idx = torch.zeros(65, dtype=torch.int32, device=dev)
    vals = torch.rand(64 * 4 + 1, device=dev)
    with pytest.raises(ValueError, match="vals: expected a 16-byte"):
        grid.scatter_add_rows(idx[:64], vals[1:].view(64, 4), 8)
    with pytest.raises(ValueError, match="idx: expected a 16-byte"):
        grid.scatter_add_rows(idx[1:], vals[:-1].view(64, 4), 8)
    assert grid.scatter_add_rows(idx[:64], vals[:-1].view(64, 4), 8).shape \
        == (8, 4)


def _gather_indices(dev, shape, size, seed):
    """Indices in [-2 size, 2 size) (wrapped, in range and NaN cases) with
    the int32 extremes, -size, size and -1 in the first cells (as many as
    there are)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(-2 * size, 2 * size, shape, device=dev, generator=g,
                        dtype=torch.int32)
    edge = torch.tensor([-2**31, 2**31 - 1, -size, size, -1],
                        dtype=torch.int32)
    flat = idx.view(-1)
    flat[:5] = edge[:flat.numel()]
    return idx


@pytest.mark.parametrize("tbl_shape,idx_shape,axis", [
    ((8, 128), (8, 128), 1), ((256, 128), (256, 128), 1),
    ((128, 128), (128, 128), 0), ((8, 2**15), (8, 128), 1),
    ((8, 128), (1024, 8, 128), 1), ((96, 3), (5, 7, 3), 0),
    ((3, 20_000), (2, 3, 5), 1)])
def test_take_along_axis_kernel_matches_plain(dev, tbl_shape, idx_shape,
                                              axis):
    g = torch.Generator(device=dev).manual_seed(len(idx_shape))
    tbl = torch.randn(*tbl_shape, device=dev, generator=g)
    idx = _gather_indices(dev, idx_shape, tbl_shape[axis], 1)
    before = tile_gather.take_along_axis.launches
    got = tile_gather.take_along_axis(tbl, idx, axis)
    assert tile_gather.take_along_axis.launches == before + 1
    want = tile_gather.take_along_axis_plain(tbl, idx, axis)
    torch.cuda.synchronize()
    assert tile_gather.same_values(got, want)
    assert 0 < float(want.isnan().float().mean()) < 1


@pytest.mark.parametrize("tbl_shape,idx_shape,axis", [
    ((8, 128), (8, 127), 1), ((8, 130), (3, 8, 6), 1), ((7, 5), (9, 5), 0),
    ((96, 128), (4, 96, 128), 1), ((97, 128), (4, 97, 128), 1),
    ((97, 128), (33, 128), 0), ((1, 1), (1, 1, 1), 1)])
def test_take_along_axis_kernel_at_other_widths(dev, tbl_shape, idx_shape,
                                                axis):
    """J % 4 != 0 (one output a thread), a table of exactly 48 KiB (staged)
    and one row above it (read through __ldg), and a single element."""
    g = torch.Generator(device=dev).manual_seed(7)
    tbl = torch.randn(*tbl_shape, device=dev, generator=g)
    for seed in (0, 1):
        idx = (_gather_indices(dev, idx_shape, tbl_shape[axis], seed)
               if seed else torch.randint(0, tbl_shape[axis], idx_shape,
                                          device=dev, dtype=torch.int32))
        got = tile_gather.take_along_axis(tbl, idx, axis)
        assert tile_gather.same_values(
            got, tile_gather.take_along_axis_plain(tbl, idx, axis))


@pytest.mark.parametrize("which", ["tbl", "idx", "both"])
@pytest.mark.parametrize("tbl_shape,axis", [((8, 128), 1), ((128, 128), 0)])
def test_take_along_axis_kernel_on_views_off_16_bytes(dev, which, tbl_shape,
                                                      axis):
    """A table (staged: float copies instead of float4) or an index (int
    loads instead of int4) that starts 4 bytes into its storage."""
    g = torch.Generator(device=dev).manual_seed(8)
    a, b = tbl_shape
    tbl = torch.randn(a * b + 1, device=dev, generator=g)
    tbl = tbl[1:].view(a, b) if which != "idx" else tbl[:-1].view(a, b)
    shape = (3, a, b)
    idx = _gather_indices(dev, (3 * a * b + 1,), tbl_shape[axis], 2)
    idx = idx[1:].view(shape) if which != "tbl" else idx[:-1].view(shape)
    assert (tbl.data_ptr() % 16 != 0) == (which != "idx")
    assert (idx.data_ptr() % 16 != 0) == (which != "tbl")
    got = tile_gather.take_along_axis(tbl, idx, axis)
    assert tile_gather.same_values(
        got, tile_gather.take_along_axis_plain(tbl, idx, axis))


def test_take_along_axis_kernel_refuses_more_than_int32(dev):
    """The kernel's index math is 32-bit: 2^31 index elements are refused
    before any launch."""
    tbl = torch.randn(8, 128, device=dev)
    idx = torch.zeros(2**21, 8, 128, dtype=torch.int32, device=dev)
    before = tile_gather.tile_grid_gather.launches
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        tile_gather.tile_grid_gather(tbl, idx)
    assert tile_gather.tile_grid_gather.launches == before


def test_empty_kernel_launches(dev):
    """The launch-floor probe that chip_smoke.py [10] times."""
    from nerf_lidar_tpu_torch.ops import _build
    _build.launch_empty(dev)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name,idx_shape", [
    ("tile_lane_gather", (8, 128)), ("tile_grid_gather", (1024, 8, 128)),
    ("tile_grid_gather", (3, 8, 128))])
def test_tile_gather_kernels_match_plain(dev, name, idx_shape):
    """K2 and K5 on in-range and on out-of-range indices."""
    fn = getattr(tile_gather, name)
    plain = getattr(tile_gather, name + "_plain")
    tbl = torch.randn(8, 128, device=dev)
    for seed in (0, 1):
        idx = (_gather_indices(dev, idx_shape, 128, seed) if seed else
               torch.randint(0, 128, idx_shape, device=dev,
                             dtype=torch.int32))
        before = fn.launches
        got = fn(tbl, idx)
        assert fn.launches == before + 1
        assert tile_gather.same_values(got, plain(tbl, idx))


@pytest.mark.parametrize("r,c,n", [
    (512, 128, 256), (7, 1, 1000), (100_000, 16, 4096), (2**19, 16, 2**20),
    (300, 3, 999), (300, 4, 1000), (64, 130, 500), (50, 128, 1), (9, 16, 1),
    (5, 1, 1)])
def test_take_rows_kernel_matches_plain(dev, r, c, n):
    """float4 rows (C % 4 == 0), one lane to a warp per row, and single
    floats (C = 1, 3, 130), on in-range indices and on the NaN and wrap
    rule's."""
    tbl = torch.randn(r, c, device=dev)
    for idx in (torch.randint(0, r, (n,), device=dev, dtype=torch.int32),
                _gather_indices(dev, (n,), r, r)):
        before = tile_gather.take_rows.launches
        got = tile_gather.take_rows(tbl, idx)
        assert tile_gather.take_rows.launches == before + 1
        assert tile_gather.same_values(got,
                                       tile_gather.take_rows_plain(tbl, idx))


@pytest.mark.parametrize("c", [3, 16, 128])
@pytest.mark.parametrize("offset", ["row", "float"])
def test_take_rows_kernel_on_offset_table_views(dev, c, offset):
    """Tables that start one row ("row": on 16 bytes only for C % 4 == 0)
    or one float ("float": never on 16 bytes, row stride aligned for C % 4
    == 0) into their storage: the kernel copies float4s only where both
    hold, and equals the plain version either way."""
    r, n = 200, 333
    buf = torch.randn((r + 1) * c, device=dev)
    tbl = (buf[c:] if offset == "row" else buf[1:1 + r * c]).view(r, c)
    for seed in (0, 1):
        idx = (_gather_indices(dev, (n,), r, seed) if seed else
               torch.randint(0, r, (n,), device=dev, dtype=torch.int32))
        got = tile_gather.take_rows(tbl, idx)
        assert tile_gather.same_values(got,
                                       tile_gather.take_rows_plain(tbl, idx))


def test_gather_wrappers_reject_what_they_do_not_take(dev):
    tbl = torch.randn(8, 128, device=dev)
    idx = torch.zeros(8, 128, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        tile_gather.take_along_axis(tbl, idx.long(), 1)
    with pytest.raises(ValueError, match="float32"):
        tile_gather.take_rows(tbl.double(), idx[0])
    with pytest.raises(ValueError, match="fit in int32"):
        tile_gather.take_rows(tbl, torch.zeros(2**24, dtype=torch.int32,
                                               device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        tile_gather.tile_lane_gather(tbl, idx.cpu())


# ------------------------------------------------------------- ray-drop
def _raydrop_setup(dev, dtype, n=2, h=32, w=128):
    """A trainer on the card and one on the CPU with the same U-Net and VGG
    weights (seeded), and a seeded batch in `dtype`."""
    import numpy as np
    from nerf_lidar_tpu_torch.raydrop.trainer import (RayDropConfig,
                                                      RayDropTrainer)
    cfg = RayDropConfig(vgg=True)
    out = {}
    for where in (dev, torch.device("cpu")):
        tr = RayDropTrainer(cfg, seed=0, device=where)
        tr.vgg_model.to(dtype)
        st = tr.init_state(seed=3)
        st = tr.make_state(st.model.to(dtype))
        out[where.type] = (tr, st)
    rng = np.random.RandomState(0)
    images = rng.rand(n, h, w, 6).astype(np.float32)
    images[..., 0] *= rng.rand(n, h, w) > 0.3
    masks = (images[..., 0] > 0).astype(np.int64)
    return out, images, masks, images[..., 0] * 0.9


def test_raydrop_train_step_matches_cpu(dev):
    """One U-Net train step (CE + VGG with the Gumbel-hard mask, roll shift
    and noise given) on the card against the CPU, in float64, where no
    ReLU mask flips on rounding: loss rtol 1e-9, gradients and BatchNorm
    buffers 1e-9 of each tensor's max, the stepped weights 1e-9."""
    dtype = torch.float64
    pair, images, masks, ranges = _raydrop_setup(dev, dtype)
    noise = -torch.empty(2, 2, 32, 128, dtype=dtype).exponential_(
        generator=torch.Generator().manual_seed(1)).log()
    got = {}
    for where, (tr, st) in pair.items():
        d = torch.device(where if where == "cpu" else dev)
        batch = (torch.from_numpy(images).to(d, dtype).permute(0, 3, 1, 2),
                 torch.from_numpy(masks).to(d),
                 torch.from_numpy(ranges).to(d, dtype))
        st.model.train()
        stats = tr.train_step(st, *batch, shift=17, noise=noise.to(d))
        got[where] = (float(stats["loss"]), st.model)
    (loss_c, card), (loss_h, host) = got["cuda"], got["cpu"]
    assert abs(loss_c - loss_h) <= 1e-9 * abs(loss_h)
    for (name, p), q in zip(card.named_parameters(), host.parameters()):
        for a, b in ((p.grad, q.grad), (p.detach(), q.detach())):
            scale = float(b.abs().max())
            assert float((a.cpu() - b).abs().max()) <= 1e-9 * scale, name
    for (name, a), b in zip(card.named_buffers(), host.buffers()):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a.cpu() - b).abs().max()) <= 1e-9 * scale, name


def test_raydrop_predict_prob_matches_cpu(dev):
    """predict_prob (eval mode, float32, TF32 off) on the card against the
    CPU on the same weights: 1e-5 absolute."""
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pair, images, _, _ = _raydrop_setup(dev, torch.float32)
    (tc, sc), (th, sh) = pair["cuda"], pair["cpu"]
    got = tc.predict_prob(sc, images)
    want = th.predict_prob(sh, images)
    assert got.shape == want.shape == images.shape[:3]
    np.testing.assert_allclose(got, want, atol=1e-5)


EPS32 = 2.0**-23
DET_EPS_MULT = 4096


def _det_within(name, got, want, terms, counts, quantum, per_term):
    """|got - want| <= 4096 eps32 terms + per_term * quantum * counts."""
    err = (got.double() - want.double()).abs()
    allowed = DET_EPS_MULT * EPS32 * terms + per_term * quantum * counts
    bad = err > allowed
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} entries outside; worst excess "
        f"{float((err - allowed).max())}")


def _det_exact_within(name, got, exact, terms, counts, quantum):
    """|got - exact| <= quantum * counts / 2 + half got's float32 ulp +
    2^-53 terms counts: K3's deterministic variant against the float64 sum
    (each value rounded once to its quantum, the int64 sum exact, one
    rounding to float32)."""
    err = (got.double() - exact.double()).abs()
    mag = got.abs()
    ulp = (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
           ).double().clamp(min=2.0**-149)
    allowed = 0.5 * quantum * counts + 0.5 * ulp + 2.0**-53 * terms * counts
    bad = err > allowed
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} entries outside; worst excess "
        f"{float((err - allowed).max())}")


def _bit_identical(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@contextlib.contextmanager
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _det_case(dev, level_dim, interp, cutoff, case, seed):
    spec = grid.spec_for(configs.GridConfig(
        level_dim=level_dim, base_resolution=4, desired_resolution=128,
        log2_hashmap_size=16, interp=interp))
    g = torch.Generator(device=dev).manual_seed(seed)
    x01, stds = _mode_points(dev, spec, case, g)
    table = torch.rand(spec.total_rows, level_dim, device=dev,
                       generator=g) * 2 - 1
    g_out = torch.randn(x01.shape[0], spec.output_dim, device=dev,
                        generator=g)
    return spec, table, x01, stds, g_out


@pytest.mark.parametrize("case", ["ties", "rays", "oob_mean"])
@pytest.mark.parametrize("cutoff", [0, 40])
@pytest.mark.parametrize("interp", ["linear", "tetra"])
@pytest.mark.parametrize("level_dim", [1, 2, 4, 16])
def test_det_bwd_kernel_is_bit_identical_and_close(dev, level_dim, interp,
                                                   cutoff, case):
    """The deterministic backward: d_table, d_x01 and d_stds the same bits
    on 3 fresh copies of the inputs, in both block orders and at 64, 128
    and 256 threads a block; d_table against the float twin, the plain
    deterministic twin and the atomic kernel; d_x01 / d_stds (float sums
    in a fixed order) against the atomic kernel."""
    spec, table, x01, stds, g_out = _det_case(dev, level_dim, interp,
                                              cutoff, case, 80 + level_dim)
    args = (table, x01, stds, g_out, spec)
    before = (grid.hash_encode_multisample_bwd_det.launches,
              grid.hash_encode_multisample_bwd_det.position_launches,
              grid.hash_encode_multisample_bwd.launches)
    first = grid.hash_encode_multisample_bwd_det(
        *args, coarse_res_cutoff=cutoff)
    plans = [(lm, th) for lm in (False, True) for th in (64, 128, 256)]
    for lm, th in plans + [(None, 128)] * 2:
        copies = [t.clone() for t in args[:4]]
        got = grid.hash_encode_multisample_bwd_det(
            *copies, spec, coarse_res_cutoff=cutoff, level_major_order=lm,
            threads=th)
        for a, b in zip(got, first):
            assert torch.equal(a, b), (lm, th)
    assert (grid.hash_encode_multisample_bwd_det.launches,
            grid.hash_encode_multisample_bwd_det.position_launches,
            grid.hash_encode_multisample_bwd.launches) == (
        before[0] + 9, before[1] + 9, before[2])
    terms, counts = grid.table_grad_terms(x01, stds, g_out, spec, cutoff)
    quantum = grid.table_grad_quantum(g_out, spec)
    float_twin = grid.hash_encode_multisample_bwd_plain(
        *args, coarse_res_cutoff=cutoff)
    det_twin = grid.hash_encode_multisample_bwd_det_plain(
        *args, (True, False, False), cutoff)[0]
    atomic = grid.hash_encode_multisample_bwd(*args,
                                              coarse_res_cutoff=cutoff)
    torch.cuda.synchronize()
    _det_within("vs float twin", first[0], float_twin[0], terms, counts,
                quantum, 0.5)
    _det_within("vs det twin", first[0], det_twin, terms, counts, quantum,
                1.0)
    for i, name in enumerate(("table", "x01", "stds")):
        _close_to_max(first[i], atomic[i], f"{name} vs atomic")


@pytest.mark.parametrize("level_major", [False, True])
def test_det_bwd_kernel_as_the_object_encode(dev, level_major):
    """n = 1, stds 0 on the object grid (the track refinement's d_x01
    pass): bit-identical on fresh copies, against the atomic kernel."""
    spec = grid.spec_for(dataclasses.replace(
        configs.nuscenes_single().model.obj_mlp.grid, log2_hashmap_size=14))
    g = torch.Generator(device=dev).manual_seed(51)
    x01 = torch.rand(4000, 1, 3, device=dev, generator=g) * 0.3 + 0.35
    x01[:1000] = x01[0]
    stds = torch.zeros(4000, 1, device=dev)
    table = torch.rand(spec.total_rows, 2, device=dev, generator=g) * 2 - 1
    g_out = torch.randn(4000, spec.output_dim, device=dev, generator=g)
    needs = (True, True, False)
    runs = [grid.hash_encode_multisample_bwd_det(
        table.clone(), x01.clone(), stds.clone(), g_out.clone(), spec, needs,
        level_major_order=level_major) for _ in range(3)]
    atomic = grid.hash_encode_multisample_bwd(table, x01, stds, g_out, spec,
                                              needs)
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert torch.equal(run[0], runs[0][0])
        assert torch.equal(run[1], runs[0][1])
    assert runs[0][2] is None
    _close_to_max(runs[0][0], atomic[0], "table vs atomic")
    _close_to_max(runs[0][1], atomic[1], "x01 vs atomic")


def test_det_bwd_kernel_flags_non_finite_terms(dev):
    """NaN, +inf and -inf in g_out: the kernel's NaN / inf entries are the
    plain twin's, which are a float sum's (tests/test_torch_determinism.py
    holds that against JAX); the finite entries as above."""
    spec, table, x01, stds, g_out = _det_case(dev, 4, "linear", 0, "rays",
                                              90)
    for b, col, v in ((3, 0, float("nan")), (5, 1, float("inf")),
                      (6, 1, float("-inf")), (900, 4, float("inf")),
                      (1200, 23, float("-inf"))):
        g_out[b, col] = v
    got = grid.hash_encode_multisample_bwd_det(table, x01, stds, g_out,
                                               spec, (True, False, False))[0]
    want = grid.hash_encode_multisample_bwd_det_plain(
        table, x01, stds, g_out, spec, (True, False, False))[0]
    torch.cuda.synchronize()
    assert bool(torch.isnan(want).any()) and bool(torch.isinf(want).any())
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(want)), test.__name__
    terms, counts = grid.table_grad_terms(
        x01, stds, g_out.nan_to_num(nan=0.0, posinf=0.0, neginf=0.0), spec)
    _det_within("finite entries", got.nan_to_num(), want.nan_to_num(),
                terms, counts, grid.table_grad_quantum(g_out, spec), 1.0)


@pytest.mark.parametrize("scale", [1.0, 3.0, 2.0**-70, 2.0**60])
def test_det_kernels_at_the_int64_bound(dev, scale):
    """A single term equal to S (one point on a grid vertex, erf weight 1,
    one non-zero g_out), S a power of two or not, is 2^62 or just below
    it in int64, and comes back as itself; K3 alike."""
    spec = grid.spec_for(configs.GridConfig(
        level_dim=4, base_resolution=4, desired_resolution=128,
        log2_hashmap_size=16))
    x01 = torch.full((1, 1, 3), 0.5, device=dev)
    pos = grid.grid_pos(x01.reshape(1, 3), spec.scales[0])
    assert bool((pos == 2.0).all())  # scale 3: on a vertex, weight 1
    stds = torch.zeros(1, 1, device=dev)
    g_out = torch.zeros(1, spec.output_dim, device=dev)
    g_out[0, 2] = scale  # level 0, channel 2
    table = torch.zeros(spec.total_rows, 4, device=dev)
    got = grid.hash_encode_multisample_bwd_det(table, x01, stds, g_out,
                                               spec, (True, False, False))[0]
    want = grid.hash_encode_multisample_bwd_plain(
        table, x01, stds, g_out, spec, (True, False, False))[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want) and float(got.abs().max()) == scale
    vals = torch.zeros(8, 4, device=dev)
    vals[3, 1] = -scale
    idx = torch.arange(8, dtype=torch.int32, device=dev)
    out = grid.scatter_add_rows_det(idx, vals, 8)
    assert torch.equal(out, vals)


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("case", ["levels", "long", "ones", "oob"])
def test_det_scatter_kernel_is_bit_identical_and_close(dev, case, c):
    """The deterministic K3 on K3's sorted-run cases: the same bits on 3
    fresh copies, against index_add_ in float64 and its plain twin (the
    terms and counts of each output entry), and against the atomic K3."""
    g = torch.Generator(device=dev).manual_seed(14 + c)
    idx, vals, rows = _sorted_case(dev, case, c, g)
    before = (grid.scatter_add_rows_det.launches,
              grid.scatter_add_rows.launches)
    runs = [grid.scatter_add_rows_det(idx.clone(), vals.clone(), rows)
            for _ in range(3)]
    assert (grid.scatter_add_rows_det.launches,
            grid.scatter_add_rows.launches) == (before[0] + 3, before[1])
    atomic = grid.scatter_add_rows(idx, vals, rows)
    ok = (idx >= 0) & (idx < rows)
    i = idx[ok].long()
    terms = torch.zeros(rows, c, dtype=torch.float64, device=dev).index_add_(
        0, i, vals[ok].abs().double())
    counts = torch.zeros(rows, 1, dtype=torch.float64, device=dev).index_add_(
        0, i, torch.ones(len(i), 1, dtype=torch.float64, device=dev))
    quantum = torch.exp2(-grid.fixed_exponents(grid._abs_bound(vals))
                         .double())
    exact = grid.scatter_add_rows_plain(idx, vals.double(), rows)
    twin = grid.scatter_add_rows_det_plain(idx, vals, rows)
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert torch.equal(run, runs[0])
    _det_exact_within("vs float64", runs[0], exact, terms, counts, quantum)
    _bit_identical(runs[0], twin)
    _close_to_max(runs[0].double(), atomic.double(), "vs atomic")


@pytest.mark.parametrize("rows,n,c", [(1 << 17, 1 << 22, 16),
                                      (3, 100_003, 32)])
def test_det_scatter_kernel_at_its_own_shape(dev, rows, n, c):
    g = torch.Generator(device=dev).manual_seed(rows)
    idx = torch.randint(-2, rows + 2, (n,), device=dev, generator=g,
                        dtype=torch.int32)
    vals = torch.randn(n, c, device=dev, generator=g)
    vals[7, 0], vals[9, c - 1] = float("nan"), float("-inf")
    idx[7], idx[9] = 1, 2
    runs = [grid.scatter_add_rows_det(idx.clone(), vals.clone(), rows)
            for _ in range(3)]
    twin = grid.scatter_add_rows_det_plain(idx, vals, rows)
    torch.cuda.synchronize()
    for run in runs[1:]:
        _bit_identical(run, runs[0])
    _bit_identical(runs[0], twin)


def test_wrappers_launch_the_det_kernels_under_the_switch(dev):
    """Under torch.use_deterministic_algorithms: autograd through the
    encode and the differentiable K3 launch the deterministic kernels,
    never the atomic ones; the switch is restored after."""
    spec, table, x01, stds, g_out = _det_case(dev, 4, "linear", 0, "rays",
                                              95)
    leaves = [t.clone().requires_grad_(True) for t in (table, x01, stds)]
    counts = lambda: (grid.hash_encode_multisample_bwd_det.launches,
                      grid.hash_encode_multisample_bwd_det.position_launches,
                      grid.hash_encode_multisample_bwd.launches,
                      grid.scatter_add_rows_det.launches,
                      grid.scatter_add_rows.launches)
    before = counts()
    with _deterministic():
        grid.hash_encode_multisample(*leaves, spec).backward(g_out)
        sums = grid.scatter_add_rows(grid.level_ids(spec, dev),
                                     leaves[0]**2, spec.num_levels)
        sums.sum().backward()
    assert not torch.are_deterministic_algorithms_enabled()
    assert counts() == (before[0] + 1, before[1] + 1, before[2],
                        before[3] + 1, before[4])
