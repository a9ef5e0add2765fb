"""The port's deterministic mode on the CPU: the plain twins of the
fixed-point kernels, the entry's `--deterministic`, and the ray-drop
resize that replaces `F.interpolate` under the switch.

- The deterministic H1 backward (`hash_encode_multisample_bwd_det_plain`,
  what CPU tensors take under `torch.use_deterministic_algorithms`) and K3
  (`scatter_add_rows_det_plain`) give bit-identical (`torch.equal`) sums
  under 5 seeded permutations of their samples / rows, in every mode of
  tests/test_torch_grid.py (trilinear / tetrahedral, a mean-point cutoff,
  C = 1, 2, 4, 16, diff_inputs on and off);
- against the JAX package: d_table against `_ms_encode_nodiff_bwd` and
  `jax.vjp` of `_ms_encode_impl`, K3 against `jax.ops.segment_sum`, at 64
  float32 eps of each entry's summed |terms| plus half a quantum (2^-k of
  its level and channel) per term; d_x01 / d_stds (float sums, no
  quantization) at tests/test_torch_grid_bwd.py's rtol 1e-4 / atol 1e-5;
- NaN, +inf and -inf planted in g_out / vals: the sums after nan_to_num
  equal JAX's float sums after nan_to_num (the train step scrubs the
  gradients so, `train_step._clip_and_scrub`);
- `train --deterministic`, 2 steps of tiny_debug, twice: bit-identical
  parameters, Adam moments and losses; the train step under the switch
  against the JAX train step at tests/test_torch_train.py's tolerances;
- `raydrop.unet.resize_bilinear` (interpolation matrices) against
  `F.interpolate(mode="bilinear", align_corners=False)`, forward and
  backward, within 1e-6 of the largest value; `raydrop.trainer`'s
  cross-entropy under the switch (log_softmax times a one-hot) against
  `F.cross_entropy` alike;
- `grid.select_rows` (the object path's row gathers, whose backward K3's
  deterministic variant sums under the switch) bit-identical under
  permuted indices and against index_select's float backward;
- two gloo ranks of `train --deterministic`, launched twice: the same
  bits on every rank and in both launches (the all-reduce at a fixed
  world size).

Every test that turns the switch on restores it (the `deterministic`
fixture): under pytest-xdist one worker runs many test files in turn.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_lidar_tpu.ops import grid as jgrid
from nerf_lidar_tpu.train import train_step as jtrain
from nerf_lidar_tpu_torch import cli
from nerf_lidar_tpu_torch.ops import grid
from nerf_lidar_tpu_torch.raydrop import trainer as rd_trainer
from nerf_lidar_tpu_torch.raydrop import unet
from nerf_lidar_tpu_torch.train import train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_grid import MODES, mode_inputs, mode_specs  # noqa: E402
from test_torch_train import _port_model, _tensors, setup  # noqa: E402,F401

EPS32 = 2.0**-23
EPS_MULT = 64
PERMUTATIONS = 5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this module runs: the tier runs several
    test files at once, and torch's CPU ops on every core of each worker
    oversubscribe the machine (as tests/test_torch_raydrop_train.py
    found)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms on for the test, restored after."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _terms_and_counts(spec, x01, stds, g_out, cutoff):
    return grid.table_grad_terms(*(torch.from_numpy(a) for a in
                                   (x01, stds, g_out)), spec, cutoff)


def _quantum_rows(spec, g_out):
    return grid.table_grad_quantum(torch.from_numpy(g_out), spec)


def _within(name, got, want, terms, counts, quantum):
    """|got - want| <= 64 eps32 terms + quantum / 2 per term, entrywise."""
    err = (got.double() - torch.as_tensor(np.array(want)).double()).abs()
    allowed = EPS_MULT * EPS32 * terms + 0.5 * quantum * counts
    bad = err > allowed
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} entries outside; worst excess "
        f"{float((err - allowed).max())}")


def _jax_table_grads(table, x01, stds, g_out, spec_j, cutoff):
    """(d_table from `_ms_encode_nodiff_bwd`, (d_table, d_x01, d_stds)
    from `jax.vjp` of `_ms_encode_impl`), each jitted as the train step
    runs them: XLA then fuses x * scale + 0.5 into one rounding, as the
    port computes it (eager JAX rounds twice and moves the corner
    weights of points near a cell face by ~1e-5)."""
    nodiff = jax.jit(lambda x, s, g: jgrid._ms_encode_nodiff_bwd(
        spec_j, cutoff, (x, s), (g, None))[0])

    @jax.jit
    def vjp(t, x, s, g):
        return jax.vjp(lambda t, x, s: jgrid._ms_encode_impl(
            t, x, s, spec_j, cutoff)[0], t, x, s)[1](g)

    args = [jnp.asarray(a) for a in (table, x01, stds, g_out)]
    return (np.asarray(nodiff(*args[1:])),
            [np.asarray(a) for a in vjp(*args)])


@pytest.mark.parametrize("diff_inputs", [True, False])
@pytest.mark.parametrize("interp,cutoff,c", MODES)
def test_det_bwd_is_bit_identical_under_permutation(interp, cutoff, c,
                                                    diff_inputs):
    spec, _ = mode_specs(interp, c, diff_inputs)
    table, x01, stds = (torch.from_numpy(a) for a in
                        mode_inputs(spec, seed=30 + c))
    g_out = torch.from_numpy(np.random.RandomState(c).randn(
        x01.shape[0], spec.output_dim).astype(np.float32))
    needs = (True, diff_inputs, diff_inputs)
    want = grid.hash_encode_multisample_bwd_det_plain(
        table, x01, stds, g_out, spec, needs, cutoff)
    assert float(want[0].abs().max()) > 0
    rng = np.random.RandomState(7)
    for _ in range(PERMUTATIONS):
        p = torch.from_numpy(rng.permutation(x01.shape[0]))
        got = grid.hash_encode_multisample_bwd_det_plain(
            table, x01[p], stds[p], g_out[p], spec, needs, cutoff)
        assert torch.equal(got[0], want[0])
        for i in (1, 2):
            if needs[i]:  # per sample: permuted with it, to the bit
                assert torch.equal(got[i], want[i][p])
            else:
                assert got[i] is None


def _uniform_inputs(spec, seed, b=48, n=5):
    """Seeded (table, x01 [b, n, 3], stds [b, n], g_out [b, L*C]): uniform
    points with out-of-range ones, and a third of the samples clustered
    within 5e-4 of one point (merged runs, mean points near their
    points). Unlike mode_inputs, no point sits on a cell face or a tie of
    fractions, where XLA's jitted float32 (the mean as a reduction) and
    the port's (the mean summed in order) may pick another cell or vertex
    (tests/test_torch_grid_bwd.py holds those at rtol 1e-4 / atol 1e-5)."""
    rng = np.random.RandomState(seed)
    table = rng.uniform(-1, 1, (spec.total_rows, spec.level_dim)).astype(
        np.float32)
    x01 = rng.uniform(-0.1, 1.1, (b, n, 3))
    x01[:b // 3] = (rng.uniform(0.05, 0.95, (b // 3, 1, 3))
                    + rng.uniform(-5e-4, 5e-4, (b // 3, n, 3)))
    stds = rng.uniform(1e-4, 0.05, (b, n)).astype(np.float32)
    g_out = rng.randn(b, spec.output_dim).astype(np.float32)
    return table, x01.astype(np.float32), stds, g_out


@pytest.mark.parametrize("interp,cutoff,c", MODES)
def test_det_bwd_matches_its_float_sum(interp, cutoff, c):
    """On mode_inputs' ties, faces and clusters: the deterministic d_table
    against the float sum of the same terms (the written-out backward),
    at the tolerance above."""
    spec, _ = mode_specs(interp, c)
    table, x01, stds = mode_inputs(spec, seed=40 + c)
    g_out = np.random.RandomState(50 + c).randn(
        x01.shape[0], spec.output_dim).astype(np.float32)
    args = [torch.from_numpy(a) for a in (table, x01, stds, g_out)]
    got = grid.hash_encode_multisample_bwd_det_plain(
        *args, spec, (True, False, False), cutoff)[0]
    want = grid.hash_encode_multisample_bwd_plain(
        *args, spec, (True, False, False), cutoff)[0]
    _within("vs the float sum", got, want,
            *_terms_and_counts(spec, x01, stds, g_out, cutoff),
            _quantum_rows(spec, g_out))


@pytest.mark.parametrize("interp,cutoff,c", MODES)
def test_det_bwd_matches_jax(interp, cutoff, c):
    spec, spec_j = mode_specs(interp, c)
    table, x01, stds, g_out = _uniform_inputs(spec, seed=40 + c)
    nodiff, (d_table, d_x01, d_stds) = _jax_table_grads(
        table, x01, stds, g_out, spec_j, cutoff)
    got = grid.hash_encode_multisample_bwd_det_plain(
        *(torch.from_numpy(a) for a in (table, x01, stds, g_out)), spec,
        coarse_res_cutoff=cutoff)
    terms, counts = _terms_and_counts(spec, x01, stds, g_out, cutoff)
    quantum = _quantum_rows(spec, g_out)
    # Mean-point levels: XLA's jitted mean (a reduction) and the port's
    # (summed in order) differ in the last bit, which moves the mean's
    # weights by tens of eps; those rows are held as
    # tests/test_torch_grid_bwd.py holds them, rtol 1e-4 / atol 1e-5.
    mean = torch.tensor(grid.mean_levels(spec, cutoff))[
        grid.level_ids(spec).long()]
    for name, want in (("jax.vjp", d_table), ("_ms_encode_nodiff_bwd",
                                               nodiff)):
        _within(f"vs {name}", got[0][~mean], want[~mean.numpy()],
                terms[~mean], counts[~mean], quantum[~mean])
        np.testing.assert_allclose(got[0][mean].numpy(), want[mean.numpy()],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    for name, a, b in (("x01", got[1], d_x01), ("stds", got[2], d_stds)):
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_det_bwd_routes_under_the_switch(deterministic):
    """Under the switch the wrapper, and autograd through the encode, give
    the deterministic twin's gradients to the bit."""
    spec, _ = mode_specs("linear", 4)
    table, x01, stds = (torch.from_numpy(a) for a in
                        mode_inputs(spec, seed=5))
    g_out = torch.randn(x01.shape[0], spec.output_dim,
                        generator=torch.Generator().manual_seed(0))
    want = grid.hash_encode_multisample_bwd_det_plain(table, x01, stds,
                                                      g_out, spec)
    got = grid.hash_encode_multisample_bwd(table, x01, stds, g_out, spec)
    leaves = [t.clone().requires_grad_(True) for t in (table, x01, stds)]
    grid.hash_encode_multisample(*leaves, spec).backward(g_out)
    for a, b, c in zip(got, want, leaves):
        assert torch.equal(a, b) and torch.equal(c.grad, b)
    plain = grid.hash_encode_multisample_bwd_plain(table, x01, stds, g_out,
                                                   spec)[0]
    assert not torch.equal(got[0], plain)  # the float sum is another path


def test_det_bwd_non_finite_terms_match_jax_after_nan_to_num():
    """NaN, +inf and -inf in g_out: every entry equals JAX's float sum
    (`jax.vjp`) after nan_to_num (rows with a NaN, with both infinities,
    with one; finite rows at the tolerance above). Uniform points: no
    corner weight is exactly 0, where a tetrahedral vertex would multiply
    inf by 0. (`_ms_encode_nodiff_bwd` spreads a NaN over whole levels
    there: its scatter multiplies the non-finite values by zeros.)"""
    for interp, c in (("linear", 4), ("tetra", 2)):
        spec, spec_j = mode_specs(interp, c)
        rng = np.random.RandomState(60 + c)
        table = rng.uniform(-1, 1, (spec.total_rows, c)).astype(np.float32)
        x01 = rng.uniform(0.02, 0.98, (48, 5, 3)).astype(np.float32)
        x01[:16] = x01[:16, :1]  # samples in one cell: merged runs
        stds = rng.uniform(1e-4, 0.05, (48, 5)).astype(np.float32)
        g_out = rng.randn(48, spec.output_dim).astype(np.float32)
        g_out[3, 0] = np.nan
        g_out[5, 1] = np.inf
        g_out[6, 1] = -np.inf
        g_out[9, c] = np.inf
        g_out[20, spec.output_dim - 1] = -np.inf
        want = _jax_table_grads(table, x01, stds, g_out, spec_j, 0)[1][0]
        got = grid.hash_encode_multisample_bwd_det_plain(
            *(torch.from_numpy(a) for a in (table, x01, stds, g_out)), spec,
            (True, False, False))[0]
        assert np.isnan(want).any() and np.isinf(want).any()
        assert torch.equal(torch.isnan(got), torch.from_numpy(np.isnan(want)))
        assert torch.equal(torch.isposinf(got),
                           torch.from_numpy(np.isposinf(want)))
        assert torch.equal(torch.isneginf(got),
                           torch.from_numpy(np.isneginf(want)))
        finite = np.isfinite(g_out)
        terms, counts = _terms_and_counts(spec, x01, stds,
                                          np.where(finite, g_out, 0), 0)
        _within(f"{interp} finite entries", got.nan_to_num(),
                np.nan_to_num(want), terms, counts,
                _quantum_rows(spec, g_out))


def _segment_inputs(c, seed, n=3000, rows=40):
    rng = np.random.RandomState(seed)
    idx = rng.randint(-2, rows + 2, n).astype(np.int32)
    vals = (rng.randn(n, c) * np.exp(rng.uniform(-8, 8, (n, 1)))).astype(
        np.float32)
    return idx, vals, rows


def _segment_tolerance(idx, vals, rows):
    ok = (idx >= 0) & (idx < rows)
    i = torch.from_numpy(idx[ok]).long()
    v = torch.from_numpy(vals[ok]).double()
    terms = torch.zeros(rows, vals.shape[1], dtype=torch.float64).index_add_(
        0, i, v.abs().nan_to_num(nan=0.0, posinf=0.0))
    counts = torch.zeros(rows, 1, dtype=torch.float64).index_add_(
        0, i, torch.ones(len(i), 1, dtype=torch.float64))
    k = grid.fixed_exponents(grid._abs_bound(torch.from_numpy(vals)))
    return terms, counts, torch.exp2(-k.double())


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16, 32, 3, 6, 12])
def test_det_scatter_is_bit_identical_under_permutation(c):
    idx, vals, rows = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                       else a for a in _segment_inputs(c, c))
    want = grid.scatter_add_rows_det_plain(idx, vals, rows)
    rng = np.random.RandomState(c)
    for _ in range(PERMUTATIONS):
        p = torch.from_numpy(rng.permutation(idx.shape[0]))
        assert torch.equal(grid.scatter_add_rows_det_plain(
            idx[p], vals[p], rows), want)


@pytest.mark.parametrize("c", [1, 4, 16, 3, 6, 12])
def test_det_scatter_matches_segment_sum(c):
    """Values over 16 binary orders of magnitude, indices out of range
    dropped (K3's one-hot drops them; segment_sum drops ids >= rows, so
    the JAX side is given the kept values)."""
    idx, vals, rows = _segment_inputs(c, 10 + c)
    ok = (idx >= 0) & (idx < rows)
    want = jax.ops.segment_sum(jnp.asarray(vals[ok]), jnp.asarray(idx[ok]),
                               num_segments=rows)
    got = grid.scatter_add_rows_det_plain(torch.from_numpy(idx),
                                          torch.from_numpy(vals), rows)
    _within("vs segment_sum", got, want, *_segment_tolerance(idx, vals,
                                                              rows))


def test_det_scatter_non_finite_and_routing(deterministic):
    """NaN / +-inf values against segment_sum after nan_to_num, through the
    differentiable wrapper under the switch (its gradient, a gather, is
    unchanged)."""
    idx, vals, rows = _segment_inputs(4, 3)
    vals[10, 0] = np.nan
    vals[11, 1] = np.inf
    vals[12, 1] = -np.inf
    vals[13, 2] = np.inf
    idx[10:14] = [1, 2, 2, 3]
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals[idx >= 0]),
                                          jnp.asarray(idx[idx >= 0]),
                                          num_segments=rows))
    v = torch.from_numpy(vals).requires_grad_(True)
    got = grid.scatter_add_rows(torch.from_numpy(idx), v, rows)
    torch.testing.assert_close(got.detach(), grid.scatter_add_rows_det_plain(
        torch.from_numpy(idx), v.detach(), rows), rtol=0, atol=0,
        equal_nan=True)
    assert torch.equal(torch.isnan(got), torch.from_numpy(np.isnan(want)))
    assert torch.equal(torch.isinf(got), torch.from_numpy(np.isinf(want)))
    terms, counts, quantum = _segment_tolerance(idx, vals, rows)
    _within("finite entries", got.detach().nan_to_num(),
            np.nan_to_num(want), terms, counts, quantum)
    got.backward(torch.ones_like(got))
    kept = torch.from_numpy((idx >= 0) & (idx < rows)).float()
    assert torch.equal(v.grad, kept[:, None].expand(-1, 4))


def test_fixed_exponents_bound_the_sums():
    """k = 62 - ceil(log2 S): a single term equal to S, and S a power of
    two, sum to at most 2^62 in int64; S = 0 takes k = 0."""
    s = torch.tensor([1.0, 0.75, 2.0**-30, 3e5, 0.0], dtype=torch.float64)
    k = grid.fixed_exponents(s)
    assert k.tolist() == [62, 62, 92, 62 - 19, 0]
    one = torch.tensor([[1.0]])
    out = grid.scatter_add_rows_det_plain(torch.zeros(1, dtype=torch.int32),
                                          one, 1)
    assert torch.equal(out, one)
    big = torch.tensor([[2.0**100], [-(2.0**99)], [2.0**99]])
    out = grid.scatter_add_rows_det_plain(torch.zeros(3, dtype=torch.int32),
                                          big, 1)
    assert out.item() == 2.0**100


def test_train_step_is_bit_identical_and_matches_jax(setup, deterministic):
    """Two deterministic 2-step runs of the port's train step from one init
    and batches: the same bits in every parameter, Adam moment and loss;
    the losses against the JAX train step at test_torch_train.py's rtol
    1e-4."""
    cfg, batches, jb, params, jmodel, _, jcfg = setup
    state, tx = jtrain.create_train_state(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params))
    step_fn = jtrain.make_train_step(jmodel, tx, jcfg, donate=False,
                                     num_patch_rays=64)
    runs = []
    for _ in range(2):
        model = _port_model(cfg, params)
        opt = train_step.make_optimizer(model, cfg)
        losses = [train_step.train_step(model, opt, cfg, _tensors(b), step,
                                        num_patch_rays=64)["loss"].detach()
                  for step, b in enumerate(batches)]
        runs.append((model, opt, torch.stack(losses)))
    (m0, o0, l0), (m1, o1, l1) = runs
    assert torch.equal(l0, l1)
    for (k, a), b in zip(m0.state_dict().items(), m1.state_dict().values()):
        assert torch.equal(a, b), k
    for p0, p1 in zip(m0.parameters(), m1.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(o0.state[p0][key], o1.state[p1][key])
    for step, jbatch in enumerate(jb):
        state, jstats = step_fn(state, jbatch, None)
        np.testing.assert_allclose(float(l0[step]), float(jstats["loss"]),
                                   rtol=1e-4)


def test_train_entry_deterministic_twice(tmp_path, monkeypatch):
    """`train --deterministic` twice (2 steps of tiny_debug on the CPU):
    the same losses and the same bits in every saved parameter and Adam
    moment; the switch is off again after each entry."""
    monkeypatch.chdir(tmp_path)
    runs = []
    for i in range(2):
        run = cli.main(["train", "--config", "tiny_debug", "--set",
                        "dataset_loader=synthetic", "--set", "print_every=1",
                        "--exp_name", f"det{i}", "--steps", "2",
                        "--device", "cpu", "--deterministic"])
        assert not torch.are_deterministic_algorithms_enabled()
        runs.append(run)
    a, b = runs
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    assert len(a.history) == 2
    pa, pb = np.load(a.params), np.load(b.params)
    assert sorted(pa.files) == sorted(pb.files)
    for k in pa.files:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    ca = torch.load(a.checkpoint, weights_only=False)
    cb = torch.load(b.checkpoint, weights_only=False)
    sa, sb = ca["optimizer"]["state"], cb["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k][key], sb[k][key])


@pytest.mark.parametrize("shape,size", [((2, 3, 4, 16), (8, 32)),
                                        ((1, 2, 4, 128), (32, 1024)),
                                        ((2, 1, 5, 7), (32, 64)),
                                        ((1, 2, 8, 8), (5, 3))])
def test_resize_matrices_match_interpolate(shape, size, deterministic):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    up = torch.randn(shape[:2] + size, generator=g, dtype=torch.float64)
    xa = x.clone().requires_grad_(True)
    xb = x.clone().requires_grad_(True)
    got = unet.resize_bilinear(xa, size)
    torch.use_deterministic_algorithms(False)
    want = F.interpolate(xb, size=size, mode="bilinear", align_corners=False)
    torch.use_deterministic_algorithms(True)
    got.backward(up)
    want.backward(up)
    for a, b in ((got, want), (xa.grad, xb.grad)):
        err = float((a - b).abs().max())
        assert err <= 1e-6 * float(b.abs().max()), err


@pytest.mark.parametrize("shape", [(2, 2, 8, 32), (1, 5, 3, 7)])
def test_one_hot_cross_entropy_matches_cross_entropy(shape, deterministic):
    g = torch.Generator().manual_seed(shape[1])
    logits = torch.randn(shape, generator=g, dtype=torch.float64) * 3
    target = torch.randint(0, shape[1], (shape[0],) + shape[2:], generator=g)
    la = logits.clone().requires_grad_(True)
    lb = logits.clone().requires_grad_(True)
    got = rd_trainer.cross_entropy(la, target)
    torch.use_deterministic_algorithms(False)
    want = F.cross_entropy(lb, target)
    torch.use_deterministic_algorithms(True)
    got.backward()
    want.backward()
    for a, b in ((got, want), (la.grad, lb.grad)):
        err = float((a - b).abs().max())
        assert err <= 1e-6 * float(b.abs().max()), err


def test_deterministic_mode_restores_the_switch():
    was = torch.are_deterministic_algorithms_enabled()
    with cli.deterministic_mode():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert not torch.backends.cudnn.benchmark
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"]
    assert torch.are_deterministic_algorithms_enabled() == was


@pytest.mark.parametrize("width", [3, 9, 40])
def test_select_rows_backward_under_the_switch(width, deterministic):
    """`grid.select_rows` (the object path's gathers): index_select forward;
    under the switch its backward is K3's deterministic sum, bit-identical
    under permuted indices and within 64 eps of each row's |terms| plus
    half a quantum a term of index_select's float backward."""
    rng = np.random.RandomState(width)
    src = torch.from_numpy(rng.randn(12, width).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 12, 500))
    g = torch.from_numpy(rng.randn(500, width).astype(np.float32))

    def grad(i, gg):
        leaf = src.clone().requires_grad_(True)
        out = grid.select_rows(leaf, i)
        assert torch.equal(out, src.index_select(0, i))
        out.backward(gg)
        return leaf.grad

    got = grad(idx, g)
    p = torch.from_numpy(rng.permutation(500))
    assert torch.equal(grad(idx[p], g[p]), got)
    want = torch.zeros_like(src).index_add_(0, idx, g)
    terms = torch.zeros_like(src, dtype=torch.float64).index_add_(
        0, idx, g.abs().double())
    counts = torch.zeros(12, 1, dtype=torch.float64).index_add_(
        0, idx, torch.ones(500, 1, dtype=torch.float64))
    k = torch.cat([grid.fixed_exponents(grid._abs_bound(g[:, c:c + 32]))
                   for c in range(0, width, 32)])
    _within("vs index_add_", got, want, terms, counts,
            torch.exp2(-k.double()).expand(12, -1))


def test_two_gloo_ranks_are_bit_identical_twice(tmp_path):
    """parallel/mesh.py's gradient all-reduce at a fixed world size: two
    launches of `train --deterministic` on two gloo ranks (2 steps of
    tiny_debug) give the same bits on every rank and in both launches."""
    import _torch_dp_worker as dp
    argv = ["train", "--config", "tiny_debug", "--set",
            "dataset_loader=synthetic", "--steps", "2", "--device", "cpu",
            "--deterministic", "--exp_name", "det"]
    states = []
    for i in range(2):
        workdir = tmp_path / f"launch{i}"
        workdir.mkdir()
        ranks = dp.launch([dict(fn="cli_runs", argvs=[argv])], 2,
                          str(workdir), 300)
        states += [r["results"][0]["runs"][0]["state"] for r in ranks]
    for state in states[1:]:
        assert state.keys() == states[0].keys()
        for k, v in states[0].items():
            np.testing.assert_array_equal(state[k], v, err_msg=k)
