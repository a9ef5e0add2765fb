"""The port's train step against the JAX package at `tiny_debug` shapes.

One `RayBatcher` batch of the synthetic scene (batch 256 with LiDAR rays, so
that the batch holds 8x8 patches for the smoothness terms) goes through the
JAX model (`key=None`) and the port's (no generator) with the same weights;
each loss term, the gradient of every parameter and two optimizer steps are
compared. Then the random branches, the entry and the train -> render
pipeline.

Tolerances: loss terms rtol 1e-5 / atol 1e-9 (measured: 1e-7 relative at
worst, 1.4e-5 on the 6e-6 interlevel term); gradients rtol 2e-3 / atol
1e-6 of the largest gradient of the parameter (measured: within 0.64 of
that bound; the resampling chain compounds last-bit differences of the
two frameworks' sums, and gradients add every sample's share in another
order); parameters after each step
atol 1e-5 (both steps move parameters by at most about the learning
rate, 3.1e-3 at the second step).
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu.cli import load_scene_for
from nerf_lidar_tpu.data.batching import RayBatcher
from nerf_lidar_tpu.lidar.render import \
    render_sweeps_to_dir as jax_render_sweeps_to_dir
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.ops import mathx as jmathx
from nerf_lidar_tpu.renderer import ChunkRenderer as JaxChunkRenderer
from nerf_lidar_tpu.train import losses as jlosses
from nerf_lidar_tpu.train import train_step as jtrain
from nerf_lidar_tpu_torch import cli, convert
from nerf_lidar_tpu_torch import configs as tconfigs
from nerf_lidar_tpu_torch.models.model import Model
from nerf_lidar_tpu_torch.ops import mathx, render, stepfun
from nerf_lidar_tpu_torch.train import losses, train_step


def _cfg(cfgs=configs):
    """The test's config, from the JAX `configs` or the port's."""
    return dataclasses.replace(cfgs.tiny_debug(), batch_size=256,
                               lidar_supervision=True,
                               dataset_loader="synthetic")


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    """The port's config, two batches, JAX params with informative tables,
    the JAX model, the JAX loss terms and gradients on the first batch at
    step 0, and the JAX config."""
    cfg = _cfg()
    scene = load_scene_for(cfg, "train")
    batcher = RayBatcher(scene.data, cfg.batch_size, cfg.patch_size,
                         lidar_supervision=True,
                         lidar_batch_ratio=cfg.lidar_batch_ratio, seed=0)
    assert batcher.num_patch_rays == 64
    batches = [batcher.next(), batcher.next()]
    jmodel = JaxModel(cfg.model)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), None, jb[0])
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(1)
    for sub in params["params"].values():
        sub["table"] = rng.uniform(-0.1, 0.1, sub["table"].shape).astype(
            np.float32)

    def loss_fn(p, batch):
        renderings, history = jmodel.apply(p, None, batch, train_frac=0.0,
                                           train=True)
        terms = jlosses.compute_losses(p, batch, renderings, history, cfg,
                                       0, num_patch_rays=64)
        return jlosses.total_loss(terms), terms

    (loss, terms), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jb[0])
    want = dict(terms=jax.tree_util.tree_map(np.asarray, terms),
                loss=float(loss),
                grads=convert.flatten_params(
                    jax.tree_util.tree_map(np.asarray, grads)))
    return _cfg(tconfigs), batches, jb, params, jmodel, want, cfg


def _port_model(cfg, params):
    model = Model(cfg.model)
    model.load_state_dict(convert.flax_to_state_dict(params, cfg.model))
    return model


def _port_losses(cfg, model, batch):
    renderings, history = model(_tensors(batch), train_frac=0.0, train=True)
    terms = losses.compute_losses(model, _tensors(batch), renderings,
                                  history, cfg, 0, num_patch_rays=64)
    return terms


def test_loss_terms_match_jax(setup):
    cfg, batches, _, params, _, want, _ = setup
    terms = _port_losses(cfg, _port_model(cfg, params), batches[0])
    assert set(terms) == set(want["terms"])
    assert {"data", "depth", "sem", "interlevel", "distortion",
            "hash_decay", "d_smo", "s_smo"} <= set(terms)
    for k, v in terms.items():
        np.testing.assert_allclose(v.detach().numpy(), want["terms"][k],
                                   rtol=1e-5, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(float(losses.total_loss(terms).detach()),
                               want["loss"], rtol=1e-5)


def test_every_gradient_matches_jax(setup):
    cfg, batches, _, params, _, want, _ = setup
    model = _port_model(cfg, params)
    losses.total_loss(_port_losses(cfg, model, batches[0])).backward()
    grads = convert.flatten_params(convert.state_dict_to_flax(
        {k: p.grad for k, p in model.named_parameters()}))
    assert set(grads) == set(want["grads"])
    for k, g in grads.items():
        w = want["grads"][k]
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-6 * scale,
                                   err_msg=k)


def test_two_steps_match_jax_train_step(setup):
    cfg, batches, jb, params, jmodel, _, jcfg = setup
    state, tx = jtrain.create_train_state(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params))
    step_fn = jtrain.make_train_step(jmodel, tx, jcfg, donate=False,
                                     num_patch_rays=64)
    model = _port_model(cfg, params)
    opt = train_step.make_optimizer(model, cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for step, (batch, jbatch) in enumerate(zip(batches, jb)):
        state, jstats = step_fn(state, jbatch, None)
        stats = train_step.train_step(model, opt, cfg, _tensors(batch), step,
                                      num_patch_rays=64)
        np.testing.assert_allclose(float(stats["loss"]),
                                   float(jstats["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(stats["psnr"]),
                                   float(jstats["psnr"]), rtol=1e-5)
        got = convert.flatten_params(
            convert.state_dict_to_flax(model.state_dict()))
        want = convert.flatten_params(
            jax.tree_util.tree_map(np.asarray, state.params))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=f"step {step} {k}")
        if step == 0:
            # optax evaluates the schedule at count 0 for the first update:
            # lr(0) ~ 1e-10 with the warm-up, so nothing moves yet.
            moved = max(float((model.state_dict()[k] - v).abs().max())
                        for k, v in before.items())
            assert moved < 1e-8
    assert int(state.step) == 2


@pytest.mark.parametrize("cfg_fn", [configs.tiny_debug,
                                    configs.nuscenes_single])
def test_learning_rate_decay_matches_jax(cfg_fn):
    c = cfg_fn()
    fn = train_step.lr_schedule(getattr(tconfigs, cfg_fn.__name__)())
    for step in (0, 1, 2, 3, 5, 7, 49, 50, 1000, 5000, 12345, 25000, 30000):
        want = float(jmathx.learning_rate_decay(
            jnp.asarray(step), c.lr_init, c.lr_final, c.max_steps,
            c.lr_delay_steps, c.lr_delay_mult))
        np.testing.assert_allclose(fn(step), want, rtol=1e-6)
    assert mathx.learning_rate_decay(0, 1.0, 0.1, 10) == 1.0
    assert mathx.learning_rate_decay(10, 1.0, 0.1, 10) == pytest.approx(0.1)


def test_jittered_sampling_is_sorted_in_domain_and_seeded():
    rng = np.random.RandomState(3)
    t = torch.from_numpy(np.sort(rng.rand(40, 17).astype(np.float32), -1))
    logits = torch.from_numpy(rng.randn(40, 16).astype(np.float32))
    draw = lambda seed, single: stepfun.sample_intervals(
        t, logits, 24, domain=(0.0, 1.0), single_jitter=single,
        generator=torch.Generator().manual_seed(seed))
    fixed = stepfun.sample_intervals(t, logits, 24, domain=(0.0, 1.0))
    for single in (True, False):
        a = draw(5, single)
        assert a.shape == (40, 25)
        assert bool((a[..., 1:] >= a[..., :-1]).all())
        assert bool((a >= 0).all()) and bool((a <= 1).all())
        torch.testing.assert_close(a, draw(5, single), rtol=0, atol=0)
        assert not torch.equal(a, draw(6, single))
        assert not torch.equal(a, fixed)


def test_random_spiral_phase_keeps_radius_and_is_seeded():
    rng = np.random.RandomState(4)
    d = rng.randn(30, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    bx = np.cross(d, [0.0, 0.0, 1.0])
    bx /= np.linalg.norm(bx, axis=-1, keepdims=True)
    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in (
        np.sort(rng.uniform(0.5, 6.0, (30, 9)), -1), rng.randn(30, 3) * 0.1,
        d, bx, np.cross(d, bx), np.full((30, 1), 5e-3))]
    cast = lambda g: render.cast_rays(*args, n=7, m=3, generator=g)
    m0, s0 = cast(None)
    m1, s1 = cast(torch.Generator().manual_seed(0))
    torch.testing.assert_close(s1, s0, rtol=0, atol=0)
    # The phase turns each point about the ray axis: its distance from the
    # axis and its depth along it stay.
    o, dirs = args[1][:, None, None], args[2][:, None, None]
    for m in (m0, m1):
        rel = m - o
        along = (rel * dirs).sum(-1)
        radial = (rel - along[..., None] * dirs).norm(dim=-1)
        if m is m0:
            ref = (along, radial)
        torch.testing.assert_close(along, ref[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(radial, ref[1], rtol=1e-3, atol=1e-6)
    assert float((m1 - m0).abs().max()) > 1e-4
    torch.testing.assert_close(
        m1, cast(torch.Generator().manual_seed(0))[0], rtol=0, atol=0)


def test_train_forward_with_generator_is_seeded(setup):
    cfg, batches, _, params, _, _, _ = setup
    model = _port_model(cfg, params)
    run = lambda seed: model(_tensors(batches[0]), train_frac=0.3,
                             train=True,
                             generator=torch.Generator().manual_seed(seed))
    (r1, h1), (r2, _) = run(0), run(0)
    torch.testing.assert_close(r1[-1]["depth"], r2[-1]["depth"], rtol=0,
                               atol=0)
    for level in h1:
        s = level["sdist"]
        assert not s.requires_grad  # stop_level_grad
        assert bool((s[..., 1:] >= s[..., :-1]).all())
    assert level["weights"].requires_grad


def test_unported_losses_and_refinement_raise():
    """What still refuses: a data loss neither package has (JAX's
    `data_loss` raises NotImplementedError for it too). The orientation,
    predicted-normal and normal-supervision terms and the RawNeRF data
    loss (`tests/test_torch_field_features.py` holds them to JAX), pose
    refinement, track refinement and the symmetry term pass, as do the
    paper's recipes."""
    base = tconfigs.tiny_debug()
    with pytest.raises(NotImplementedError):
        train_step.check_ported(dataclasses.replace(base,
                                                    data_loss_type="l1"))
    for kw in (dict(orientation_loss_mult=0.1),
               dict(predicted_normal_loss_mult=0.1),
               dict(normal_supervision=True),
               dict(data_loss_type="rawnerf"),
               dict(pose_refine=True), dict(track_refine=True),
               dict(model=dataclasses.replace(base.model, symmetrize=True))):
        train_step.check_ported(dataclasses.replace(base, **kw))
    train_step.check_ported(tconfigs.nuscenes_single())
    train_step.check_ported(tconfigs.nuscenes_multi())


def test_train_then_render_in_both_packages(tmp_path, monkeypatch):
    """The pipeline: the port's `train` writes params_<step>.npz, which the
    port's `render_lidar --params` and the JAX `Model.apply` render to the
    same sweep (the render slice's tolerance, as in test_torch_model.py:
    points rtol 1e-4 / atol 1e-5, the rest atol 1e-5)."""
    monkeypatch.chdir(tmp_path)
    base = ["--config", "tiny_debug", "--set", "dataset_loader=synthetic",
            "--device", "cpu", "--exp_name", "pipe"]
    first = cli.main(["train", *base, "--steps", "2"])
    assert first.params == os.path.join("exp", "pipe", "params_2.npz")
    assert os.path.exists(os.path.join("exp", "pipe", "config.json"))
    # Resuming runs only the missing step and keeps one checkpoint.
    run = cli.main(["train", *base, "--steps", "3"])
    assert sorted(os.listdir(os.path.join("exp", "pipe"))) == [
        "checkpoint_3.pt", "config.json", "params_3.npz"]
    assert run.history == []  # print_every = 100

    rendered = cli.main(["render_lidar", *base, "--num_sweeps", "1",
                         "--azimuth_steps", "8", "--params", run.params])
    params = convert.load_npz_params(run.params)
    jcfg = configs.Config.from_dict(json.loads(rendered.cfg.to_json()))
    jax_dir = tmp_path / "jax"
    jax_render_sweeps_to_dir(
        JaxChunkRenderer(JaxModel(jcfg.model), jcfg,
                         jcfg.render_chunk_size, fused=False),
        params, rendered.sweeps, rendered.near, rendered.far,
        rendered.frame, str(jax_dir))
    names = sorted(os.listdir(jax_dir))
    assert len(names) == 3
    for name in names:
        got = np.load(os.path.join(rendered.sweep_dir, name))
        want = np.load(jax_dir / name)
        assert got.shape == want.shape and np.isfinite(got).all(), name
        if name.startswith("points_0"):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)


# -------------------------------------------------------------- resume
def _train_argv(exp, *extra):
    """The port's train entry at the test's config."""
    return ["train", "--config", "tiny_debug", "--set", "batch_size=256",
            "--set", "lidar_supervision=true",
            "--set", "dataset_loader=synthetic", "--device", "cpu",
            "--exp_name", exp, *extra]


def _adam_state(opt_state):
    """The optax ScaleByAdamState inside a JAX optimizer state."""
    import optax
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _flax_moments(model, opt_state, key):
    """{Flax path: torch Adam's `key` ("exp_avg", ...) of that parameter}."""
    names = [n for n, _ in model.named_parameters()]
    return convert.flatten_params(convert.state_dict_to_flax(
        {n: opt_state["state"][i][key] for i, n in enumerate(names)}))


def test_train_resumes_from_a_jax_checkpoint(setup, tmp_path, monkeypatch):
    """In a directory that holds only the JAX package's checkpoint_1.ckpt
    (one JAX step), the port's `train --steps 2` starts at step 1 with
    JAX's params and Adam moments (bit for bit; step = optax's count),
    and its step on the JAX second step's batch (no randomness) equals
    JAX's second step at test_two_steps_match_jax_train_step's
    tolerance."""
    from nerf_lidar_tpu.train import checkpoints as jcheckpoints
    cfg, batches, jb, params, jmodel, _, jcfg = setup
    state, tx = jtrain.create_train_state(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params))
    step_fn = jtrain.make_train_step(jmodel, tx, jcfg, donate=False,
                                     num_patch_rays=64)
    state1, _ = step_fn(state, jb[0], None)
    monkeypatch.chdir(tmp_path)
    jcheckpoints.save_checkpoint(os.path.join("exp", "r"), state1, 1)
    state2, jstats = step_fn(state1, jb[1], None)
    seen = []
    orig = train_step.train_step

    def on_jax_batch(model, optimizer, cfg, batch, step, num_patch_rays,
                     generator, **kw):
        # Copies: the state dicts hold the very tensors the step updates.
        seen.append(dict(step=step,
                         opt=copy.deepcopy(optimizer.state_dict()),
                         params=convert.flatten_params(
                             convert.state_dict_to_flax(
                                 copy.deepcopy(model.state_dict())))))
        seen[-1]["moments"] = {k: _flax_moments(model, seen[-1]["opt"], k)
                               for k in ("exp_avg", "exp_avg_sq")}
        seen[-1]["count"] = {float(s["step"])
                             for s in seen[-1]["opt"]["state"].values()}
        out = orig(model, optimizer, cfg, _tensors(batches[1]), step,
                   num_patch_rays, None, **kw)
        seen[-1]["loss"] = float(out["loss"])
        return out

    monkeypatch.setattr(train_step, "train_step", on_jax_batch)
    run = cli.main(_train_argv("r", "--steps", "2"))
    assert run.init_step == 1 and [s["step"] for s in seen] == [1]
    flat = lambda tree: convert.flatten_params(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree))
    want = flat(state1.params)
    assert set(seen[0]["params"]) == set(want)
    for k in want:
        np.testing.assert_array_equal(seen[0]["params"][k], want[k],
                                      err_msg=k)
    adam = _adam_state(state1.opt_state)
    assert seen[0]["count"] == {float(adam.count)} == {1.0}
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = flat(tree)
        assert set(seen[0]["moments"][key]) == set(want)
        assert max(float(np.abs(v).max()) for v in want.values()) > 0
        for k in want:
            np.testing.assert_array_equal(seen[0]["moments"][key][k],
                                          want[k], err_msg=f"{key} {k}")
    np.testing.assert_allclose(seen[0]["loss"], float(jstats["loss"]),
                               rtol=1e-4)
    got = convert.flatten_params(convert.load_npz_params(run.params))
    for k, v in flat(state2.params).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
    assert sorted(os.listdir(os.path.join("exp", "r"))) == [
        "checkpoint_1.ckpt", "checkpoint_2.pt", "config.json",
        "params_2.npz"]


@pytest.mark.parametrize("override", ["pose_refine=true",
                                      "model.nerf_mlp.grid.log2_hashmap_size=11",
                                      "model.nerf_mlp.bottleneck_width=8"])
def test_train_refuses_a_jax_checkpoint_of_another_config(
        setup, tmp_path, monkeypatch, override):
    """A JAX checkpoint whose tree does not match the config (another
    optimizer group, table size or layer width) ends `train` with a
    message naming the file and its step, before any step."""
    from nerf_lidar_tpu.train import checkpoints as jcheckpoints
    _, _, _, params, _, _, jcfg = setup
    monkeypatch.chdir(tmp_path)
    jcheckpoints.save_checkpoint(
        os.path.join("exp", "bad"),
        jtrain.create_train_state(jcfg, params)[0], 4)
    monkeypatch.setattr(train_step, "train_step", None)
    with pytest.raises(SystemExit, match=r"cannot resume: exp/bad/"
                       r"checkpoint_4\.ckpt \(step 4\) does not match"):
        cli.main(_train_argv("bad", "--set", override, "--steps", "5"))


def test_newest_checkpoint_takes_the_higher_step_and_the_port_on_a_tie(
        tmp_path):
    from nerf_lidar_tpu_torch.train import checkpoints
    assert checkpoints.newest_checkpoint(str(tmp_path)) == (None, 0)
    for name in ("checkpoint_3.pt", "checkpoint_3.ckpt", "params_3.npz",
                 "checkpoint_12.ckpt", "checkpoint_9.pt"):
        (tmp_path / name).write_bytes(b"")
    assert checkpoints.newest_checkpoint(str(tmp_path)) == (
        str(tmp_path / "checkpoint_12.ckpt"), 12)
    (tmp_path / "checkpoint_12.pt").write_bytes(b"")
    assert checkpoints.newest_checkpoint(str(tmp_path)) == (
        str(tmp_path / "checkpoint_12.pt"), 12)
