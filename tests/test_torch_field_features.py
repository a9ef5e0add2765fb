"""The Ref-NeRF, GLO, exposure and background features of the field, and
the normal and RawNeRF loss terms, against the JAX package at `tiny_debug`
shapes, on JAX-initialised weights converted by `convert.py` (hash tables
seeded uniform so that the encode shapes the field).

Tolerances:
- MLP and model outputs rtol 1e-5 / atol 1e-6, as `test_torch_model.py`;
  depth rtol 1e-4 and colours atol 1e-5 through the resampling chain;
- the predicted normals (unit vectors, a normalised Dense output) atol
  1e-5: a component near 0 keeps the absolute rounding of the norm;
- finite-difference density normals: the raw densities at the six offsets
  first, at rtol 1e-5 / atol 1e-6 of their largest value (both sides
  evaluate the same trunk), then the normals at atol 2e-4: a central
  difference over 2 * normal_eps = 2e-2 divides the densities' float32
  rounding (~1e-6 of their magnitude) by 2e-2, about 50x, and the
  normalisation divides by the gradient's norm again;
- loss terms rtol 1e-5 / atol 1e-9 and gradients rtol 2e-3 / atol 1e-6 of
  each parameter's largest gradient, as `test_torch_train.py`; 1e-4 for
  the table and the density trunk, whose gradients also come through the
  finite differences (1e-6 times 50 times 2; measured 6.5e-5).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu.cli import load_scene_for
from nerf_lidar_tpu.data.batching import RayBatcher
from nerf_lidar_tpu.models.mlp import ZipMLP as JaxZipMLP
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.train import losses as jlosses
from nerf_lidar_tpu_torch import cli, convert
from nerf_lidar_tpu_torch import configs as tconfigs
from nerf_lidar_tpu_torch.data import synth_llff
from nerf_lidar_tpu_torch.models.mlp import ZipMLP
from nerf_lidar_tpu_torch.models.model import Model
from nerf_lidar_tpu_torch.train import checkpoints, losses, train_step

REF_NERF = dict(use_directional_enc=True, use_reflections=True, deg_view=3,
                enable_pred_normals=True, enable_pred_roughness=True,
                use_diffuse_color=True, use_specular_tint=True,
                use_n_dot_v=True, disable_density_normals=False,
                scale_featurization=True, num_glo_features=4)
# Each MLP flag alone (with what it needs: reflections and n . v read
# normals, roughness reaches the output through the IDE), then all.
MLP_FLAGS = {
    "ide": dict(use_directional_enc=True, deg_view=4),
    "reflections": dict(use_reflections=True, enable_pred_normals=True),
    "pred_normals": dict(enable_pred_normals=True),
    "roughness": dict(enable_pred_roughness=True, use_directional_enc=True),
    "n_dot_v": dict(use_n_dot_v=True, enable_pred_normals=True),
    "diffuse": dict(use_diffuse_color=True),
    "tint": dict(use_diffuse_color=True, use_specular_tint=True),
    "density_normals": dict(disable_density_normals=False),
    "glo": dict(num_glo_features=4),
    "scale_featurization": dict(scale_featurization=True),
    "all": REF_NERF,
}
# The gradients that reach the density trunk and the table through the
# finite-difference normals (the normal supervision term): 1e-6 of the
# largest, times 1 / (2 normal_eps) = 50 and 2 for the normalisation.
FD_GRAD_ATOL = 1e-4
# Unit vectors: absolute tolerances (see the module docstring).
NORMAL_TOL = dict(normals=2e-4, normals_pred=1e-5)
LOSSES = dict(orientation_loss_mult=0.1, orientation_coarse_loss_mult=0.01,
              predicted_normal_loss_mult=3e-4,
              predicted_normal_coarse_loss_mult=3e-5,
              normal_supervision=True, data_loss_type="rawnerf")


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


def _cfg(cfgs, mlp_flags=REF_NERF, **top):
    """tiny_debug with the NeRF MLP's `mlp_flags`, GLO (4 features),
    learned exposure scaling, a background range and `top` overrides."""
    base = cfgs.tiny_debug()
    m = base.model
    model = dataclasses.replace(
        m, num_glo_features=4, num_glo_embeddings=16,
        learned_exposure_scaling=True, bg_intensity_range=(0.0, 1.0),
        nerf_mlp=dataclasses.replace(m.nerf_mlp, **mlp_flags))
    return dataclasses.replace(base, model=model, **top)


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    bx = np.cross(d, [0.0, 0.0, 1.0])
    bx /= np.linalg.norm(bx, axis=-1, keepdims=True)
    return dict(
        origins=(rng.randn(n, 3) * 0.05).astype(np.float32),
        directions=d, viewdirs=d, base_x=bx.astype(np.float32),
        base_y=np.cross(d, bx).astype(np.float32),
        radii=np.full((n, 1), 1e-3, np.float32),
        near=np.full((n, 1), 0.2, np.float32),
        far=np.full((n, 1), 8.0, np.float32),
        cam_idx=rng.randint(0, 16, (n, 1)).astype(np.int32),
        exposure_values=rng.uniform(0.25, 1.0, (n, 3)).astype(np.float32),
        exposure_idx=rng.randint(0, 3, (n, 1)).astype(np.int32))


def _informative(params, seed=1):
    """Tables uniform(-1, 1), exposure offsets uniform(-0.3, 0.3)."""
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.RandomState(seed)
    for name, sub in params["params"].items():
        if "table" in sub:
            sub["table"] = rng.uniform(-1, 1, sub["table"].shape).astype(
                np.float32)
    if "exposure_scaling_offsets" in params["params"]:
        e = params["params"]["exposure_scaling_offsets"]
        e["embedding"] = rng.uniform(-0.3, 0.3, e["embedding"].shape
                                     ).astype(np.float32)
    return params


def _jax_init(cfg, rays):
    init = jax.jit(lambda k, b: JaxModel(cfg.model).init(
        k, None, b, zero_glo=False))
    return _informative(init(jax.random.PRNGKey(0), {
        k: jnp.asarray(v) for k, v in rays.items()}))


def _port(cfg, params):
    model = Model(cfg.model)
    model.load_state_dict(convert.flax_to_state_dict(params, cfg.model))
    return model


@pytest.fixture(scope="module")
def field():
    """The all-features config (JAX, port), rays, JAX params, the port
    model on them."""
    jcfg, cfg = _cfg(configs), _cfg(tconfigs)
    rays = _rays(24, 0)
    params = _jax_init(jcfg, rays)
    return jcfg, cfg, rays, params, _port(cfg, params)


@pytest.mark.parametrize("name", sorted(MLP_FLAGS))
def test_zip_mlp_flags_match_jax(name):
    """The NeRF MLP with each ported flag alone and all at once, on the
    same converted weights: every output the JAX MLP returns."""
    flags = MLP_FLAGS[name]
    jcfg = _cfg(configs, flags)
    mcfg = jcfg.model.nerf_mlp
    rng = np.random.RandomState(2)
    means = (rng.randn(6, 5, 3, 3) * 1.5).astype(np.float32)
    stds = rng.uniform(1e-3, 0.05, (6, 5, 3)).astype(np.float32)
    viewdirs = rng.randn(6, 3).astype(np.float32)
    viewdirs /= np.linalg.norm(viewdirs, axis=-1, keepdims=True)
    glo = rng.randn(6, 4).astype(np.float32)
    args = (jnp.asarray(means), jnp.asarray(stds))
    kw = dict(viewdirs=jnp.asarray(viewdirs), glo_vec=jnp.asarray(glo))
    params = _informative({"params": {"nerf_mlp": jax.jit(
        lambda k: JaxZipMLP(mcfg).init(k, *args, **kw))(
            jax.random.PRNGKey(3))["params"]}})["params"]["nerf_mlp"]
    want = JaxZipMLP(mcfg).apply({"params": params}, *args, **kw)
    holder = Model(_cfg(tconfigs, flags).model)
    convert.load_flax_subtree(holder, "nerf_mlp", params)
    mlp = holder.nerf_mlp
    assert isinstance(mlp, ZipMLP)
    with torch.no_grad():
        got = mlp(torch.from_numpy(means), torch.from_numpy(stds),
                  viewdirs=torch.from_numpy(viewdirs),
                  glo_vec=torch.from_numpy(glo))
    for k, w in want.items():
        if w is None or k == "raw_grad_density":
            assert got.get(k) is None, k
            continue
        tol = dict(rtol=1e-5, atol=NORMAL_TOL.get(k, 1e-6))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   err_msg=k, **tol)
    if "disable_density_normals" in flags:
        # The raw densities at the six offsets, before the differences.
        eps = mcfg.normal_eps
        for d in range(3):
            for sign in (1, -1):
                off = np.zeros(3, np.float32)
                off[d] = sign * eps
                pts = np.clip(means + off, -1e6, 1e6)
                w = JaxZipMLP(mcfg).apply(
                    {"params": params}, jnp.asarray(pts), args[1],
                    method=JaxZipMLP.predict_density)[0]
                with torch.no_grad():
                    g = mlp.predict_density(torch.from_numpy(pts),
                                            torch.from_numpy(stds))[0]
                w = np.asarray(w)
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=1e-5,
                    atol=1e-6 * float(np.abs(w).max()))


@pytest.mark.parametrize("zero_glo,fused", [(False, False), (True, True)])
def test_model_glo_exposure_background_match_jax(field, zero_glo, fused):
    """Every level of the all-features model (GLO read through cam_idx or
    zero, exposure values and learned offsets, the background midpoint
    without a key, the composited normals): plain, and with the fused
    final level, which the midpoint (a scalar) keeps on and which
    composites no normals, as the JAX fused kernel."""
    jcfg, _, rays, params, model = field
    want, _ = jax.jit(lambda p, b: JaxModel(jcfg.model).apply(
        p, None, b, zero_glo=zero_glo, fused_final=fused))(
            params, {k: jnp.asarray(v) for k, v in rays.items()})
    with torch.no_grad():
        got, _ = model({k: torch.from_numpy(v) for k, v in rays.items()},
                       zero_glo=zero_glo, fused_final=fused)
    for level, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (level, sorted(g), sorted(w))
        np.testing.assert_allclose(g["depth"].numpy(),
                                   np.asarray(w["depth"]), rtol=1e-4)
        for k in set(g) - {"depth"}:
            np.testing.assert_allclose(
                g[k].numpy(), np.asarray(w[k]), err_msg=f"{k} {level}",
                atol=2e-4 if k == "normals" else 1e-5)
    assert ({"normals", "normals_pred"} <= set(got[-1])) == (not fused)


def test_random_background_in_range_and_seeded(field, monkeypatch):
    """With a generator (training) every level's background is drawn
    uniform in the range per ray and channel, the same again from the same
    seed; without one it is the range's midpoint."""
    from nerf_lidar_tpu_torch.models import model as model_mod
    _, _, rays, _, model = field
    batch = {k: torch.from_numpy(v) for k, v in rays.items()}
    seen = []
    orig = model_mod.render.volumetric_rendering

    def record(rgbs, weights, tdist, bg, **kw):
        seen.append(bg)
        return orig(rgbs, weights, tdist, bg, **kw)

    monkeypatch.setattr(model_mod.render, "volumetric_rendering", record)
    draws = []
    for seed in (0, 0):
        seen.clear()
        with torch.no_grad():
            model(batch, train=True,
                  generator=torch.Generator().manual_seed(seed))
        draws.append(torch.stack(seen))
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    bg = draws[0]
    assert bg.shape == (model.cfg.num_levels, len(rays["origins"]), 3)
    assert float(bg.min()) >= 0.0 and float(bg.max()) <= 1.0
    assert 0.35 < float(bg.mean()) < 0.65 and float(bg.std()) > 0.15
    seen.clear()
    with torch.no_grad():
        model(batch)
    assert seen == [0.5] * model.cfg.num_levels


@pytest.fixture(scope="module")
def step_setup():
    """One RayBatcher batch of the synthetic scene (with normals and LiDAR
    rays), the all-features field and every new loss term on: the JAX
    loss terms and gradients at step 0 (key None, GLO read)."""
    jcfg = _cfg(configs, batch_size=256, lidar_supervision=True,
                dataset_loader="synthetic", **LOSSES)
    scene = load_scene_for(jcfg, "train")
    batch = RayBatcher(scene.data, jcfg.batch_size, jcfg.patch_size,
                       lidar_supervision=True,
                       lidar_batch_ratio=jcfg.lidar_batch_ratio,
                       seed=0).next()
    assert "normals" in batch
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _jax_init(jcfg, _rays(8, 0))
    jmodel = JaxModel(jcfg.model)

    def loss_fn(p):
        renderings, history = jmodel.apply(p, None, jb, train_frac=0.0,
                                           train=True, zero_glo=False)
        terms = jlosses.compute_losses(p, jb, renderings, history, jcfg, 0,
                                       num_patch_rays=64)
        return jlosses.total_loss(terms), terms

    (loss, terms), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    want = dict(terms=jax.tree_util.tree_map(np.asarray, terms),
                loss=float(loss), grads=convert.flatten_params(
                    jax.tree_util.tree_map(np.asarray, grads)))
    cfg = _cfg(tconfigs, batch_size=256, lidar_supervision=True,
               dataset_loader="synthetic", **LOSSES)
    return cfg, batch, params, want


def test_train_step_loss_terms_and_gradients_match_jax(step_setup):
    """The orientation, predicted-normal, normal-supervision and RawNeRF
    data terms (with every other term of the step), the total, and the
    gradient of every parameter: the GLO vectors, the normal, roughness,
    diffuse, specular and GLO layers included (the exposure offsets get
    none: the synthetic scene has no exposures)."""
    cfg, batch, params, want = step_setup
    model = _port(cfg, params)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    renderings, history = model(tb, train_frac=0.0, train=True,
                                zero_glo=False)
    terms = losses.compute_losses(model, tb, renderings, history, cfg, 0,
                                  num_patch_rays=64)
    assert {"orientation", "predicted_normals", "normals", "data"} <= \
        set(terms) == set(want["terms"])
    for k, v in terms.items():
        np.testing.assert_allclose(v.detach().numpy(), want["terms"][k],
                                   rtol=1e-5, atol=1e-9, err_msg=k)
    total = losses.total_loss(terms)
    np.testing.assert_allclose(float(total.detach()), want["loss"],
                               rtol=1e-5)
    total.backward()
    grads = convert.flatten_params(convert.state_dict_to_flax(
        {k: p.grad if p.grad is not None else torch.zeros_like(p)
         for k, p in model.named_parameters()}))
    assert set(grads) == set(want["grads"])
    for k, g in grads.items():
        w = want["grads"][k]
        scale = float(np.abs(w).max())
        fd = k.startswith(("params/nerf_mlp/table",
                           "params/nerf_mlp/density_layers"))
        np.testing.assert_allclose(g, w, rtol=2e-3,
                                   atol=(FD_GRAD_ATOL if fd else 1e-6) * scale,
                                   err_msg=k)
    for k in ("glo_vecs/embedding", "nerf_mlp/normal_layer/kernel",
              "nerf_mlp/roughness_layer/kernel",
              "nerf_mlp/glo_layers_0/kernel"):
        assert np.abs(grads[f"params/{k}"]).max() > 0, k


def test_train_steps_with_the_features(step_setup):
    """Two `train_step`s of the port with every feature and loss term on
    (GLO read in training, the random background drawn): finite stats
    with the new terms, and the GLO vectors of the batch's cameras move."""
    cfg, batch, params, _ = step_setup
    model = _port(cfg, params)
    opt = train_step.make_optimizer(model, cfg)
    before = model.glo_vecs.weight.detach().clone()
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for step in range(2):
        stats = train_step.train_step(model, opt, cfg, tb, step, 64,
                                      torch.Generator().manual_seed(step))
        assert all(bool(torch.isfinite(v).all()) for v in stats.values())
    assert {"orientation", "predicted_normals", "normals"} <= set(stats)
    cams = np.unique(batch["cam_idx"])
    assert bool((model.glo_vecs.weight[cams] != before[cams]).any())


def _random_moments(state, seed):
    """The JAX train state with seeded non-zero Adam moments and count 3
    (so that a leaf placed in the wrong group or slot shows)."""
    import optax
    rng = np.random.RandomState(seed)

    def fill(s):
        if isinstance(s, optax.ScaleByAdamState):
            rand = lambda t: jax.tree_util.tree_map(  # noqa: E731
                lambda x: jnp.asarray(rng.uniform(0.1, 1.0, x.shape)
                                      .astype(np.float32)), t)
            return s._replace(count=jnp.asarray(3, jnp.int32),
                              mu=rand(s.mu), nu=rand(s.nu))
        return s

    return state.replace(opt_state=jax.tree_util.tree_map(
        fill, state.opt_state,
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)))


def test_jax_checkpoint_of_the_field_resumes_and_evaluates(
        tmp_path, monkeypatch):
    """A JAX train state of a Ref-NeRF / GLO / exposure field on an llff
    capture: the port's optimizer takes every leaf's mu / nu (GLO vectors,
    exposure offsets and the new layers included) into the model group,
    equal leaf by leaf; `eval` of the .ckpt equals `eval` of the same
    weights as the port's .npz."""
    from nerf_lidar_tpu.train import checkpoints as jcheckpoints
    from nerf_lidar_tpu.train import train_step as jtrain
    monkeypatch.chdir(tmp_path)
    synth_llff.write_capture("cap", num_views=5, height=12, width=16)
    sets = ["--set", "dataset_loader=llff", "--set", "llffhold=4",
            "--set", "model.num_glo_features=4",
            "--set", "model.num_glo_embeddings=16",
            "--set", "model.learned_exposure_scaling=true",
            "--set", "model.nerf_mlp.num_glo_features=4",
            "--set", "model.nerf_mlp.use_directional_enc=true",
            "--set", "model.nerf_mlp.enable_pred_normals=true",
            "--set", "model.nerf_mlp.enable_pred_roughness=true",
            "--set", "model.nerf_mlp.use_diffuse_color=true",
            "--set", "model.nerf_mlp.use_specular_tint=true",
            "--set", "model.nerf_mlp.deg_view=2"]
    argv = ["--config", "tiny_debug", "--data_dir", "cap", "--device", "cpu",
            "--exp_name", "f", *sets]
    cfg = cli.build_config(cli.parse_args(["eval", *argv]))
    jcfg = configs.Config.from_dict(__import__("json").loads(cfg.to_json()))
    params = _jax_init(jcfg, _rays(8, 0))
    state = _random_moments(jtrain.create_train_state(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params))[0], 4)
    jcheckpoints.save_checkpoint(os.path.join("exp", "f"), state, 3)

    model = Model(cfg.model)
    opt = train_step.make_optimizer(model, cfg)
    assert checkpoints.restore_checkpoint(os.path.join("exp", "f"), model,
                                          opt) == 3
    names = [n for n, _ in model.named_parameters()]
    sd = opt.state_dict()
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        got = convert.flatten_params(convert.state_dict_to_flax(
            {n: sd["state"][i][key] for i, n in enumerate(names)}))
        want = convert.flatten_params(jax.tree_util.tree_map(np.asarray,
                                                             tree))
        assert set(got) == set(want)
        assert {"params/glo_vecs/embedding",
                "params/exposure_scaling_offsets/embedding",
                "params/nerf_mlp/roughness_layer/kernel"} <= set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{key} {k}")
    assert {float(s["step"]) for s in sd["state"].values()} == {3.0}

    ckpt = os.path.join("exp", "f", "checkpoint_3.ckpt")
    os.makedirs(os.path.join("exp", "g"))
    npz = convert.save_npz_params(os.path.join("exp", "g", "params_3.npz"),
                                  convert.state_dict_to_flax(
                                      model.state_dict()))
    a = cli.main(["eval", *argv, "--params", ckpt])
    b = cli.main(["eval", *argv, "--exp_name", "g", "--params", npz])
    assert a.metrics == dict(b.metrics, median_render_time_s=a.metrics[
        "median_render_time_s"]) and np.isfinite(a.metrics["psnr"])
    for name in os.listdir(os.path.join("exp", "f", "eval")):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(
                np.load(os.path.join("exp", "f", "eval", name)),
                np.load(os.path.join("exp", "g", "eval", name)))
