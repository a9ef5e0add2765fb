"""The field presets' transforms on `tiny_debug` against the JAX package:
`fast_variant` (tetrahedral hash grids, C16 NeRF levels, mean-point coarse
levels, the scatter-only encode backward) and `mxu_variant` (the spectral
encoder: dense tetrahedral band + pooled Fourier features), each in float32.

JAX-initialised parameters (tables uniform(-0.1, 0.1), so that the encodes
shape the fields) go through `convert.py`; the same synthetic batches go
through both packages: the renderings of an inference forward, every loss
term and every parameter's gradient of the first train step, and two
optimizer steps (JAX `make_train_step` against the port's `train_step`).
The bfloat16 presets (`speed_variant`, `bf16_variant`) are in
test_torch_presets_bf16.py, the spectral object grid in
test_torch_presets_objects.py; both use this file's helpers.

Tolerances, those of tests/test_torch_model.py and test_torch_train.py:
renderings depth rtol 1e-4, everything else atol 1e-5; loss terms rtol
1e-5 / atol 1e-9; gradients rtol 2e-3 / atol 1e-6 of the parameter's
largest gradient. A parameter with an entry outside that passes only if
the port's gradient is no farther than JAX's from the port's float64
gradient of the same loss (relative L2 norm), and within 1% of JAX's:
the fast NeRF table and its first trunk layer sum thousands of samples'
terms through ReLU masks and the resampling chain, and there both float32
gradients sit ~3e-3 (L2) and up to 1% (of the largest entry, on 0.1% of
the entries) from the float64 one; the port is the nearer of the two on
every parameter (measured; JAX's float32 semantic-head gradient alone is
3.5e-3 off). tests/test_torch_objects_train.py arbitrates by the float64
gradient too. Parameters after each step atol 1e-5, or, for a parameter
with an entry outside that, the update within 2 lr of JAX's on every
entry and within 3% of lr in RMS: Adam's first full step moves an entry by
about lr times the sign of its (bias-corrected) gradient, so an entry
whose two steps' gradients nearly cancel, or whose gradient the two float32
computations do not resolve, moves differently (measured: up to 2 lr on
0.5% of the fast NeRF table, RMS <= 1.4% of lr). The Fourier
matrix is the port's own (`ops/fourier.py`), which may differ from the
jitted JAX one in a few high-frequency entries by 1 ulp
(tests/test_torch_fourier.py): at these batches' stds those bands are
damped below the tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu.cli import load_scene_for
from nerf_lidar_tpu.data.batching import RayBatcher
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.train import losses as jlosses
from nerf_lidar_tpu.train import train_step as jtrain
from nerf_lidar_tpu_torch import cli, convert
from nerf_lidar_tpu_torch import configs as tconfigs
from nerf_lidar_tpu_torch.models.model import Model
from nerf_lidar_tpu_torch.ops import grid
from nerf_lidar_tpu_torch.train import losses, train_step

# Preset transforms of tiny_debug, from the JAX `configs` or the port's.
PRESETS = {
    "fast": lambda c: c.fast_variant(c.tiny_debug()),
    "mxu": lambda c: c.mxu_variant(c.tiny_debug()),
    # nuscenes_single_speed's composition: speed_variant over mxu_variant.
    "speed": lambda c: c.speed_variant(c.mxu_variant(c.tiny_debug())),
    "bf16": lambda c: c.bf16_variant(c.tiny_debug()),
}


def preset_cfg(name, cfgs=configs):
    """The preset on tiny_debug with the train tests' batch: 256 rays with
    LiDAR rays, so that the batch holds 8x8 patches."""
    return dataclasses.replace(PRESETS[name](cfgs), batch_size=256,
                               lidar_supervision=True,
                               dataset_loader="synthetic")


def tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def port_model(cfg, params):
    model = Model(cfg.model)
    model.load_state_dict(convert.flax_to_state_dict(params, cfg.model))
    return model


def preset_setup(name):
    """(port cfg, two batches, JAX batches, JAX params with tables uniform
    (-0.1, 0.1), the JAX model, the JAX first-step loss terms, loss and
    gradients, the JAX cfg)."""
    cfg = preset_cfg(name)
    scene = load_scene_for(cfg, "train")
    batcher = RayBatcher(scene.data, cfg.batch_size, cfg.patch_size,
                         lidar_supervision=True,
                         lidar_batch_ratio=cfg.lidar_batch_ratio, seed=0)
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
    return (preset_cfg(name, tconfigs), batches, jb, params, jmodel, want,
            cfg)


def port_losses(cfg, model, batch):
    renderings, history = model(tensors(batch), train_frac=0.0, train=True)
    return losses.compute_losses(model, tensors(batch), renderings, history,
                                 cfg, 0, num_patch_rays=64)


def port_grads(cfg, model, batch):
    """(loss terms, {flax path: gradient}) of the port's first step."""
    terms = port_losses(cfg, model, batch)
    losses.total_loss(terms).backward()
    return terms, convert.flatten_params(convert.state_dict_to_flax(
        {k: p.grad for k, p in model.named_parameters()}))


def port_grads_f64(cfg, params, batch):
    """The port's first-step gradients of the same loss in float64."""
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        model = port_model(cfg, params).double()
        tb = {k: (v.double() if v.dtype == torch.float32 else v)
              for k, v in tensors(batch).items()}
        renderings, history = model(tb, train_frac=0.0, train=True)
        losses.total_loss(losses.compute_losses(
            model, tb, renderings, history, cfg, 0,
            num_patch_rays=64)).backward()
    finally:
        torch.set_default_dtype(default)
    return convert.flatten_params(convert.state_dict_to_flax(
        {k: p.grad.float() for k, p in model.named_parameters()}))


def assert_grads_match(grads, want, ref, rtol=2e-3, atol=1e-6):
    """Each parameter's gradient: every entry within rtol / atol x the
    largest gradient of JAX's; or else the port no farther than JAX from
    `ref` (the port's float64 gradient) in relative L2 norm, and within 1%
    (L2) of JAX."""
    assert set(grads) == set(want)
    for k, g in grads.items():
        w = want[k]
        scale = float(np.abs(w).max())
        assert scale > 0, k
        if np.allclose(g, w, rtol=rtol, atol=atol * scale):
            continue
        norm = lambda a: float(np.linalg.norm(a))
        port_err, jax_err = norm(g - ref[k]), norm(w - ref[k])
        assert port_err <= jax_err + atol * norm(ref[k]), (
            k, port_err / norm(ref[k]), jax_err / norm(ref[k]))
        assert norm(g - w) <= 1e-2 * norm(w), (k, norm(g - w) / norm(w))


def forward_both(setup, fused_final=False):
    """The final renderings of an inference forward on the first batch:
    (port's, JAX's), numpy."""
    cfg, batches, jb, params, jmodel, _, _ = setup
    keys = ("origins", "directions", "viewdirs", "radii", "base_x",
            "base_y", "near", "far")
    jrays = {k: jb[0][k] for k in keys}
    want, _ = jax.jit(lambda p, b: jmodel.apply(
        p, None, b, fused_final=fused_final))(params, jrays)
    with torch.no_grad():
        got, _ = port_model(cfg, params)(
            {k: torch.from_numpy(np.asarray(batches[0][k])) for k in keys},
            fused_final=fused_final)
    assert len(got) == len(want) == cfg.model.num_levels
    return ([{k: v.numpy() for k, v in g.items()} for g in got],
            [{k: np.asarray(v) for k, v in w.items()} for w in want])


def two_steps(setup):
    """Two steps of JAX make_train_step and the port's train_step from the
    same weights and batches: [(port stats, JAX stats, port params, JAX
    params)] per step (flattened Flax paths)."""
    cfg, batches, jb, params, jmodel, _, jcfg = setup
    state, tx = jtrain.create_train_state(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params))
    step_fn = jtrain.make_train_step(jmodel, tx, jcfg, donate=False,
                                     num_patch_rays=64)
    model = port_model(cfg, params)
    opt = train_step.make_optimizer(model, cfg)
    out = []
    for step, (batch, jbatch) in enumerate(zip(batches, jb)):
        state, jstats = step_fn(state, jbatch, None)
        stats = train_step.train_step(model, opt, cfg, tensors(batch), step,
                                      num_patch_rays=64)
        # A copy: the CPU state dict's numpy leaves share the parameters.
        out.append((stats, jstats,
                    {k: v.copy() for k, v in convert.flatten_params(
                        convert.state_dict_to_flax(model.state_dict())).items()},
                    convert.flatten_params(
                        jax.tree_util.tree_map(np.asarray, state.params))))
    return out


@pytest.fixture(scope="module", params=["fast", "mxu"])
def f32_preset(request):
    return request.param, preset_setup(request.param)


def test_preset_specs(f32_preset):
    """The table layouts the presets give: the fast NeRF grid's 4 C16
    levels (tiled 17, hashed 129 / 1025 / 8193 at 2^17 rows), the spectral
    band's 2 tiled C16 levels (17, 49), tetrahedral, scatter-only."""
    name, (cfg, *_) = f32_preset
    spec = grid.spec_for(cfg.model.nerf_mlp.grid)
    assert (spec.level_dim, spec.interp, spec.diff_inputs) == (16, "tetra",
                                                               False)
    if name == "fast":
        assert spec.resolutions == (17, 129, 1025, 8193)
        assert spec.rows_per_level == (4920,) + (131072,) * 3
    else:
        assert spec.resolutions == (17, 49)
        assert spec.rows_per_level == (4920, 117656)
        assert all(spec.is_tiled(l) for l in range(2))
    assert grid.mean_levels(spec, cfg.model.nerf_mlp.ms_coarse_res_cutoff) \
        == [r <= 1024 for r in spec.resolutions]


@pytest.mark.parametrize("fused_final", [False, True])
def test_preset_renderings_match_jax(f32_preset, fused_final):
    _, setup = f32_preset
    got, want = forward_both(setup, fused_final)
    for level, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), level
        np.testing.assert_allclose(g["depth"], w["depth"], rtol=1e-4,
                                   err_msg=f"depth {level}")
        for k in set(g) - {"depth"}:
            np.testing.assert_allclose(g[k], w[k], atol=1e-5,
                                       err_msg=f"{k} {level}")


def test_preset_losses_and_gradients_match_jax(f32_preset):
    _, (cfg, batches, _, params, _, want, _) = f32_preset
    terms, grads = port_grads(cfg, port_model(cfg, params), batches[0])
    assert set(terms) == set(want["terms"])
    assert "hash_decay" in terms
    for k, v in terms.items():
        np.testing.assert_allclose(v.detach().numpy(), want["terms"][k],
                                   rtol=1e-5, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(float(losses.total_loss(terms).detach()),
                               want["loss"], rtol=1e-5)
    assert_grads_match(grads, want["grads"],
                       port_grads_f64(cfg, params, batches[0]))


def assert_steps_match(setup, steps, loss_rtol=1e-4, atol=1e-5,
                       rms_frac=0.03):
    """Loss of each step within loss_rtol; each parameter after each step
    within atol of JAX's, or else its update within Adam's bound of 2 lr
    of JAX's on every entry and within rms_frac of lr in RMS."""
    from nerf_lidar_tpu.train import train_step as jtrain_step
    jcfg = setup[-1]
    for step, (stats, jstats, got, want) in enumerate(steps):
        np.testing.assert_allclose(float(stats["loss"]),
                                   float(jstats["loss"]), rtol=loss_rtol)
        lr = float(jtrain_step.lr_schedule(jcfg)(step))
        for k in want:
            d = np.abs(got[k] - want[k])
            if d.max() <= atol:
                continue
            assert d.max() <= 2 * lr * (1 + 1e-3), (step, k, d.max() / lr)
            assert np.sqrt((d**2).mean()) <= rms_frac * lr, (
                step, k, np.sqrt((d**2).mean()) / lr)


def test_preset_two_steps_match_jax(f32_preset):
    _, setup = f32_preset
    assert_steps_match(setup, two_steps(setup))


def test_jax_preset_checkpoint_loads_into_the_port(f32_preset, tmp_path):
    """A JAX `checkpoint_<step>.ckpt` of the preset's train state, read by
    the port's msgpack reader: the Flax tree bit for bit (the C16 / dense
    band tables, the wider first Dense of the Fourier features), and a port
    model built from it renders as the one converted from the params."""
    from nerf_lidar_tpu.train import checkpoints as jcheckpoints
    from nerf_lidar_tpu_torch.train import checkpoints
    _, setup = f32_preset
    cfg, _, _, params, _, _, jcfg = setup
    state, _ = jtrain.create_train_state(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params))
    jcheckpoints.save_checkpoint(str(tmp_path), state, 3)
    got, step = checkpoints.restore_model_params(str(tmp_path))
    assert step == 3
    flat, want = convert.flatten_params(got), convert.flatten_params(params)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    rendered, jax_rendered = forward_both((cfg,) + setup[1:3] + (got,)
                                          + setup[4:])
    np.testing.assert_allclose(rendered[-1]["depth"],
                               jax_rendered[-1]["depth"], rtol=1e-4)


def test_cli_takes_every_jax_preset():
    """The port's CLI offers the ten preset names of the JAX CLI, and each
    builds the JAX package's config (each builds a port model in
    test_torch_model.py::test_cli_presets_are_ported)."""
    import types

    from nerf_lidar_tpu import cli as jcli
    assert len(set(cli.CONFIGS)) == 10
    for name in cli.CONFIGS:
        args = types.SimpleNamespace(config=name, set=[], data_dir=None,
                                     exp_name=None, config_json=None)
        want = jcli.build_config(args)
        got = cli.build_config(cli.parse_args(["render_lidar", "--config",
                                               name]))
        assert got.to_json() == want.to_json(), name
