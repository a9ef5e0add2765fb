"""The port's MLP, scene model and the sweep render slice against the JAX
package, with JAX `tiny_debug` weights converted by `convert.py`.

Tolerances: MLP outputs rtol 1e-5 / atol 1e-6; per-level and slice depth
rtol 1e-4, rgb / semantic atol 1e-5 (the resampling chain compounds the
last-bit differences of the two frameworks' sums and transcendentals).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu.lidar import sensor
from nerf_lidar_tpu.lidar.render import \
    render_sweeps_to_dir as jax_render_sweeps_to_dir
from nerf_lidar_tpu.lidar.transforms import SceneFrame
from nerf_lidar_tpu.models.mlp import ZipMLP as JaxZipMLP
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.renderer import ChunkRenderer as JaxChunkRenderer
from nerf_lidar_tpu_torch import cli, convert
from nerf_lidar_tpu_torch import configs as tconfigs
from nerf_lidar_tpu_torch.lidar import sensor as tsensor
from nerf_lidar_tpu_torch.lidar import transforms as ttransforms
from nerf_lidar_tpu_torch.lidar.render import render_sweeps_to_dir
from nerf_lidar_tpu_torch.models.mlp import ZipMLP
from nerf_lidar_tpu_torch.models.model import Model
from nerf_lidar_tpu_torch.renderer import ChunkRenderer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        far=np.full((n, 1), 8.0, np.float32))


@pytest.fixture(scope="module")
def tiny():
    """tiny_debug config (the JAX one, the port's), JAX params (numpy) with
    informative tables, and the port model holding the same weights."""
    jcfg, cfg = configs.tiny_debug(), tconfigs.tiny_debug()
    probe = {k: jnp.asarray(v) for k, v in _rays(8, 0).items()}
    params = jax.jit(JaxModel(jcfg.model).init)(jax.random.PRNGKey(0), None,
                                                probe)
    params = jax.tree_util.tree_map(np.asarray, params)
    # Fresh tables are +-1e-4, which makes every feature nearly 0; scale
    # them so the encode shapes the field.
    rng = np.random.RandomState(1)
    for name, sub in params["params"].items():
        sub["table"] = rng.uniform(-1, 1, sub["table"].shape).astype(
            np.float32)
    model = Model(cfg.model)
    model.load_state_dict(convert.flax_to_state_dict(params, cfg.model))
    return jcfg, cfg, params, model


@pytest.mark.parametrize("level", ["nerf_mlp", "prop_mlps_0"])
def test_zip_mlp_matches_jax(tiny, level):
    jcfg, _, params, model = tiny
    rng = np.random.RandomState(2)
    means = (rng.randn(16, 8, 3, 3) * 1.5).astype(np.float32)
    stds = rng.uniform(1e-3, 0.05, (16, 8, 3)).astype(np.float32)
    viewdirs = rng.randn(16, 3).astype(np.float32)
    viewdirs /= np.linalg.norm(viewdirs, axis=-1, keepdims=True)
    if level == "nerf_mlp":
        mcfg, mlp = jcfg.model.nerf_mlp, model.nerf_mlp
    else:
        mcfg, mlp = jcfg.model.prop_mlp_for_level(0), model.prop_mlps[0]
    want = JaxZipMLP(mcfg).apply({"params": params["params"][level]},
                                 jnp.asarray(means), jnp.asarray(stds),
                                 viewdirs=jnp.asarray(viewdirs))
    with torch.no_grad():
        got = mlp(torch.from_numpy(means), torch.from_numpy(stds),
                  viewdirs=torch.from_numpy(viewdirs))
    for k in ("density", "rgb", "semantic"):
        if want[k] is None:
            assert got[k] is None, k
            continue
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("fused_final", [False, True])
def test_model_levels_match_jax(tiny, fused_final):
    jcfg, cfg, params, model = tiny
    rays = _rays(96, 3)
    want, _ = jax.jit(lambda p, b: JaxModel(jcfg.model).apply(
        p, None, b, fused_final=fused_final))(
            params, {k: jnp.asarray(v) for k, v in rays.items()})
    with torch.no_grad():
        got, _ = model({k: torch.from_numpy(v) for k, v in rays.items()},
                       fused_final=fused_final)
    assert len(got) == len(want) == cfg.model.num_levels
    for level, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), level
        np.testing.assert_allclose(g["depth"].numpy(), np.asarray(w["depth"]),
                                   rtol=1e-4, err_msg=f"depth {level}")
        for k in set(g) - {"depth"}:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=1e-5, err_msg=f"{k} {level}")


def _nerf_level_dim(cfg, c):
    """cfg with its NeRF grid's level_dim set to c (either package's)."""
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, nerf_mlp=dataclasses.replace(m.nerf_mlp, grid=dataclasses.replace(
            m.nerf_mlp.grid, level_dim=c))))


def test_c3_nerf_grid_forward_and_gradients_match_jax():
    """tiny_debug with a 3-channel NeRF grid (`model.nerf_mlp.grid.level_dim
    =3`, a width the port's kernels take by their general path): JAX
    weights carried over by convert.py; the model's levels at
    test_model_levels_match_jax's tolerances, and the gradient of every
    parameter of a seeded weighting of every level's outputs at
    tests/test_torch_train.py's (rtol 2e-3 / atol 1e-6 of the parameter's
    largest gradient)."""
    jcfg = _nerf_level_dim(configs.tiny_debug(), 3)
    cfg = _nerf_level_dim(tconfigs.tiny_debug(), 3)
    rays = _rays(64, 5)
    jrays = {k: jnp.asarray(v) for k, v in rays.items()}
    jmodel = JaxModel(jcfg.model)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), None, jrays)
    params = jax.tree_util.tree_map(np.asarray, params)
    assert params["params"]["nerf_mlp"]["table"].shape[1] == 3
    rng = np.random.RandomState(6)
    for sub in params["params"].values():
        sub["table"] = rng.uniform(-1, 1, sub["table"].shape).astype(
            np.float32)
    levels, _ = jax.jit(lambda p: jmodel.apply(p, None, jrays))(params)
    weights = [{k: rng.randn(*np.shape(v)).astype(np.float32)
                for k, v in sorted(lv.items())} for lv in levels]

    def weighted(outs, w, xp):
        return sum(xp.sum(o[k] * w_l[k]) for o, w_l in zip(outs, w)
                   for k in sorted(w_l))

    want_grads = convert.flatten_params(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(lambda p: weighted(
            jmodel.apply(p, None, jrays)[0], weights, jnp)))(params)))
    model = Model(cfg.model)
    model.load_state_dict(convert.flax_to_state_dict(params, cfg.model))
    assert model.nerf_mlp.table.shape[1] == 3
    got, _ = model({k: torch.from_numpy(v) for k, v in rays.items()})
    for level, (g, w) in enumerate(zip(got, levels)):
        assert set(g) == set(w), level
        np.testing.assert_allclose(g["depth"].detach().numpy(),
                                   np.asarray(w["depth"]), rtol=1e-4,
                                   err_msg=f"depth {level}")
        for k in set(g) - {"depth"}:
            np.testing.assert_allclose(g[k].detach().numpy(),
                                       np.asarray(w[k]), atol=1e-5,
                                       err_msg=f"{k} {level}")
    tw = [{k: torch.from_numpy(v) for k, v in w_l.items()} for w_l in weights]
    weighted(got, tw, torch).backward()
    grads = convert.flatten_params(convert.state_dict_to_flax(
        {k: p.grad for k, p in model.named_parameters()}))
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        w = want_grads[k]
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-6 * scale,
                                   err_msg=k)


def _small_sweeps(sensor_mod=sensor, frame=SceneFrame):
    """Two sweeps of 4 elevations x 64 azimuths on a straight drive, from
    the JAX sensor model or the port's."""
    sweeps, _ = sensor_mod.simulated_sweeps(
        np.array([0.0, 0.0, 0.6]), np.array([1.0, 0.0, 0.6]), np.eye(4),
        frame.identity(), num_sweeps=2,
        elevations_deg=(-20.0, -8.0, 0.0, 6.0), points_per_beam=64)
    return sweeps


def test_slice_matches_both_jax_paths(tiny, tmp_path):
    """The whole render slice: sweep -> ChunkRenderer -> the .npy trio, in
    the port (CPU) and in JAX with plain and with fused compositing."""
    jcfg, cfg, params, model = tiny
    chunk = 96  # 256 rays per sweep: exercises the last-ray padding
    port_dir = tmp_path / "port"
    frame = ttransforms.SceneFrame
    render_sweeps_to_dir(ChunkRenderer(model, cfg, chunk),
                         _small_sweeps(tsensor, frame), 0.2, 8.0,
                         frame.identity(), str(port_dir))
    for fused in (False, True):
        jax_dir = tmp_path / f"jax_fused{fused}"
        jax_render_sweeps_to_dir(
            JaxChunkRenderer(JaxModel(jcfg.model), jcfg, chunk, fused=fused),
            params, _small_sweeps(), 0.2, 8.0, SceneFrame.identity(),
            str(jax_dir))
        names = sorted(os.listdir(jax_dir))
        assert names == sorted(os.listdir(port_dir))
        assert len(names) == 6
        for name in names:
            got, want = np.load(port_dir / name), np.load(jax_dir / name)
            assert got.shape == want.shape, name
            if name.startswith("points_") and name[7].isdigit():
                # Hit points are origin + depth * direction: depth rtol.
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                           err_msg=name)
            else:
                np.testing.assert_allclose(got, want, atol=1e-5,
                                           err_msg=name)


def test_cli_render_lidar_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = cli.main([
        "render_lidar", "--config", "tiny_debug", "--set",
        "dataset_loader=synthetic", "--mode", "simu", "--num_sweeps", "2",
        "--azimuth_steps", "8", "--allow_fresh", "--device", "cpu",
        "--exp_name", "cli"])
    sweep_dir = tmp_path / "exp" / "cli" / "lidar_simu"
    assert run.sweep_dir == os.path.join("exp", "cli", "lidar_simu")
    assert sorted(os.listdir(sweep_dir)) == sorted(
        [f"points_{p}{i:04d}.npy" for p in ("", "semantic_", "rgb_")
         for i in range(2)] + ["lidar2globals.npy"])
    pts = np.load(sweep_dir / "points_0001.npy")
    sem = np.load(sweep_dir / "points_semantic_0001.npy")
    assert pts.shape == (32 * 8, 3) and np.isfinite(pts).all()
    np.testing.assert_allclose(sem.sum(-1), 1.0, atol=1e-4)
    assert np.load(sweep_dir / "lidar2globals.npy").shape == (2, 4, 4)


def test_cli_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["render_lidar", "--config", "tiny_debug", "--set",
            "dataset_loader=synthetic", "--azimuth_steps", "8"]
    with pytest.raises(SystemExit, match="--params"):
        cli.main(base + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(base + ["--allow_fresh", "--device", "cuda"])


def test_cli_import_leaves_jax_out():
    code = ("import sys; import nerf_lidar_tpu_torch.cli; "
            "import nerf_lidar_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_unported_flags_raise():
    """What still refuses: an MLP compute dtype and a warp neither package
    has (the JAX Dense takes only float32 / bfloat16 policies here, and
    `track_linearize` only 'contract'). Dynamic objects and the object-MLP
    flags (fixed_semantic, latent_size with split_latent, re_weights=False,
    warp_fn=None, density_init, obj_mode) build; a per-class slot list
    that does not name every object slot is refused. The field presets'
    flags (ms_coarse_res_cutoff, diff_inputs=False, interp='tetra', the
    spectral encoder, compute_dtype='bfloat16'), the background range,
    GLO, learned exposure and the Ref-NeRF flags, refused before, now
    build (`tests/test_torch_field_features.py` holds them to JAX)."""
    m = tconfigs.tiny_debug().model
    objs = Model(dataclasses.replace(m, instance_obj=True, num_objects=2,
                                     latent_size=8), device="meta")
    assert objs.has_objects and objs.obj_latents.shape == (2, 8)
    assert objs.obj_mlp.cfg.fixed_semantic and objs.obj_mlp.cfg.split_latent
    per_class = Model(dataclasses.replace(m, instance_obj=True, num_objects=2,
                                          obj_class_ids=(13, 14)),
                      device="meta")
    assert [p.cfg.class_type for p in per_class.obj_mlps()] == [13, 14]
    with pytest.raises(ValueError):
        Model(dataclasses.replace(m, instance_obj=True, num_objects=2,
                                  obj_class_ids=(13,)), device="meta")
    full = Model(dataclasses.replace(
        m, bg_intensity_range=(0.0, 1.0), num_glo_features=4,
        learned_exposure_scaling=True, nerf_mlp=dataclasses.replace(
            m.nerf_mlp, num_glo_features=4)), device="meta")
    assert full.glo_vecs.weight.shape == (1000, 4)
    assert full.exposure_scaling_offsets.weight.shape == (1000, 3)
    assert len(full.nerf_mlp.glo_layers) == 2
    for flag in (dict(use_directional_enc=True),
                 dict(scale_featurization=True),
                 dict(disable_density_normals=False),
                 dict(use_reflections=True, enable_pred_normals=True,
                      enable_pred_roughness=True, use_n_dot_v=True,
                      use_diffuse_color=True, use_specular_tint=True)):
        ZipMLP(dataclasses.replace(m.nerf_mlp, **flag), device="meta")
    for flag in (dict(compute_dtype="float16"),
                 dict(warp_fn="piecewise")):
        with pytest.raises(NotImplementedError):
            ZipMLP(dataclasses.replace(m.nerf_mlp, **flag), device="meta")
    g = m.nerf_mlp.grid
    for flag in (dict(ms_coarse_res_cutoff=64),
                 dict(grid=dataclasses.replace(g, diff_inputs=False)),
                 dict(grid=dataclasses.replace(g, interp="tetra")),
                 dict(grid=dataclasses.replace(g, encoder="dense_fourier")),
                 dict(compute_dtype="bfloat16")):
        mlp = ZipMLP(dataclasses.replace(m.nerf_mlp, **flag), device="meta")
        assert mlp.table.shape[1] == g.level_dim


@pytest.mark.parametrize("name", cli.CONFIGS)
def test_cli_presets_are_ported(name):
    args = cli.parse_args(["render_lidar", "--config", name])
    Model(cli.build_config(args).model, device="meta")
