"""`spectral_obj_variant`: the per-object fields on the spectral encoder
(dense tetrahedral band + pooled Fourier features, `re_weights=False`,
position gradients on, for track refinement) against the JAX package, on
the object config, inputs and helpers of tests/test_torch_objects.py:
the model's renderings with the objects composited (inference and the
training budget), every loss term and gradient (the object table and the
tracknet's, which reach the tetrahedral encode's position gradient), and
two train steps with track refinement.

Tolerances, those of tests/test_torch_objects.py: renderings depth rtol
1e-4, the rest atol 1e-5; loss terms rtol 1e-5 / atol 1e-9; gradients as
tests/test_torch_presets.py (rtol 2e-3 / atol 1e-6 of the largest entry,
or the port no farther than JAX from its float64 gradient); parameters
after each step atol 1e-5, the tracknet's atol 1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu.models import posenet as jpn
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.train import train_step as jtrain
from nerf_lidar_tpu_torch import configs as tconfigs
from nerf_lidar_tpu_torch import convert
from nerf_lidar_tpu_torch.models import posenet as pn
from nerf_lidar_tpu_torch.ops import grid
from nerf_lidar_tpu_torch.train import train_step
from test_torch_objects import (_batch, _cfg, _jax_params, _np,
                                _port_model, _renderings_close, _t, _tracks)
from test_torch_objects_train import _loss_fns, _port_grads_f64
from test_torch_presets import assert_grads_match


@pytest.fixture(scope="module")
def spectral():
    """(JAX cfg, port cfg, JAX params, port model): the object config with
    the symmetry term, its object grid on the spectral encoder."""
    jcfg, cfg = (c.spectral_obj_variant(_cfg(c, symmetrize=True))
                 for c in (configs, tconfigs))
    params = _jax_params(jcfg)
    return jcfg, cfg, params, _port_model(cfg, params)


def test_spectral_object_grid(spectral):
    """The dense band of the object grid (4 -> 16: levels 5, 9, 17, all
    tiled, tetrahedral, position gradients on), the 96 pooled Fourier
    frequencies, and the first Dense taking L*C + 2F + half the latent."""
    _, cfg, _, model = spectral
    mlp = model.obj_mlp
    spec = mlp.spec
    assert (spec.interp, spec.diff_inputs) == ("tetra", True)
    assert spec.resolutions == (5, 9, 17)
    assert all(spec.is_tiled(l) for l in range(spec.num_levels))
    assert mlp.fourier_freqs.shape == (3, 96)
    assert "fourier_freqs" not in model.state_dict()
    assert mlp.density_layers[0].in_features == (
        spec.output_dim + 2 * 96 + cfg.model.latent_size // 2)
    assert grid.mean_levels(spec, cfg.model.obj_mlp.ms_coarse_res_cutoff) \
        == [False] * 3


@pytest.mark.parametrize("train", [False, True])
def test_spectral_objects_render_as_jax(spectral, train):
    jcfg, cfg, params, model = spectral
    tracks, mask = _tracks()
    batch = _batch()
    want, _ = jax.jit(lambda p, b, tr, tm: JaxModel(jcfg.model).apply(
        p, None, b, train=train, tracks=tr, track_mask=tm))(
            params, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(tracks), jnp.asarray(mask))
    with torch.no_grad():
        got, _ = model({k: _t(v) for k, v in batch.items()}, train=train,
                       tracks=_t(tracks), track_mask=_t(mask))
    _renderings_close(got, want)
    assert bool(got[-1]["obj_mask"].any())


def test_spectral_objects_losses_and_gradients_match_jax(spectral):
    """Every loss term and gradient with the tracknet live: its opt_t
    gradient reaches the object encode's tetrahedral position gradient
    and the Fourier band's."""
    jcfg, cfg = (dataclasses.replace(c, obj_nodecay=False, sym_start=0)
                 for c in spectral[:2])
    params = _jax_params(jcfg, uniform=("obj_mlp",))
    tracks, mask = _tracks()
    rng = np.random.RandomState(7)
    tn = {"params": dict(opt_r=0.05 * rng.randn(2, 4, 1).astype(np.float32),
                         opt_t=0.05 * rng.randn(2, 4, 3).astype(np.float32))}
    batch = _batch(labels=True)
    jloss, loss = _loss_fns(jcfg, cfg, batch, tracks, mask, step=3)
    (_, jterms), (g_model, g_tn) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, tn)
    model = _port_model(cfg, params)
    tracknet = pn.TrackOpt(2, 4)
    convert.load_refiners({"tracknet": tn}, tracknet=tracknet)
    val, terms = loss(model, tracknet)
    val.backward()
    assert set(terms) == set(jterms) and "hash_decay" in terms
    for k in terms:
        np.testing.assert_allclose(_np(terms[k]), np.asarray(jterms[k]),
                                   rtol=1e-5, atol=1e-9, err_msg=k)
    grads = {"model/" + k: v for k, v in convert.flatten_params(
        convert.state_dict_to_flax(
            {k: p.grad for k, p in model.named_parameters()})).items()}
    grads.update({f"tracknet/params/{k}": _np(p.grad)
                  for k, p in tracknet.named_parameters()})
    want = convert.flatten_params({"model": jax.tree_util.tree_map(
        np.asarray, g_model), "tracknet": jax.tree_util.tree_map(
            np.asarray, g_tn)})
    ref = {(k if k.startswith("tracknet") else "model/" + k): v
           for k, v in _port_grads_f64(cfg, params, tn, batch, tracks, mask,
                                       step=3).items()}
    assert float(np.abs(want["tracknet/params/opt_t"]).max()) > 0
    assert float(np.abs(want["model/params/obj_mlp/table"]).max()) > 0
    assert_grads_match(grads, want, ref)


def test_spectral_objects_two_steps_match_jax(spectral):
    """Two steps of the port's train_step against JAX make_train_step with
    track refinement live from step 0 (no warm-up), so that the tracknet
    moves through the spectral object encode."""
    jcfg, cfg, params, _ = spectral
    kw = dict(track_start_opt=0, lr_delay_steps=0, max_steps=20)
    jcfg, cfg = (dataclasses.replace(c, **kw) for c in (jcfg, cfg))
    tracks, mask = _tracks()
    batch = _batch(labels=True)
    tracknet = jpn.TrackOpt(num_objects=2, num_timestamps=4)
    zeros = lambda *s: np.zeros(s, np.float32)
    state, tx = jtrain.create_train_state(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params),
        tracknet_params={"params": dict(opt_r=zeros(2, 4, 1),
                                        opt_t=zeros(2, 4, 3))})
    step_fn = jtrain.make_train_step(JaxModel(jcfg.model), tx, jcfg,
                                     donate=False, tracknet_model=tracknet)
    model = _port_model(cfg, params)
    tnet = pn.TrackOpt(2, 4)
    opt = train_step.make_optimizer(model, cfg, tracknet=tnet)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for step in range(2):
        state, jstats = step_fn(state, jb, None, jnp.asarray(tracks),
                                jnp.asarray(mask))
        stats = train_step.train_step(
            model, opt, cfg, {k: _t(v) for k, v in batch.items()}, step,
            tracknet=tnet, tracks=_t(tracks), track_mask=_t(mask))
        np.testing.assert_allclose(float(stats["loss"]),
                                   float(jstats["loss"]), rtol=1e-4)
        got = convert.flatten_params(convert.train_params_to_flax(
            model, None, tnet))
        want = convert.flatten_params(jax.tree_util.tree_map(
            np.asarray, state.params))
        assert set(got) == set(want)
        for k in want:
            atol = 1e-5 if k.startswith("model") else 1e-7
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                       err_msg=f"step {step} {k}")
    assert float(np.abs(got["tracknet/params/opt_t"]).max()) > 1e-6
