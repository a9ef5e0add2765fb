"""Training with dynamic objects: the port's loss terms, gradients and
train steps with track / pose refinement against the JAX package, and the
port's train -> render_lidar entries on a synth_nusc scene with its moving
car. The object config, inputs and tolerances are those of
tests/test_torch_objects.py (see its docstring), whose helpers this file
uses.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import cli as jcli
from nerf_lidar_tpu import configs
from nerf_lidar_tpu.data import synth_nusc
from nerf_lidar_tpu.lidar.render import \
    render_sweeps_to_dir as jax_render_sweeps_to_dir
from nerf_lidar_tpu.models import posenet as jpn
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.renderer import ChunkRenderer as JaxChunkRenderer
from nerf_lidar_tpu.train import losses as jlosses
from nerf_lidar_tpu.train import train_step as jtrain
from nerf_lidar_tpu_torch import cli, convert
from nerf_lidar_tpu_torch.models import posenet as pn
from nerf_lidar_tpu_torch.ops import grid
from nerf_lidar_tpu_torch.train import losses, train_step
from test_torch_objects import (_batch, _jax_params, _np, _port_model, _t,
                                _tracks, shared)  # noqa: F401 (fixture)


def _loss_fns(jcfg, cfg, batch, tracks, mask, step):
    """(JAX loss of (params, tracknet params), port loss of (model,
    tracknet)): every loss term at `step`, through train=True."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(params, tn):
        tr = jpn.TrackOpt(2, 4).apply(tn, jnp.asarray(tracks))
        r, h = JaxModel(jcfg.model).apply(params, None, jb, train=True,
                                          tracks=tr,
                                          track_mask=jnp.asarray(mask))
        terms = jlosses.compute_losses(params, jb, r, h, jcfg, step)
        return jlosses.total_loss(terms), terms

    def loss(model, tracknet):
        tb = {k: _t(v) for k, v in batch.items()}
        r, h = model(tb, train=True, tracks=tracknet(_t(tracks)),
                     track_mask=_t(mask))
        terms = losses.compute_losses(model, tb, r, h, cfg, step)
        return losses.total_loss(terms), terms
    return jloss, loss


def _port_grads_f64(cfg, params, tn, batch, tracks, mask, step):
    """The port's gradients of the same loss in float64, flattened as
    `convert.flatten_params` names them (tracknet leaves too)."""
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        model = _port_model(cfg, params).double()
        tracknet = pn.TrackOpt(2, 4)
        convert.load_refiners({"tracknet": tn}, tracknet=tracknet)
        tb = {k: (_t(v).double() if np.asarray(v).dtype == np.float32
                  else _t(v)) for k, v in batch.items()}
        r, h = model(tb, train=True,
                     tracks=tracknet(_t(tracks).double()),
                     track_mask=_t(mask))
        losses.total_loss(losses.compute_losses(model, tb, r, h, cfg,
                                                step)).backward()
    finally:
        torch.set_default_dtype(default)
    out = convert.flatten_params(convert.state_dict_to_flax(
        {k: p.grad for k, p in model.named_parameters()}))
    out.update({f"tracknet/params/{k}": _np(p.grad)
                for k, p in tracknet.named_parameters()})
    return out


def test_losses_and_gradients_match_jax(shared):
    """Every loss term (symmetry after sym_start, latent_reg, the object
    table's hash decay with obj_nodecay off, the proposal loss without the
    object samples) and the gradients of every parameter, the object
    table, obj_latents and the tracknet's opt_t among them."""
    jcfg, cfg = (dataclasses.replace(c[0], obj_nodecay=False, sym_start=0)
                 for c in (shared[:1], shared[1:2]))
    # The static grids' tables at their init, as in test_torch_train.py:
    # uniform ones make the resampling chain compound each framework's
    # float32 rounding to ~1e-5 of the scale of most gradients.
    params = _jax_params(jcfg, uniform=("obj_mlp",))
    tracks, mask = _tracks()
    rng = np.random.RandomState(7)
    tn = {"params": dict(opt_r=0.05 * rng.randn(2, 4, 1).astype(np.float32),
                         opt_t=0.05 * rng.randn(2, 4, 3).astype(np.float32))}
    batch = _batch(labels=True)
    jloss, loss = _loss_fns(jcfg, cfg, batch, tracks, mask, step=3)
    (jval, jterms), (g_model, g_tn) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, tn)
    model = _port_model(cfg, params)
    tracknet = pn.TrackOpt(2, 4)
    convert.load_refiners({"tracknet": tn}, tracknet=tracknet)
    val, terms = loss(model, tracknet)
    val.backward()
    assert {"sym", "latent_reg", "hash_decay", "interlevel"} <= set(terms)
    assert set(terms) == set(jterms)
    for k in terms:
        np.testing.assert_allclose(_np(terms[k]), np.asarray(jterms[k]),
                                   rtol=1e-5, atol=1e-9, err_msg=k)
    assert float(terms["sym"].detach()) > 0
    grads = convert.flatten_params(convert.state_dict_to_flax(
        {k: p.grad for k, p in model.named_parameters()}))
    grads.update({f"tracknet/params/{k}": _np(p.grad)
                  for k, p in tracknet.named_parameters()})
    want = convert.flatten_params({"model": jax.tree_util.tree_map(
        np.asarray, g_model), "tracknet": jax.tree_util.tree_map(
            np.asarray, g_tn)})
    assert set(want) == {("model/" + k if not k.startswith("tracknet")
                          else k) for k in grads}
    ref = _port_grads_f64(cfg, params, tn, batch, tracks, mask, step=3)
    for k, g in grads.items():
        w = want[k if k.startswith("tracknet") else "model/" + k]
        scale = float(np.abs(w).max())
        if k in ("params/obj_mlp/table", "params/obj_latents",
                 "tracknet/params/opt_t"):
            assert scale > 0, k
        near = np.isclose(g, w, rtol=2e-3, atol=1e-6 * scale)
        # An entry whose terms cancel may miss JAX by more than that; it
        # passes only if the port is nearer than JAX to the port's float64
        # gradient, and only one entry in 500 (at least one) may.
        miss = np.abs(g - ref[k])
        assert (near | (miss < np.abs(w - ref[k]))).all(), k
        assert (~near).sum() <= max(1, near.size // 500), k


REFINE_KW = dict(pose_refine=True, start_step=0, end_step=10,
                 track_start_opt=0, lr_delay_steps=0, max_steps=20,
                 grad_max_norm=0.05)


@pytest.fixture(scope="module")
def refine_jax(shared):
    """Two steps of the JAX make_train_step with track_refine
    (track_start_opt = 0) and pose_refine (start_step = 0), no warm-up:
    (port cfg, JAX params, [(stats, flat params) per step]), shared by the
    tests of the port's steps in both modes."""
    jcfg, cfg, params, _ = shared
    jcfg, cfg = (dataclasses.replace(c, **REFINE_KW) for c in (jcfg, cfg))
    tracks, mask = _tracks()
    posenet = jpn.LearnPose(num_cams=3, num_lidars=1)
    tracknet = jpn.TrackOpt(num_objects=2, num_timestamps=4)
    zeros = lambda *s: np.zeros(s, np.float32)
    state, tx = jtrain.create_train_state(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params),
        {"params": dict(r=zeros(4, 3), t=zeros(4, 3))},
        {"params": dict(opt_r=zeros(2, 4, 1), opt_t=zeros(2, 4, 3))})
    step_fn = jtrain.make_train_step(JaxModel(jcfg.model), tx, jcfg,
                                     donate=False, posenet_model=posenet,
                                     tracknet_model=tracknet)
    jb = {k: jnp.asarray(v) for k, v in _batch(labels=True).items()}
    steps = []
    for _ in range(2):
        state, jstats = step_fn(state, jb, None, jnp.asarray(tracks),
                                jnp.asarray(mask))
        steps.append(({k: np.asarray(v) for k, v in jstats.items()},
                      convert.flatten_params(jax.tree_util.tree_map(
                          np.asarray, state.params))))
    return cfg, params, steps


def _port_refine_steps(cfg, params, steps):
    """The port's model, posenet, tracknet and optimizer from the shared
    params, after `steps` train steps on the refine batch: (model, posenet,
    tracknet, optimizer, [stats per step])."""
    tracks, mask = _tracks()
    batch = _batch(labels=True)
    model = _port_model(cfg, params)
    pnet, tnet = pn.LearnPose(3, 1), pn.TrackOpt(2, 4)
    opt = train_step.make_optimizer(model, cfg, pnet, tnet)
    stats = [train_step.train_step(
        model, opt, cfg, {k: _t(v) for k, v in batch.items()}, step,
        posenet=pnet, tracknet=tnet, tracks=_t(tracks), track_mask=_t(mask))
        for step in range(steps)]
    return model, pnet, tnet, opt, stats


def test_two_train_steps_with_track_and_pose_refinement_match_jax(
        refine_jax):
    """Two steps of the port's train_step against JAX make_train_step with
    track_refine (track_start_opt = 0) and pose_refine (start_step = 0),
    no warm-up, so that both refiners move in the second step; each
    group has its own rate, clip and Adam state."""
    cfg, params, jsteps = refine_jax
    model = _port_model(cfg, params)
    pnet, tnet = pn.LearnPose(3, 1), pn.TrackOpt(2, 4)
    opt = train_step.make_optimizer(model, cfg, pnet, tnet)
    assert [g["name"] for g in opt.param_groups] == ["model", "posenet",
                                                     "tracknet"]
    tracks, mask = _tracks()
    batch = _batch(labels=True)
    for step, (jstats, want) in enumerate(jsteps):
        stats = train_step.train_step(
            model, opt, cfg, {k: _t(v) for k, v in batch.items()}, step,
            posenet=pnet, tracknet=tnet, tracks=_t(tracks),
            track_mask=_t(mask))
        np.testing.assert_allclose(float(stats["loss"]),
                                   float(jstats["loss"]), rtol=1e-4)
        assert int(stats["obj_overflow"]) == int(jstats["obj_overflow"]) == 0
        np.testing.assert_allclose(float(stats["obj_hit_frac"]),
                                   float(jstats["obj_hit_frac"]), rtol=1e-6)
        got = convert.flatten_params(convert.train_params_to_flax(
            model, pnet, tnet))
        assert set(got) == set(want)
        for k in want:
            atol = 1e-5 if k.startswith("model") else 1e-7
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                       err_msg=f"step {step} {k}")
    moved = {k: float(np.abs(v).max()) for k, v in got.items()
             if not k.startswith("model")}
    assert min(moved.values()) > 1e-6, moved


def test_deterministic_refinement_steps_are_bit_identical_and_match_jax(
        refine_jax, monkeypatch):
    """The refinement recipe under torch's deterministic switch (pose
    refinement moves every ray, so every grid's encode backward takes
    d_x01 and d_stds; track refinement on): two runs of two steps give the
    same bits in every parameter, buffer and Adam moment of the model,
    posenet and tracknet, and the same stats; the losses match the JAX
    steps at rtol 1e-4."""
    cfg, params, jsteps = refine_jax
    asked = {}
    det = grid.hash_encode_multisample_bwd_det

    def recording(table, x01, stds, g_out, spec, needs, *a, **kw):
        asked[spec] = asked.get(spec, False) or bool(needs[1])
        return det(table, x01, stds, g_out, spec, needs, *a, **kw)

    monkeypatch.setattr(grid, "hash_encode_multisample_bwd_det", recording)
    runs = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            runs.append(_port_refine_steps(cfg, params, len(jsteps)))
    finally:
        torch.use_deterministic_algorithms(was)
    specs = {m.spec for m in (runs[0][0].nerf_mlp, *runs[0][0].prop_mlps,
                              runs[0][0].obj_mlp)}
    assert all(m.spec.diff_inputs for m in (runs[0][0].nerf_mlp,
                                            *runs[0][0].prop_mlps,
                                            runs[0][0].obj_mlp))
    assert set(asked) == specs and all(asked.values()), asked
    (m0, p0, t0, o0, s0), (m1, p1, t1, o1, s1) = runs
    for a, b in ((m0, m1), (p0, p1), (t0, t1)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    for q0, q1 in zip((q for g in o0.param_groups for q in g["params"]),
                      (q for g in o1.param_groups for q in g["params"])):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(o0.state[q0][key], o1.state[q1][key])
    for a, b, (jstats, _) in zip(s0, s1, jsteps):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
        np.testing.assert_allclose(float(a["loss"]), float(jstats["loss"]),
                                   rtol=1e-4)
    assert float(p0.r.detach().abs().max()) > 0
    assert float(t0.opt_t.detach().abs().max()) > 0


def test_resume_from_a_jax_refinement_checkpoint(shared, tmp_path):
    """A JAX train state with pose and track refinement after one step
    (checkpoint_1.ckpt: the {model, posenet, tracknet} params and an optax
    multi_transform of three Adam groups) restores into a port model,
    posenet and tracknet whose every parameter was zeroed: step 1, the
    params and each group's Adam moments bit for bit, step = the group's
    count; the next step equals JAX's second step at the tolerances of
    the two-step test above."""
    from nerf_lidar_tpu.train import checkpoints as jcheckpoints
    from nerf_lidar_tpu_torch.train import checkpoints
    jcfg, cfg, params, _ = shared
    kw = dict(pose_refine=True, start_step=0, end_step=10, track_start_opt=0,
              lr_delay_steps=0, max_steps=20, grad_max_norm=0.05)
    jcfg, cfg = (dataclasses.replace(c, **kw) for c in (jcfg, cfg))
    tracks, mask = _tracks()
    jb = {k: jnp.asarray(v) for k, v in _batch(labels=True).items()}
    zeros = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    state, tx = jtrain.create_train_state(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params),
        {"params": dict(r=zeros(4, 3), t=zeros(4, 3))},
        {"params": dict(opt_r=zeros(2, 4, 1), opt_t=zeros(2, 4, 3))})
    step_fn = jtrain.make_train_step(
        JaxModel(jcfg.model), tx, jcfg, donate=False,
        posenet_model=jpn.LearnPose(num_cams=3, num_lidars=1),
        tracknet_model=jpn.TrackOpt(num_objects=2, num_timestamps=4))
    run = lambda st: step_fn(st, jb, None, jnp.asarray(tracks),  # noqa
                             jnp.asarray(mask))
    state1 = run(state)[0]
    jcheckpoints.save_checkpoint(str(tmp_path), state1, 1)
    state2, jstats = run(state1)

    model = _port_model(cfg, params)
    pnet, tnet = pn.LearnPose(3, 1), pn.TrackOpt(2, 4)
    opt = train_step.make_optimizer(model, cfg, pnet, tnet)
    with torch.no_grad():
        for m in (model, pnet, tnet):
            for p in m.parameters():
                p.zero_()
    assert checkpoints.restore_checkpoint(str(tmp_path), model, opt, pnet,
                                          tnet) == 1
    flat = lambda tree: convert.flatten_params(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree))
    got = convert.flatten_params(convert.train_params_to_flax(
        model, pnet, tnet))
    want = flat(state1.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    import optax
    state = opt.state_dict()["state"]
    index = {id(p): i for i, p in enumerate(
        p for g in opt.param_groups for p in g["params"])}
    for group, module in zip(("model", "posenet", "tracknet"),
                             (model, pnet, tnet)):
        adam = next(s for s in jax.tree_util.tree_leaves(
            state1.opt_state.inner_states[group], is_leaf=lambda x:
            isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState))
        named = dict(module.named_parameters())
        assert {float(state[index[id(p)]]["step"]) for p in
                named.values()} == {float(adam.count)} == {1.0}
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            moments = {n: state[index[id(p)]][key] for n, p in named.items()}
            got = (convert.flatten_params(convert.state_dict_to_flax(moments))
                   if group == "model" else
                   {f"params/{n}": v.numpy() for n, v in moments.items()})
            want = flat(tree[group])
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{group} {key} {k}")
    stats = train_step.train_step(
        model, opt, cfg, {k: _t(v) for k, v in _batch(labels=True).items()},
        1, posenet=pnet, tracknet=tnet, tracks=_t(tracks),
        track_mask=_t(mask))
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]),
                               rtol=1e-4)
    got = convert.flatten_params(convert.train_params_to_flax(
        model, pnet, tnet))
    for k, v in flat(state2.params).items():
        atol = 1e-5 if k.startswith("model") else 1e-7
        np.testing.assert_allclose(got[k], v, rtol=0, atol=atol, err_msg=k)


# -------------------------------------------------------------- entries
def test_train_then_render_objects_on_synth_nusc(tmp_path, monkeypatch):
    """The port's train entry on a small synth_nusc scene with its moving
    car (objects, tracknet) writes params that the port's render_lidar
    renders with the car (--obj_mode replay, laneshift, rotate), without it
    (removal) and with a second, inserted track (--insert_track, a slot
    with a zero latent), as the JAX package renders the same params
    (points rtol 1e-4 / atol 1e-5, the rest atol 1e-5)."""
    monkeypatch.chdir(tmp_path)
    scene = str(tmp_path / "scene")
    synth_nusc.write_scene_dir(scene, num_frames=4, sensor_num=1, height=24,
                               width=40, lidar_points_per_beam=32)
    base = ["--config", "tiny_debug", "--data_dir", scene, "--device", "cpu",
            "--exp_name", "objs", "--set", "dataset_loader=nusc",
            "--set", "sensor_num=1", "--set", "lidar_supervision=true",
            "--set", "model.instance_obj=true", "--set",
            "model.latent_size=8", "--set", "model.obj_mlp.class_num=5",
            "--set", "model.obj_mlp.grid.base_resolution=4",
            "--set", "model.obj_mlp.grid.desired_resolution=16",
            "--set", "model.obj_mlp.grid.log2_hashmap_size=8",
            "--set", "track_refine=true", "--set", "track_start_opt=0"]
    run = cli.main(["train", *base, "--steps", "2", "--set",
                    "print_every=1"])
    assert run.cfg.model.num_objects == 1 and run.tracknet is not None
    assert run.cfg.model.obj_sem_ids == (13,)
    assert all(h["obj_overflow"] == 0 for h in run.history)
    params = convert.load_npz_params(run.params)
    assert "obj_latents" in params["params"]
    inserted = _np(run.tracks)[0].copy()
    inserted[:, 1] += 1.0  # the same car, a lane over
    np.save(tmp_path / "insert.npy", inserted)
    dirs = {}
    for mode in ("replay", "removal", "laneshift", "rotate", "insert"):
        extra = (["--obj_mode", "replay", "--insert_track",
                  str(tmp_path / "insert.npy")] if mode == "insert"
                 else ["--obj_mode", mode])
        rendered = cli.main(["render_lidar", *base, "--mode", "replay",
                             *extra, "--num_sweeps", "1",
                             "--azimuth_steps", "16", "--params",
                             run.params])
        assert rendered.cfg.model.instance_obj == (mode != "removal")
        assert rendered.cfg.model.num_objects == dict(
            insert=2, removal=0).get(mode, 1)
        jcfg = configs.Config.from_dict(json.loads(rendered.cfg.to_json()))
        jax_dir = str(tmp_path / f"jax_{mode}")
        jax_render_sweeps_to_dir(
            JaxChunkRenderer(JaxModel(jcfg.model), jcfg,
                             jcfg.render_chunk_size, fused=False),
            jcli._pad_obj_latents(params, 2) if mode == "insert" else params,
            rendered.sweeps, rendered.near, rendered.far,
            rendered.frame, jax_dir,
            tracks=None if rendered.tracks is None
            else jnp.asarray(_np(rendered.tracks)),
            track_mask=None if rendered.track_mask is None
            else jnp.asarray(_np(rendered.track_mask)))
        names = sorted(os.listdir(jax_dir))
        assert len(names) == 3
        for name in names:
            got = np.load(os.path.join(rendered.sweep_dir, name))
            want = np.load(os.path.join(jax_dir, name))
            assert got.shape == want.shape and np.isfinite(got).all(), name
            if name.startswith("points_0"):
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                           err_msg=name)
            else:
                np.testing.assert_allclose(got, want, atol=1e-5,
                                           err_msg=name)
        dirs[mode] = rendered.sweep_dir
    assert dirs == {mode: os.path.join("exp", "objs", name) for mode, name in (
        ("replay", "lidar_replay"), ("removal", "lidar_replay_removal"),
        ("laneshift", "lidar_replay_laneshift"),
        ("rotate", "lidar_replay_rotate"), ("insert", "lidar_replay"))}
