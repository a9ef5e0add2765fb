"""Dynamic objects and pose / track refinement of the port against the JAX
package.

The small object config of tests/test_objects_pose.py: tiny_debug, 2
objects, object grid 4 -> 16 at 2^8 rows, latent 8, 5 classes. JAX
parameters (hash tables uniform(-0.5, 0.5), so that the encodes shape the
fields) go to the port through `convert`; the same numpy inputs go through
both packages. The training tests (losses, gradients, train steps, the
entries) are in test_torch_objects_train.py.

Tolerances, those of tests/test_torch_model.py and test_torch_train.py:
- elementwise functions (so3_exp, pose refinement, box transforms,
  get_pose), the object encode and MLP / composite outputs: rtol 1e-5 /
  atol 1e-6; the encode's VJP rtol 1e-4 / atol 1e-5 (table rows sum
  terms in another order);
- the model's renderings: depth rtol 1e-4, everything else atol 1e-5;
- loss terms rtol 1e-5 / atol 1e-9; gradients rtol 2e-3 / atol 1e-6 of
  the parameter's largest gradient (the static grids' tables at their
  init there, as in test_torch_train.py), where one entry in 500 (at
  least one) may miss if the port's float64 gradient of the same loss
  shows the miss to be JAX's float32 rounding: the port nearer to it than
  JAX (an entry whose terms cancel); parameters after each train step
  atol 1e-5, the refiners' (which move by ~1e-4 a step) atol 1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu.models import objects as jobj
from nerf_lidar_tpu.models import posenet as jpn
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.ops import grid as jgrid
from nerf_lidar_tpu_torch import convert
from nerf_lidar_tpu_torch import configs as tconfigs
from nerf_lidar_tpu_torch.models import objects as obj
from nerf_lidar_tpu_torch.models import posenet as pn
from nerf_lidar_tpu_torch.models.model import Model
from nerf_lidar_tpu_torch.ops import grid

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cfg(cfgs, **model_kw):
    """The object config of tests/test_objects_pose.py, from the JAX
    `configs` or the port's."""
    cfg = cfgs.tiny_debug()
    obj_grid = cfgs.GridConfig(level_dim=2, base_resolution=4,
                               desired_resolution=16, log2_hashmap_size=8)
    mcfg = dataclasses.replace(
        cfg.model, instance_obj=True, num_objects=2, latent_size=8,
        obj_mlp=dataclasses.replace(cfg.model.obj_mlp, grid=obj_grid,
                                    latent_size=8, class_num=5,
                                    class_type=3), **model_kw)
    return dataclasses.replace(cfg, model=mcfg, track_refine=True)


def _tracks():
    tracks = np.zeros((2, 4, 9), np.float32)
    tracks[:, :, :3] = np.array([[1.0, 0, 0], [2.0, 0.5, 0]])[:, None]
    tracks[:, :, 4:7] = 0.8
    tracks[:, :, -2] = np.arange(4)
    return tracks, np.array([True, True])


def _batch(r=8, labels=False):
    """Rays along +x through both boxes (tests/test_objects_pose.py), with
    the loss labels when `labels`."""
    d = np.tile([1.0, 0.0, 0.0], (r, 1)).astype(np.float32)
    b = dict(origins=np.zeros((r, 3), np.float32), directions=d, viewdirs=d,
             base_x=np.tile([0.0, 1.0, 0.0], (r, 1)).astype(np.float32),
             base_y=np.tile([0.0, 0.0, 1.0], (r, 1)).astype(np.float32),
             radii=np.full((r, 1), 1e-3, np.float32),
             near=np.full((r, 1), 0.2, np.float32),
             far=np.full((r, 1), 6.0, np.float32),
             timestamp=np.linspace(0, 3, r).astype(np.float32))
    if labels:
        rng = np.random.RandomState(0)
        b.update(rgb=rng.rand(r, 3).astype(np.float32),
                 depth=rng.rand(r).astype(np.float32) * 4,
                 semantic=rng.randint(0, 5, r).astype(np.int32),
                 rgb_mask=np.ones(r, bool), depth_mask=np.ones(r, bool),
                 sem_mask=np.ones(r, bool), lidar_mask=np.zeros(r, bool),
                 patch_mask=np.zeros(r, bool), loss_mask=np.ones(r, bool),
                 cam_idx=(np.arange(r) % 3).astype(np.int32)[:, None])
    return b


def _jax_params(jcfg, seed=0, uniform=None):
    """JAX params of the object model, the tables of the modules named in
    `uniform` (all when None) uniform(-0.5, 0.5), the rest at their init."""
    tracks, mask = _tracks()
    params = jax.jit(JaxModel(jcfg.model).init)(
        jax.random.PRNGKey(seed), None,
        {k: jnp.asarray(v) for k, v in _batch().items()},
        tracks=jnp.asarray(tracks), track_mask=jnp.asarray(mask))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(seed + 1)
    for name, sub in params["params"].items():
        if isinstance(sub, dict) and (uniform is None or name in uniform):
            sub["table"] = rng.uniform(-0.5, 0.5, sub["table"].shape).astype(
                np.float32)
    return params


def _port_model(cfg, params):
    model = Model(cfg.model)
    model.load_state_dict(convert.flax_to_state_dict(params, cfg.model))
    return model


@pytest.fixture(scope="module")
def shared():
    """(JAX cfg, port cfg, JAX params, port model) with one shared object
    MLP and the symmetry term on."""
    jcfg, cfg = (_cfg(c, symmetrize=True) for c in (configs, tconfigs))
    params = _jax_params(jcfg)
    return jcfg, cfg, params, _port_model(cfg, params)


@pytest.fixture(scope="module")
def per_class():
    """The same with one object MLP per class (classes 1 and 2)."""
    jcfg, cfg = (_cfg(c, obj_class_ids=(1, 2)) for c in (configs, tconfigs))
    params = _jax_params(jcfg, seed=3)
    return jcfg, cfg, params, _port_model(cfg, params)


# ------------------------------------------------------------- posenet
def test_so3_exp_matches_jax_and_has_a_finite_gradient_at_zero():
    rng = np.random.RandomState(0)
    r = np.concatenate([rng.randn(10, 3), 1e-4 * rng.randn(3, 3),
                        np.zeros((1, 3))]).astype(np.float32)
    np.testing.assert_allclose(_np(pn.so3_exp(_t(r))),
                               np.asarray(jpn.so3_exp(jnp.asarray(r))), **TOL)
    np.testing.assert_allclose(_np(pn.vec2skew(_t(r))),
                               np.asarray(jpn.vec2skew(jnp.asarray(r))))
    w = rng.randn(3, 3).astype(np.float32)
    zero = np.zeros((1, 3), np.float32)
    want = np.asarray(jax.grad(lambda x: (jpn.so3_exp(x) * w).sum())(
        jnp.asarray(zero)))
    x = _t(zero).requires_grad_(True)
    (pn.so3_exp(x) * _t(w)).sum().backward()
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(_np(x.grad), want, **TOL)


@pytest.mark.parametrize("learn_R,learn_t", [(True, False), (False, True),
                                             (True, True)])
def test_learnpose_and_pose_refinement_match_jax(learn_R, learn_t):
    rng = np.random.RandomState(1)
    r, t = (0.1 * rng.randn(5, 3).astype(np.float32) for _ in range(2))
    cam = np.array([0, 4, 2, 2, 1], np.int32)
    jmod = jpn.LearnPose(num_cams=4, num_lidars=1, t_ratio=0.25,
                         learn_R=learn_R, learn_t=learn_t)
    jR, jt = jmod.apply({"params": {"r": r, "t": t}}, jnp.asarray(cam))
    mod = pn.LearnPose(4, 1, t_ratio=0.25, learn_R=learn_R, learn_t=learn_t)
    convert.load_refiners({"posenet": {"params": {"r": r, "t": t}}},
                          posenet=mod)
    R, tt = mod(_t(cam))
    np.testing.assert_allclose(_np(R), np.asarray(jR), **TOL)
    np.testing.assert_allclose(_np(tt), np.asarray(jt), **TOL)
    batch = {k: rng.randn(5, 3).astype(np.float32) for k in (
        "origins", "directions", "viewdirs", "base_x", "base_y", "normals")}
    want = jpn.apply_pose_refinement(jR, jt, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
    got = pn.apply_pose_refinement(R, tt, {k: _t(v) for k, v in
                                           batch.items()})
    for k in batch:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_trackopt_matches_jax():
    rng = np.random.RandomState(2)
    tracks = rng.rand(2, 5, 9).astype(np.float32)
    p = dict(opt_r=rng.randn(2, 5, 1).astype(np.float32) * 0.1,
             opt_t=rng.randn(2, 5, 3).astype(np.float32) * 0.1)
    want = jpn.TrackOpt(2, 5).apply({"params": p}, jnp.asarray(tracks))
    mod = pn.TrackOpt(2, 5)
    convert.load_refiners({"tracknet": {"params": p}}, tracknet=mod)
    np.testing.assert_allclose(_np(mod(_t(tracks))), np.asarray(want), **TOL)
    assert convert.flatten_params(convert.refiners_to_flax(
        tracknet=mod))["tracknet/params/opt_t"].shape == (2, 5, 3)


# ------------------------------------------------------- box transforms
def test_box_transforms_match_jax():
    rng = np.random.RandomState(3)
    pts = rng.randn(6, 5, 3).astype(np.float32) * 1.5
    vd = rng.randn(6, 3).astype(np.float32)
    pose = np.concatenate([rng.randn(6, 3, 3), rng.rand(6, 3, 1) * 3,
                           rng.uniform(0.5, 2.5, (6, 3, 3)),
                           rng.rand(6, 3, 2)], -1).astype(np.float32)
    pose[:, 2, 4:7] = 0.0  # a slot absent at this time
    th = rng.randn(6, 5).astype(np.float32)
    np.testing.assert_allclose(
        _np(obj.rotate_z(_t(pts), _t(th))),
        np.asarray(jobj.rotate_z(jnp.asarray(pts), jnp.asarray(th))), **TOL)
    args = (pts, vd[:, None], pose[:, :1, :3], pose[:, :1, 3],
            pose[:, :1, 4:7])
    for fn, jfn in ((obj.world2object, jobj.world2object),
                    (obj.object2world, jobj.object2world)):
        got = fn(*map(_t, args))
        want = jfn(*map(jnp.asarray, args))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
    got = obj.box_pts(_t(pts), _t(vd), _t(pose))
    want = jobj.box_pts(jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(pose))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    assert _np(got[2]).any() and not _np(got[2])[:, :, 2].any()
    o = rng.randn(40, 3).astype(np.float32) * 3
    d = rng.randn(40, 3).astype(np.float32)
    d[0] = [1.0, 0.0, 0.0]  # zero components take the 1e-12 guard
    got = obj.ray_box_intersection(_t(o), _t(d))
    want = jobj.ray_box_intersection(jnp.asarray(o), jnp.asarray(d))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    assert _np(got[2]).any() and not _np(got[2]).all()


@pytest.mark.parametrize("case", ["random", "midway", "duplicate_times"])
def test_get_pose_matches_jax(case):
    """Interpolation between the two nearest track rows. "midway": ray
    times exactly between two rows; "duplicate_times": padded rows that
    repeat a time (with other poses), where the lower row must win ties."""
    rng = np.random.RandomState(4)
    tracks = rng.randn(3, 6, 9).astype(np.float32)
    tracks[:, :, -2] = np.sort(rng.rand(3, 6) * 5, -1)
    time = rng.uniform(-1, 6, 50).astype(np.float32)
    if case == "midway":
        tracks[:, :, -2] = np.arange(6)
        time = np.arange(0.5, 5, 0.5).astype(np.float32)
    elif case == "duplicate_times":
        tracks[:, :, -2] = [0.0, 1.0, 2.0, 2.0, 2.0, 3.0]
        time = np.array([2.0, 2.5, 1.5, 2.25, 3.5, 0.0], np.float32)
    got = obj.get_pose(_t(time), _t(tracks))
    want = jobj.get_pose(jnp.asarray(time), jnp.asarray(tracks))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    got2 = obj.get_pose(_t(time[:, None]), _t(tracks))
    np.testing.assert_array_equal(_np(got2), _np(got))


@pytest.mark.parametrize("budget", [8, 40, 200])
def test_compact_flags_matches_jax(budget):
    rng = np.random.RandomState(5)
    flag = rng.rand(120) < 0.25
    ids, valid, pos = obj._compact_flags(_t(flag), budget)
    jids, jvalid, jpos = jobj._compact_flags(jnp.asarray(flag), budget)
    np.testing.assert_array_equal(_np(valid), np.asarray(jvalid))
    np.testing.assert_array_equal(_np(pos), np.asarray(jpos))
    v = np.asarray(jvalid)
    np.testing.assert_array_equal(_np(ids)[v], np.asarray(jids)[v])
    assert v.sum() == min(budget, flag.sum())


# ------------------------------------------------------------ encode
def test_obj_encode_matches_jax_hash_encode():
    """The object MLPs' encode: the port's multisample encode at n = 1 and
    stds = 0, whose erf weight is exactly 1, against JAX `hash_encode`,
    forward and VJP in table and x01."""
    cfg = _cfg(tconfigs).model.obj_mlp.grid
    spec, jspec = grid.spec_for(cfg), jgrid.spec_for(
        _cfg(configs).model.obj_mlp.grid)
    rng = np.random.RandomState(6)
    table = rng.uniform(-1, 1, (spec.total_rows, 2)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, (300, 3)).astype(np.float32)
    g = rng.randn(300, spec.output_dim).astype(np.float32)
    want, vjp = jax.vjp(lambda tb, xx: jgrid.hash_encode(tb, xx, jspec),
                        jnp.asarray(table), jnp.asarray(x))
    w_table, w_x = vjp(jnp.asarray(g))
    tt, tx = _t(table).requires_grad_(True), _t(x).requires_grad_(True)
    got = grid.hash_encode_multisample(tt, tx[:, None], torch.zeros(300, 1),
                                       spec)
    got.backward(_t(g))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(tt.grad), np.asarray(w_table), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(w_x), rtol=1e-4,
                               atol=1e-5)
    weight = torch.erf(1.0 / torch.sqrt(torch.clamp(torch.zeros(1),
                                                    min=1e-10)))
    assert float(weight) == 1.0


# ---------------------------------------------------------- compositing
def _composite_inputs(r, s, box):
    rng = np.random.RandomState(2)
    pts_w = rng.randn(r, s, 3).astype(np.float32) * 1.5
    vd = rng.randn(r, 3).astype(np.float32)
    pose = np.tile(np.array([[0, 0, 0, 0.3, box, box, box, 0, 0],
                             [0.3, 0, 0, 0.0, box, box, box, 0, 1]],
                            np.float32), (r, 1, 1))
    base = dict(density=rng.rand(r, s).astype(np.float32),
                rgb=rng.rand(r, s, 3).astype(np.float32),
                semantic=rng.rand(r, s, 5).astype(np.float32))
    return pts_w, vd, pose, base


def _jax_obj_fn(jcfg, params, cls=None):
    def fn(p, s, viewdirs=None, latent=None):
        return JaxModel(jcfg.model).apply(
            params, p, s, viewdirs, latent,
            method=lambda m, a, b, c, d: (
                m.obj_mlp if cls is None else m.obj_mlps[cls])(
                    a, b, viewdirs=c, latent=d))
    return fn


@pytest.mark.parametrize("mode", ["dense", "dense_per_class", "compact",
                                  "compact_per_class", "compact_overflow"])
def test_composite_objects_matches_jax(shared, per_class, mode):
    """composite_objects with the symmetry term and per-slot semantic ids,
    dense and budgeted (K = R S, and K = 8 with overflow), with one shared
    object MLP or one per class."""
    jcfg, _, params, model = per_class if "per_class" in mode else shared
    r, s = 6, 24
    pts_w, vd, pose, base = _composite_inputs(r, s, 2.5)
    mask = np.array([True, True])
    budget = dict(dense=None, dense_per_class=None,
                  compact_overflow=8).get(mode, r * s)
    kw = dict(is_prop=False, sym=True, obj_sem_ids=(3, 255),
              sample_budget=budget)
    if "per_class" in mode:
        jgroups = [(_jax_obj_fn(jcfg, params, 1), (0,)),
                   (_jax_obj_fn(jcfg, params, 2), (1,))]
        groups = [(model.obj_mlp_cls1, (0,)), (model.obj_mlp_cls2, (1,))]
        jmlp = mlp = None
    else:
        jgroups = groups = None
        jmlp, mlp = _jax_obj_fn(jcfg, params), model.obj_mlp
    want = jax.jit(lambda *a: jobj.composite_objects(
        jmlp, jnp.asarray(params["params"]["obj_latents"]), *a,
        class_groups=jgroups,
        **kw))(jnp.asarray(pts_w), jnp.asarray(vd), jnp.asarray(pose),
               jnp.asarray(mask), {k: jnp.asarray(v) for k, v in base.items()})
    got = obj.composite_objects(mlp, model.obj_latents, _t(pts_w), _t(vd),
                                _t(pose), _t(mask),
                                {k: _t(v) for k, v in base.items()},
                                class_groups=groups, **kw)
    assert set(got) == set(want)
    flag = np.asarray(want["obj_mask"]).any(-1)
    assert flag.sum() > 8 and (~flag).any(), "needs hits, misses, overflow"
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    if mode == "compact_overflow":
        assert int(got["obj_overflow"]) == flag.sum() - 8


# --------------------------------------------------------------- model
def _renderings_close(got, want):
    assert len(got) == len(want)
    for level, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), level
        for k in w:
            if k == "depth":
                np.testing.assert_allclose(_np(g[k]), np.asarray(w[k]),
                                           rtol=1e-4, err_msg=k)
            else:
                np.testing.assert_allclose(_np(g[k]), np.asarray(w[k]),
                                           atol=1e-5, err_msg=f"{k} {level}")


def _model_case(case, shared, per_class):
    """(JAX cfg, port cfg, params, port model, batch, tracks) of a case;
    "overflow" is the budget case of tests/test_objects_pose.py:678 (64
    contiguous rays through one big box, budget frac 0.01)."""
    tracks, _ = _tracks()
    if case == "per_class":
        return (*per_class, _batch(), tracks)
    if case != "overflow":
        return (*shared, _batch(), tracks)
    jcfg, cfg, params, _ = shared
    jcfg, cfg = (dataclasses.replace(c, model=dataclasses.replace(
        c.model, obj_sample_frac=0.01)) for c in (jcfg, cfg))
    tracks[:, :, 0] = 3.0
    tracks[:, :, 4:7] = 4.0
    tracks[1, :, -1] = 1
    return jcfg, cfg, params, _port_model(cfg, params), _batch(64), tracks


@pytest.mark.parametrize("case", ["shared", "per_class", "overflow"])
@pytest.mark.parametrize("train", [False, True])
def test_model_with_objects_matches_jax(shared, per_class, case, train):
    """The whole model with objects, key=None: eval takes the dense path,
    train=True the budgeted one (with obj_overflow, obj_hit_frac and, for
    the shared MLP, loss_sym)."""
    jcfg, cfg, params, model, batch, tracks = _model_case(case, shared,
                                                          per_class)
    mask = np.array([True, True])
    want, _ = jax.jit(lambda p, b, tr, tm: JaxModel(jcfg.model).apply(
        p, None, b, train=train, tracks=tr, track_mask=tm))(
            params, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(tracks), jnp.asarray(mask))
    with torch.no_grad():
        got, _ = model({k: _t(v) for k, v in batch.items()}, train=train,
                       tracks=_t(tracks), track_mask=_t(mask))
    _renderings_close(got, want)
    assert bool(got[-1]["obj_mask"].any())
    assert ("obj_overflow" in got[-1]) == train
    if train and case == "overflow":
        assert int(got[-1]["obj_overflow"]) > 0


def test_render_instance_matches_jax(shared):
    """One object's field alone, orbiting its unit box, as the JAX
    render_instance renders it (atol 1e-5)."""
    jcfg, _, params, model = shared
    kw = dict(height=6, width=5, num_views=2, num_samples=12)
    want = jobj.render_instance(JaxModel(jcfg.model), params, 1, **kw)
    got = obj.render_instance(model, 1, **kw)
    assert got.shape == (2, 6, 5, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - 1.0).max() > 1e-3  # the box is not empty


def test_track_edits_match_jax():
    """query_class, simu_info (every scene-edit mode), manipulate_tracks
    and edit_tracks on numpy tracks, as the JAX package edits them."""
    for name in ("human.pedestrian.adult", "vehicle.truck", "vehicle.bus",
                 "vehicle.car", "movable_object.barrier", "vehicle.trailer"):
        assert obj.query_class(name) == jobj.query_class(name), name
    tracks, mask = _tracks()
    for mode in ("replay", "laneshift", "removal", "rotate"):
        angle, got = obj.simu_info(mode, tracks)
        jangle, want = jobj.simu_info(mode, tracks)
        assert angle == jangle and (got is None) == (want is None), mode
        if got is not None:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_allclose(obj.manipulate_tracks(tracks, 15.0),
                               jobj.manipulate_tracks(tracks, 15.0), **TOL)
    _, moved = obj.simu_info("laneshift", _t(tracks))  # a torch copy
    assert isinstance(moved, torch.Tensor) and np.array_equal(
        _np(moved)[..., 1], tracks[..., 1] + np.float32(0.03))
    got = obj.edit_tracks(tracks, mask, ["vehicle.car"] * 2, tracks[0])
    want = jobj.edit_tracks(tracks, mask, ["vehicle.car"] * 2, tracks[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
