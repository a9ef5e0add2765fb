"""The port's ray-drop trainer, inference and export against the JAX
package's on the same inputs and the same weights.

Range images of H, W = 16, 64 at the U-Net's full widths; inputs from a
seed with numpy; the JAX trainer's U-Net, VGG and Darknet weights carried
across by `convert.py`, its Gumbel noise and roll shift injected. The JAX
package's native library is off (`no_native`): the port is its numpy
branch.

Tolerances: the train step in float64 (see its test for why), 1e-9 of
each tensor's max; float32 loss values rtol 1e-5; keep probabilities 1e-5
absolute; exported files equal, and keep masks equal at every pixel whose
probability lies farther than 1e-4 from the threshold (and, under the car
rule, from the car median).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import native as jnative
from nerf_lidar_tpu.lidar import export as jexport
from nerf_lidar_tpu.lidar import sensor as jsensor
from nerf_lidar_tpu.raydrop import infer as jinfer
from nerf_lidar_tpu.raydrop import pretrain as jpretrain
from nerf_lidar_tpu.raydrop import trainer as jtrainer
from nerf_lidar_tpu.raydrop import val_vis as jval_vis
from nerf_lidar_tpu.raydrop import vgg as jvgg
from nerf_lidar_tpu_torch import convert
from nerf_lidar_tpu_torch.lidar import export, range_image
from nerf_lidar_tpu_torch.raydrop import infer, pretrain, trainer, val_vis
from nerf_lidar_tpu_torch.raydrop import vgg
from nerf_lidar_tpu_torch.raydrop.unet import UNet

H, W = 16, 64


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this module runs: the tier runs several
    test files at once, and convolutions at the U-Net's widths on every
    core of each worker oversubscribe the machine (measured 10x slower)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data(n=4, seed=0):
    """Images whose GT keep mask is 'the simulated range is not 0'."""
    rng = np.random.RandomState(seed)
    images = rng.rand(n, H, W, 6).astype(np.float32)
    images[..., 0] *= (rng.rand(n, H, W) > 0.3)
    masks = (images[..., 0] > 0).astype(np.int32)
    ranges = (images[..., 0] * 0.9 + 0.05 * rng.rand(n, H, W)).astype(
        np.float32)
    return dict(images=images, masks=masks, ranges=ranges)


def moved_stats(batch_stats, seed):
    """BatchNorm running statistics moved off their init (mean 0, var 1)
    to seeded means ~ N(0, 0.1) and variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    flat = convert.flatten_params(batch_stats)
    return convert.unflatten_params({
        k: (rng.randn(*v.shape) * 0.1 if k.endswith("mean")
            else rng.rand(*v.shape) + 0.5).astype(np.float32)
        for k, v in flat.items()})


def _pair(vgg_on=True, darknet=False, regression=False, seed=0):
    """The JAX trainer with an initialised state (its BatchNorm statistics
    moved off their init), and the port's trainer and state with the same
    U-Net, VGG and Darknet weights."""
    kw = dict(vgg=vgg_on, darknet=darknet, regression=regression)
    jt = jtrainer.RayDropTrainer(jtrainer.RayDropConfig(**kw))
    js = jt.init_state(jax.random.PRNGKey(seed), H, W)
    js = js.replace(batch_stats=jax.tree.map(
        jnp.asarray, moved_stats(_np(js.batch_stats), seed)))
    pt = trainer.RayDropTrainer(trainer.RayDropConfig(**kw))
    if vgg_on:
        pt.vgg_model.load_state_dict(convert.vgg_from_flax(
            _np(jt.vgg_params), pt.vgg_model))
    if darknet:
        pt.dk_model.load_state_dict(convert.darknet_from_flax(
            _np(jt.dk_params), pt.dk_model))
    model = UNet(regression=regression)
    model.load_state_dict(convert.unet_from_flax(
        _np({"params": js.params, "batch_stats": js.batch_stats}), model))
    return jt, js, pt, pt.make_state(model)


def _tensors(data, idx):
    img = torch.from_numpy(data["images"][idx]).permute(0, 3, 1, 2)
    return (img.contiguous(), torch.from_numpy(data["masks"][idx]),
            torch.from_numpy(data["ranges"][idx]))


def _grads_as_flax(model):
    """The U-Net's parameter gradients in the Flax params layout."""
    g = copy.deepcopy(model)
    for p, q in zip(g.parameters(), model.parameters()):
        p.data = q.grad.clone()
    return convert.flatten_params(convert.unet_to_flax(g)["params"])


def assert_rel(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3g} of max > {tol}"


def _jax_noise(key, n):
    return jax.random.gumbel(key, (n, H, W, 2), jnp.float32)


def test_gumbel_softmax_hard_matches_jax():
    """One-hot forward and the straight-through gradient, noise injected."""
    key = jax.random.PRNGKey(3)
    logits = np.random.RandomState(0).randn(2, H, W, 2).astype(np.float32)
    ct = np.random.RandomState(1).randn(2, H, W, 2).astype(np.float32)
    want, vjp = jax.vjp(lambda l: jtrainer.gumbel_softmax_hard(key, l),
                        jnp.asarray(logits))
    noise = torch.from_numpy(np.asarray(_jax_noise(key, 2))).permute(
        0, 3, 1, 2)
    lt = torch.from_numpy(logits).permute(0, 3, 1, 2).requires_grad_()
    got = trainer.gumbel_softmax_hard(lt, dim=1, noise=noise)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got.detach().sum(1).numpy(), 1.0, atol=1e-6)
    (got * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(lt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(vjp(jnp.asarray(ct))[0]),
                               rtol=1e-5, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    a = trainer.gumbel_softmax_hard(lt.detach(), dim=1, generator=g)
    b = trainer.gumbel_softmax_hard(
        lt.detach(), dim=1, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    np.testing.assert_allclose(a, a.round(), atol=1e-6)


def _to64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                        tree)


def _opt_flat(state, name):
    """A torch Adam moment ('exp_avg' / 'exp_avg_sq') of every U-Net
    parameter, in the Flax params layout."""
    g = copy.deepcopy(state.model)
    for p, q in zip(g.parameters(), state.model.parameters()):
        p.data = state.optimizer.state[q][name].clone()
    return convert.flatten_params(convert.unet_to_flax(g)["params"])


def test_two_train_steps_match_jax_in_float64():
    """Two Adam steps with every loss term but Darknet's (CE, VGG at 0.2
    with the Gumbel-hard mask, range L1) against the JAX `_train_step`,
    with its roll shift and Gumbel noise injected, both in float64.

    float64, because in float32 the two sides round differently, and where
    a pre-activation lies within rounding of 0 a ReLU's mask flips (and
    |a - b| in the VGG term turns its derivative's sign): such a flip moves
    a deep layer's gradient by up to 25% of its max (measured; float32
    torch against float64 torch alike), and Adam's first step moves each
    weight by about lr * sign(g). In float64 no flip occurs and the two
    sides agree to ~1e-13. Held: the losses of both steps (rtol 1e-9); the
    first step's gradients through Adam's first moment (mu = (1 - b1) g
    after one step; 1e-9 of each tensor's max) and second moment; every
    parameter and BatchNorm buffer after each step (1e-9 of each tensor's
    max)."""
    with jax.enable_x64(True):
        jt, js, pt, ps = _pair(True, False, True, seed=2)
        jt.vgg_params = _to64(jt.vgg_params)
        js = js.replace(params=_to64(js.params),
                        batch_stats=_to64(js.batch_stats),
                        opt_state=jt.tx.init(_to64(js.params)))
        ps = pt.make_state(ps.model.double())
        pt.vgg_model.double()
        data = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                for k, v in _data(4, seed=2).items()}
        idx = [np.array([0, 1]), np.array([2, 3])]
        keys = jax.random.split(jax.random.PRNGKey(4), 2)
        for step, key in enumerate(keys):
            roll_key, gumbel_key = jax.random.split(key)
            shift = int(jax.random.randint(roll_key, (), 0, W))
            js, jstats = jt._jit_train(
                js, *(jnp.asarray(data[k][idx[step]])
                      for k in ("images", "masks", "ranges")), key)
            noise = torch.from_numpy(np.array(jax.random.gumbel(
                gumbel_key, (2, H, W, 2), jnp.float64))).permute(0, 3, 1, 2)
            stats = pt.train_step(ps, *_tensors(data, idx[step]),
                                  shift=shift, noise=noise)
            assert set(stats) == set(jstats) == {"ce", "vgg", "range_l1",
                                                 "loss"}
            for k in jstats:
                np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                           rtol=1e-9, err_msg=k)
            if step == 0:
                adam = js.opt_state[0]
                for name, want in (("exp_avg", adam.mu),
                                   ("exp_avg_sq", adam.nu)):
                    got = _opt_flat(ps, name)
                    for k, v in convert.flatten_params(_np(want)).items():
                        assert_rel(got[k], v, 1e-9, f"{name} {k}")
            got = convert.flatten_params(convert.unet_to_flax(ps.model))
            want = convert.flatten_params(_np(
                {"params": js.params, "batch_stats": js.batch_stats}))
            assert set(got) == set(want)
            for k, v in want.items():
                assert_rel(got[k], v, 1e-9, f"step {step + 1} {k}")
        assert ps.step == int(js.step) == 2


def test_losses_with_darknet_match_jax():
    """The train-mode losses with every term on (CE, VGG 0.2, Darknet 0.5),
    the Gumbel noise injected, in float32: each term rtol 1e-5. (The
    Darknet term's gradients with respect to the sim range and the mask:
    tests/test_torch_raydrop_model.py.)"""
    jt, js, pt, ps = _pair(True, True, False)
    data = _data(2, seed=1)
    key = jax.random.PRNGKey(11)
    _, (jstats, _) = jax.jit(jt._losses, static_argnums=6)(
        js.params, js.batch_stats, jnp.asarray(data["images"]),
        jnp.asarray(data["masks"]), jnp.asarray(data["ranges"]), key, True)
    noise = torch.from_numpy(np.array(_jax_noise(key, 2))).permute(
        0, 3, 1, 2)
    with torch.no_grad():
        _, stats = pt.losses(ps.model, *_tensors(data, slice(None)), True,
                             noise=noise)
    assert set(stats) == set(jstats) == {"ce", "vgg", "darknet", "loss"}
    for k in jstats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=1e-5, err_msg=k)
    for m in (pt.vgg_model, pt.dk_model):
        assert not m.training
        assert not any(p.requires_grad for p in m.parameters())


def test_predict_and_evaluate_match_jax():
    """predict_prob (1e-5) and evaluate's metrics on the same weights: rtol
    1e-5, the threshold's counts allowed to move by the pixels whose
    probability lies within 1e-4 of 0.5."""
    jt, js, pt, ps = _pair(False)
    data = _data(3, seed=3)
    want = jt.predict_prob(js, data["images"])
    got = pt.predict_prob(ps, data["images"])
    np.testing.assert_allclose(got, want, atol=1e-5)
    unsafe = int((np.abs(want - 0.5) < 1e-4).sum())
    assert unsafe < 0.01 * want.size and 0.05 < (want > 0.5).mean() < 0.95
    jm = jt.evaluate(js, data["images"], data["masks"], data["ranges"])
    pm = pt.evaluate(ps, data["images"], data["masks"], data["ranges"])
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5,
                                   atol=2 * unsafe / want.size, err_msg=k)


def test_checkpoints_round_trip_and_load_into_flax(tmp_path):
    """save writes raydrop_#####.pt (restored with its Adam state and step)
    and a Flax-layout .npz that the JAX UNet applies to the same keep
    probabilities (1e-5)."""
    _, _, pt, ps = _pair(False, seed=5)
    data = _data(2, seed=5)
    pt.train_step(ps, *_tensors(data, slice(None)), shift=3)
    path = pt.save(str(tmp_path), ps, 7)
    assert os.path.basename(path) == "raydrop_00007.pt"
    back = pt.restore(path)
    assert back.step == 1
    for a, b in zip(back.model.state_dict().values(),
                    ps.model.state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = back.optimizer.state_dict(), ps.optimizer.state_dict()
    for k in sb["state"]:
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name])
    want = pt.predict_prob(ps, data["images"])
    tree = convert.load_npz_params(str(tmp_path / "raydrop_00007.npz"))
    from nerf_lidar_tpu.raydrop.unet import UNet as JUNet
    logits = JUNet().apply(tree, jnp.asarray(data["images"]), train=False)
    np.testing.assert_allclose(np.asarray(jax.nn.softmax(logits)[..., 1]),
                               want, atol=1e-5)
    np.testing.assert_allclose(
        pt.predict_prob(pt.restore(str(tmp_path / "raydrop_00007.npz")),
                        data["images"]), want, atol=1e-6)
    with pytest.raises(SystemExit, match="msgpack"):
        pt.restore(str(tmp_path / "raydrop_00007.ckpt"))


def test_fit_split_metrics_and_learning(tmp_path, monkeypatch):
    """fit takes JAX's split (val_indices of both packages agree), writes
    checkpoints and metrics.json on the held-out frames, and learns the
    toy rule (CE falls; IoU > 0.8 on the training frames)."""
    data = _data(5, seed=6)
    for n, frac, seed in ((5, 0.2, 0), (10, 0.25, 3), (1, 0.2, 0)):
        np.testing.assert_array_equal(val_vis.val_indices(n, frac, seed),
                                      jval_vis.val_indices(n, frac, seed))
    pt = trainer.RayDropTrainer(trainer.RayDropConfig(
        epochs=20, batch_size=2, vgg=False, eval_every=10,
        early_stop=False))
    seen = []
    real_evaluate = pt.evaluate
    monkeypatch.setattr(pt, "evaluate", lambda s, im, *a, **k: (
        seen.append(im), real_evaluate(s, im, *a, **k))[1])
    state = pt.fit(data, save_dir=str(tmp_path), log_fn=lambda *_: None)
    idx = val_vis.val_indices(5, 0.2, 0)
    np.testing.assert_array_equal(seen[-1], data["images"][idx])
    saved = json.load(open(tmp_path / "metrics.json"))
    assert saved["split"] == "val" and saved["n_frames"] == len(idx)
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".pt")) == [
        "raydrop_00010.pt", "raydrop_00020.pt", "raydrop_00042.pt"]
    hist = pt.history
    assert len(hist) == 21 and hist[-1]["ce"] < hist[0]["ce"]
    assert "val_ce" in hist[10] and "val_ce" in hist[20]
    train = np.setdiff1d(np.arange(5), idx)
    m = real_evaluate(state, data["images"][train], data["masks"][train],
                      data["ranges"][train])
    assert m["iou"] > 0.8, m


def test_pretrain_vgg_learns_and_round_trips(tmp_path):
    """_corrupt's holes and noise; a short pretraining lowers its loss; the
    saved Flax-layout .npz loads here and in the JAX package into the same
    loss map."""
    g = torch.Generator().manual_seed(0)
    img = torch.rand(3, H, W, generator=g) + 0.5
    out = pretrain._corrupt(img, g, hole_w=16)
    assert out.shape == img.shape
    holes = out == 0
    assert 0.05 < holes.float().mean() < 0.9
    assert float((out - img)[~holes].abs().max()) < 0.2
    rng = np.random.RandomState(0)
    imgs = np.repeat(np.sin(np.linspace(0, 6, W))[None, None, :], H, 1)
    imgs = (imgs + rng.rand(6, H, W) * 0.05).astype(np.float32)
    enc, hist = pretrain.pretrain_vgg(imgs, steps=50, batch_size=2)
    losses = [l for _, l in hist["loss"]]
    assert losses[-1] < losses[0], losses
    path = str(tmp_path / "vgg.npz")
    pretrain.save_vgg_npz(path, enc)
    x = torch.from_numpy(imgs[:2])
    want = vgg.vgg_loss_map(enc, x, x * 0.9)
    got = vgg.vgg_loss_map(pretrain.load_vgg_npz(path), x, x * 0.9)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    jparams = jpretrain.load_vgg_npz(path)
    jmap = jvgg.vgg_loss_map(jvgg.Vgg19Features(), jparams,
                             jnp.asarray(imgs[:2]), jnp.asarray(imgs[:2] * .9))
    assert_rel(want.numpy(), np.asarray(jmap), 1e-5)
    t = trainer.RayDropTrainer(trainer.RayDropConfig(vgg=True, vgg_npz=path))
    assert torch.equal(t.vgg_model.convs["s0_c0"].weight,
                       enc.convs["s0_c0"].weight)


def _sweep(seed=0):
    """Points on the 16 even beams with plausible ranges (sensor frame)."""
    rng = np.random.RandomState(seed)
    d = jsensor.beam_directions(
        elevations_deg=jsensor.NUSC_ELEVATIONS_DEG[::2],
        azimuths=jsensor.azimuth_angles(W))
    pts = np.stack([d[:, 1], -d[:, 0], d[:, 2]], -1)
    r = rng.uniform(4, 60, pts.shape[0]).astype(np.float32)
    pts = (pts * r[:, None]).astype(np.float32)
    sem = rng.randint(0, 19, pts.shape[0])
    sem[::7] = 13  # cars, for the median rule
    rgb = rng.rand(pts.shape[0], 3).astype(np.float32)
    return pts, sem, rgb


def _safe(prob, labels_img, car_median_rule, eps=1e-4):
    """Pixels whose keep decision no rounding can flip: probability farther
    than eps from the threshold (and, under the car rule, a car pixel's
    from its image's median car probability)."""
    safe = np.abs(prob - infer.KEEP_THRESHOLD) >= eps
    car = labels_img == infer.CAR_CLASS
    if car_median_rule and car.any():
        med = np.median(prob[car])
        safe &= ~car | (np.abs(prob - med) >= eps)
    return safe


@pytest.mark.parametrize("car_median_rule", [False, True])
def test_drop_and_export_match_jax(tmp_path, no_native, car_median_rule):
    """drop_sweep's keep probabilities (1e-5) and keep mask (equal on every
    pixel `_safe` keeps), and drop_and_export's .bin / .label files (equal
    byte for byte when no pixel of a sweep is unsafe, else in size to
    within one row per unsafe pixel) against the JAX ones on the same
    weights, with intensity and without."""
    jt, js, pt, ps = _pair(False, seed=7)
    sweeps = [_sweep(0), _sweep(1) + (np.random.RandomState(2).rand(
        16 * W).astype(np.float32),)]
    kw = dict(h=H, w=W, car_median_rule=car_median_rule)
    unsafe = []
    for sw in sweeps:
        got = infer.drop_sweep(pt, ps, *sw, **kw)
        want = jinfer.drop_sweep(jt, js, *sw, **kw)
        np.testing.assert_allclose(got["keep_prob"], want["keep_prob"],
                                   atol=1e-5)
        labels_img = range_image.project_points(
            *sw[:2], h=H, w=W).semantic.astype(np.int32)
        safe = _safe(want["keep_prob"], labels_img, car_median_rule)
        np.testing.assert_array_equal(got["keep_mask"][safe],
                                      want["keep_mask"][safe])
        unsafe.append(int((~safe).sum()))
        if safe.all():
            for k in ("points", "labels", "intensity"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert len(got["points"]) > 0
        assert not (got["labels"] == infer.SKY_CLASS).any()
    assert sum(unsafe) < 0.01 * len(sweeps) * H * W
    n = infer.drop_and_export(pt, ps, sweeps, str(tmp_path / "port"), **kw)
    jn = jinfer.drop_and_export(jt, js, sweeps, str(tmp_path / "jax"), **kw)
    assert n == jn == 2
    for i in range(2):
        for sub, ext, row in (("velodyne", "bin", 16), ("labels", "label",
                                                        4)):
            name = f"{sub}/{i:06d}.{ext}"
            a = (tmp_path / "port" / name).read_bytes()
            b = (tmp_path / "jax" / name).read_bytes()
            if unsafe[i] == 0:
                assert a == b, name
            else:
                assert abs(len(a) - len(b)) <= row * unsafe[i], name
    assert len(export.read_label(str(tmp_path / "port" / "labels" /
                                     "000000.label"))) > 0
