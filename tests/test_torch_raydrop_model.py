"""The port's ray-drop networks against the JAX package's Flax modules on the
same inputs and the same weights (carried across by `convert.py`).

Sizes: range images of H, W = 16, 64 (as tests/test_raydrop.py), at the
U-Net's published widths (64-128-256-512-1024), VGG19 to relu4_1 and the
full Darknet-53. Inputs come from a seed with numpy; JAX runs on the CPU.
Tolerances (float32, both sides on the CPU; they differ only in the order
of float sums): eval-mode outputs 1e-5 of the largest value, train-mode
outputs (normalised by batch statistics, which amplify rounding) 1e-4,
BatchNorm buffers rtol 1e-5 (atol 1e-6 for running means near 0)
against Flax's, loss values rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_lidar_tpu.raydrop import darknet as jdk
from nerf_lidar_tpu.raydrop import pretrain as jpretrain
from nerf_lidar_tpu.raydrop import vgg as jvgg
from nerf_lidar_tpu.raydrop.unet import UNet as JUNet
from nerf_lidar_tpu_torch import convert
from nerf_lidar_tpu_torch.raydrop import darknet, pretrain, vgg
from nerf_lidar_tpu_torch.raydrop.unet import FlaxBatchNorm2d, UNet

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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_rel(got, want, tol, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3g} of max > {tol}"


def moved_stats(batch_stats, seed):
    """BatchNorm running statistics moved off their init (mean 0, var 1)
    to seeded means ~ N(0, 0.1) and variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    flat = convert.flatten_params(batch_stats)
    return convert.unflatten_params({
        k: (rng.randn(*v.shape) * 0.1 if k.endswith("mean")
            else rng.rand(*v.shape) + 0.5).astype(np.float32)
        for k, v in flat.items()})


def _unet_pair(bilinear, regression, seed=1):
    """A Flax UNet's variables (running statistics moved off their init)
    and the port's UNet with the same weights."""
    jm = JUNet(bilinear=bilinear, regression=regression)
    v = _np(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 6))))
    v["batch_stats"] = moved_stats(v["batch_stats"], seed)
    tm = UNet(bilinear=bilinear, regression=regression)
    tm.load_state_dict(convert.unet_from_flax(v, tm))
    return jm, v, tm


@pytest.mark.parametrize("bilinear,regression,hw", [
    (False, False, (H, W)), (True, True, (H, W)), (False, True, (18, 70))])
@pytest.mark.parametrize("train", [False, True])
def test_unet_forward_matches_flax(bilinear, regression, hw, train):
    """Logits (and the range head) in eval and train mode, both `Up`
    variants, and an odd size that the ups pad (18 x 70)."""
    jm, v, tm = _unet_pair(bilinear, regression)
    x = np.random.RandomState(2).randn(2, *hw, 6).astype(np.float32)
    if train:
        want, _ = jm.apply(v, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(x), train=False)
    tm.train(train)
    got = tm(_nchw(x))
    if not regression:
        got, want = (got,), (want,)
    assert len(got) == len(want) == (2 if regression else 1)
    for g, w_ in zip(got, want):
        assert_rel(_nhwc(g), w_, 1e-4 if train else 1e-5, "unet")
    if regression:
        reg = got[1].detach()
        assert float(reg.min()) >= 0 and float(reg.max()) <= 1


@pytest.mark.parametrize("bilinear", [False, True])
def test_unet_batchnorm_buffers_after_train_call(bilinear):
    """One train-mode call moves every running mean / variance as Flax's
    BatchNorm(momentum=0.9) does (biased batch variance)."""
    jm, v, tm = _unet_pair(bilinear, False)
    x = np.random.RandomState(3).randn(4, H, W, 6).astype(np.float32)
    _, upd = jm.apply(v, jnp.asarray(x), train=True,
                      mutable=["batch_stats"])
    tm.train()
    tm(_nchw(x))
    got = convert.flatten_params(convert.unet_to_flax(tm)["batch_stats"])
    want = convert.flatten_params(_np(upd["batch_stats"]))
    assert set(got) == set(want) and len(want) == (52 if bilinear else 36)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_flax_batchnorm_update_rule():
    """The update rule alone on a 2 x 4 x 6 batch: Flax's (biased variance,
    momentum 0.9), where nn.BatchNorm2d would give the unbiased one."""
    import flax.linen as fnn
    x = np.random.RandomState(0).randn(2, 4, 6, 3).astype(np.float32) * 2
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    t = FlaxBatchNorm2d(3).train()
    out = t(_nchw(x))
    assert_rel(_nhwc(out), y, 1e-5)
    np.testing.assert_allclose(t.running_mean.numpy(),
                               upd["batch_stats"]["mean"], rtol=1e-5)
    np.testing.assert_allclose(t.running_var.numpy(),
                               upd["batch_stats"]["var"], rtol=1e-5)
    ref = torch.nn.BatchNorm2d(3).train()
    ref(_nchw(x))
    assert not np.allclose(ref.running_var.numpy(),
                           upd["batch_stats"]["var"], rtol=1e-4)


def test_unet_conversion_round_trips():
    jm, v, tm = _unet_pair(False, True)
    back = convert.unet_to_flax(tm)
    want = convert.flatten_params(v)
    got = convert.flatten_params(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(KeyError):
        convert.unet_from_flax(v, UNet(regression=False))


def test_bilinear_resize_equals_jax_image_resize():
    """F.interpolate(bilinear, align_corners=False) is jax.image.resize's
    bilinear when upsampling (by 2, and to 8x and 4x the size, as the VGG
    loss resizes its feature maps)."""
    x = np.random.RandomState(0).randn(2, 3, 5, 7).astype(np.float32)
    for size in ((6, 14), (24, 56), (12, 28), (3, 7)):
        got = F.interpolate(torch.from_numpy(x), size=size, mode="bilinear",
                            align_corners=False)
        want = jax.image.resize(x.transpose(0, 2, 3, 1),
                                (2, *size, 3), "bilinear")
        if size[0] >= x.shape[2]:
            assert_rel(_nhwc(got), want, 1e-6, str(size))


def _vgg_pair(seed=0):
    model, params = jvgg.init_vgg(jax.random.PRNGKey(seed), H, W)
    params = _np(params)
    tm = vgg.Vgg19Features()
    tm.load_state_dict(convert.vgg_from_flax(params, tm))
    return model, params, vgg.freeze(tm)


def test_vgg_loss_map_matches_jax():
    """vgg_loss_map, the trunk's vector-Jacobian product (1e-5 of max) and
    the map's gradient with respect to the input; the target takes no
    gradient. The map's gradient is held to 3e-3 of its max: |a - b| turns
    its derivative's sign where a and b tie, and a relu output that rounds
    to 0 on one side and to 1e-9 on the other breaks a tie differently
    (measured: 1.3e-3 of max on 2.5% of the pixels; float32 against
    float64 in torch alone, 1.4e-7)."""
    model, params, tm = _vgg_pair()
    rng = np.random.RandomState(4)
    x = rng.rand(2, H, W).astype(np.float32)
    y = rng.rand(2, H, W).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda a, b: jvgg.vgg_loss_map(model, params, a, b).sum(),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    loss_map = vgg.vgg_loss_map(tm, xt, yt)
    assert loss_map.shape == (2, H, W)
    np.testing.assert_allclose(float(loss_map.detach().sum()), float(want),
                               rtol=1e-5)
    want_map = jvgg.vgg_loss_map(model, params, jnp.asarray(x),
                                 jnp.asarray(y))
    assert_rel(loss_map.detach().numpy(), want_map, 1e-5)
    loss_map.sum().backward()
    assert_rel(xt.grad.numpy(), jgrad[0], 3e-3, "d/dx")
    assert yt.grad is None and float(np.abs(jgrad[1]).max()) == 0.0

    x3 = np.repeat(x[..., None], 3, -1)
    fx, vjp = jax.vjp(lambda a: model.apply(params, a), jnp.asarray(x3))
    cts = [rng.randn(*f.shape).astype(np.float32) for f in fx]
    want_g = vjp([jnp.asarray(c) for c in cts])[0]
    xt3 = _nchw(x3).requires_grad_()
    outs = vgg.Vgg19Features.forward(tm, xt3)
    assert [f.shape[1] for f in outs] == [64, 128, 256, 512]
    for o, f in zip(outs, fx):
        assert_rel(_nhwc(o), f, 1e-5, "features")
    sum((o * _nchw(c)).sum() for o, c in zip(outs, cts)).backward()
    assert_rel(_nhwc(xt3.grad), want_g, 1e-5, "trunk vjp")


def test_vgg_loaders(tmp_path):
    """A torchvision VGG19 state dict (features.N, as .pth and as the .npz
    of `convert_vgg`) and the Flax-layout .npz of the JAX package's
    `pretrain.save_vgg_npz` load into the same trunk. (The JAX package's
    own `load_torch_vgg19_npz` leaves out conv4_1, features.19.)"""
    model, params, tm = _vgg_pair(seed=3)
    sd = {}
    for name, idx in zip(vgg.conv_names(), vgg.TORCHVISION_CONV_IDX):
        sd[f"features.{idx}.weight"] = tm.convs[name].weight.clone()
        sd[f"features.{idx}.bias"] = tm.convs[name].bias.clone()
    sd["classifier.0.weight"] = torch.zeros(2, 2)
    torch.save({f"module.{k}": v for k, v in sd.items()},
               tmp_path / "vgg.pth")
    np.savez(tmp_path / "vgg_tv.npz", **{k: v.numpy() for k, v in sd.items()
                                         if k.startswith("features.")})
    jpretrain.save_vgg_npz(str(tmp_path / "vgg_flax.npz"), params)
    x = np.random.RandomState(0).rand(1, H, W).astype(np.float32)
    want = jvgg.vgg_loss_map(model, params, jnp.asarray(x),
                             jnp.asarray(x * 0.9))
    for name in ("vgg.pth", "vgg_tv.npz", "vgg_flax.npz"):
        loaded = vgg.load_vgg19(str(tmp_path / name))
        assert not any(p.requires_grad for p in loaded.parameters())
        got = vgg.vgg_loss_map(loaded, torch.from_numpy(x),
                               torch.from_numpy(x * 0.9))
        assert_rel(got.numpy(), want, 1e-5, name)
    jtree = jvgg.load_torch_vgg19_npz(str(tmp_path / "vgg_tv.npz"))
    assert "s3_c3" not in jtree["params"] and len(jtree["params"]) == 8


def _darknet_pair(seed=0):
    """The Flax Darknet-53 with its BatchNorm statistics moved off their
    init, and the port's with the same weights."""
    model, v = jdk.init_darknet(jax.random.PRNGKey(seed), H, W)
    v = _np(v)
    v["batch_stats"] = moved_stats(v["batch_stats"], seed)
    tm = darknet.DarknetBackbone()
    tm.load_state_dict(convert.darknet_from_flax(v, tm))
    return model, v, darknet.freeze(tm)


def test_darknet_features_and_loss_match_jax():
    """The six feature maps (width-only SAME downsample), feature_loss and
    its gradient with respect to the sim range and the mask."""
    model, v, tm = _darknet_pair()
    rng = np.random.RandomState(5)
    x = rng.randn(2, H, W, 4).astype(np.float32)
    want = model.apply(v, jnp.asarray(x))
    tm.train()  # BatchNorm stays on its running statistics
    got = tm(_nchw(x))
    assert [g.shape[3] for g in got] == [64, 32, 16, 8, 4, 2]
    for g, w_ in zip(got, want):
        assert_rel(_nhwc(g), w_, 1e-5, "darknet feature")
    sim = rng.rand(2, H, W).astype(np.float32)
    gt = rng.rand(2, H, W).astype(np.float32)
    mask = (rng.rand(2, H, W) > 0.3).astype(np.float32)
    jl, jg = jax.value_and_grad(
        lambda s, m: jdk.feature_loss(model, v, s, jnp.asarray(gt), m),
        argnums=(0, 1))(jnp.asarray(sim), jnp.asarray(mask))
    st = torch.from_numpy(sim).requires_grad_()
    mt = torch.from_numpy(mask).requires_grad_()
    loss = darknet.feature_loss(tm, st, torch.from_numpy(gt), mt)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    loss.backward()
    assert_rel(st.grad.numpy(), jg[0], 1e-4, "d/dsim")
    assert_rel(mt.grad.numpy(), jg[1], 1e-4, "d/dmask")


def test_darknet_odd_width_pads_as_xla():
    """On an odd width XLA's SAME pads the width (1, 1); `_same_pad` too."""
    model, v, tm = _darknet_pair(seed=1)
    x = np.random.RandomState(6).randn(1, 5, 37, 4).astype(np.float32)
    want = model.apply(v, jnp.asarray(x))
    for g, w_ in zip(tm(_nchw(x)), want):
        assert_rel(_nhwc(g), w_, 1e-5)


def test_rangenet_loader_matches_jax(tmp_path):
    """A rangenet `backbone` state dict (module. prefixes,
    num_batches_tracked) loads as it is; the JAX package's
    `load_torch_darknet_npz` reads the same .npz into the same network."""
    tm = darknet.init_darknet(torch.Generator().manual_seed(2))
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5)
                m.running_mean.uniform_(-0.2, 0.2)
    sd = {f"module.{k}": v for k, v in tm.state_dict().items()}
    torch.save(sd, tmp_path / "backbone.pth")
    np.savez(tmp_path / "backbone.npz", **{
        k: v.numpy() for k, v in tm.state_dict().items()
        if not k.endswith("num_batches_tracked")})
    model = jdk.DarknetBackbone()
    jv = _np(jdk.load_torch_darknet_npz(str(tmp_path / "backbone.npz")))
    x = np.random.RandomState(7).randn(1, H, W, 4).astype(np.float32)
    want = model.apply(jv, jnp.asarray(x))
    for name in ("backbone.pth", "backbone.npz"):
        loaded = darknet.load_rangenet(str(tmp_path / name))
        for g, w_ in zip(loaded(_nchw(x)), want):
            assert_rel(_nhwc(g), w_, 1e-5, name)
    back = convert.flatten_params(convert.darknet_to_flax(loaded))
    for k, a in convert.flatten_params(jv).items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


def test_pretrain_decoder_matches_jax():
    """The pretraining decoder on a VGG pyramid, with the same weights."""
    model, params, tm = _vgg_pair()
    x = np.random.RandomState(8).rand(2, H, W, 3).astype(np.float32)
    feats = model.apply(params, jnp.asarray(x))
    dec = jpretrain._Decoder()
    dv = _np(dec.init(jax.random.PRNGKey(0), feats, H, W))["params"]
    want = dec.apply({"params": dv}, feats, H, W)
    td = pretrain._Decoder()
    with torch.no_grad():
        for i, lat in enumerate(td.lat):
            lat.weight.copy_(torch.from_numpy(
                dv[f"lat{i}"]["kernel"].transpose(3, 2, 0, 1).copy()))
            lat.bias.copy_(torch.from_numpy(dv[f"lat{i}"]["bias"]))
        for name in ("mix", "out"):
            conv = getattr(td, name)
            conv.weight.copy_(torch.from_numpy(
                dv[name]["kernel"].transpose(3, 2, 0, 1).copy()))
            conv.bias.copy_(torch.from_numpy(dv[name]["bias"]))
    got = td(tm(_nchw(x)), H, W)
    assert got.shape == (2, H, W)
    assert_rel(got.detach().numpy(), want, 1e-5)
