"""The port's evaluation functions against the JAX package on the same
inputs (numpy seeds) and the same weights, at `configs.tiny_debug()` sizes.

Tolerances: PSNR, SSIM and the sRGB curves rtol 1e-5 (float32 on both
sides; sums in another order); `color_correct` exactly (both are the same
float64 numpy); Chamfer rtol 1e-6 (float32 squared distances, the port sums
the means in float64); mIoU exactly; `weighted_percentile` and the
`compute_extras` statistics of `volumetric_rendering` rtol 1e-5 / atol 1e-6
on the same weights; whole-model renders (`compute_extras`, `render_view`)
at the model tolerance of tests/test_torch_model.py (depth-like outputs
rtol 1e-4, the rest atol 1e-5: the resampling chain compounds last-bit
differences); visualisation panels within 1/255.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu import renderer as jrenderer
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.ops import render as jrender
from nerf_lidar_tpu.ops import stepfun as jstepfun
from nerf_lidar_tpu.utils import image as jimage
from nerf_lidar_tpu.utils import pc_metrics as jpc
from nerf_lidar_tpu.utils import vis as jvis
from nerf_lidar_tpu_torch import cli, convert
from nerf_lidar_tpu_torch import configs as tconfigs
from nerf_lidar_tpu_torch import renderer
from nerf_lidar_tpu_torch.models.model import Model
from nerf_lidar_tpu_torch.ops import render, stepfun
from nerf_lidar_tpu_torch.utils import image, pc_metrics, vis
from nerf_lidar_tpu_torch.utils.logging import MetricsLogger, Timer


def _images(seed, h=33, w=47):
    rng = np.random.RandomState(seed)
    a = rng.rand(h, w, 3).astype(np.float32)
    b = np.clip(a + 0.08 * rng.randn(h, w, 3), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_ssim_equal_jax(seed):
    a, b = _images(seed)
    np.testing.assert_allclose(float(image.psnr(a, b)),
                               float(jimage.psnr(jnp.asarray(a),
                                                 jnp.asarray(b))),
                               rtol=1e-5)
    np.testing.assert_allclose(float(image.ssim(a, b)),
                               float(jimage.ssim(a, b)), rtol=1e-5)
    got = image.MetricHarness()(torch.from_numpy(a), torch.from_numpy(b),
                                "_x")
    want = jimage.MetricHarness()(jnp.asarray(a), jnp.asarray(b), "_x")
    assert set(got) == set(want) == {"psnr_x", "ssim_x"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(
        float(image.mse_to_psnr(torch.tensor(3e-3))),
        float(jimage.mse_to_psnr(jnp.float32(3e-3))), rtol=1e-6)


def test_srgb_curves_equal_jax():
    x = np.random.RandomState(2).uniform(-0.01, 1.2, 4000).astype(np.float32)
    x[:3] = [0.0031308, 0.04045, 0.0]
    for port_fn, jax_fn in ((image.linear_to_srgb, jimage.linear_to_srgb),
                            (image.srgb_to_linear, jimage.srgb_to_linear)):
        np.testing.assert_allclose(port_fn(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax_fn(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-7)


def test_color_correct_and_downsample_equal_jax():
    a, b = _images(3)
    b = np.clip(b * 0.8 + 0.1, 0, 1).astype(np.float32)
    want = jimage.color_correct(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(image.color_correct(a, b), want)
    np.testing.assert_array_equal(
        image.color_correct(torch.from_numpy(a), torch.from_numpy(b)), want)
    np.testing.assert_array_equal(image.downsample_area(a, 4),
                                  jimage.downsample_area(a, 4))


@pytest.mark.parametrize("n,m,block", [(300, 410, 64), (517, 93, 1000),
                                       (1, 5, 1)])
def test_chamfer_equals_jax(n, m, block):
    """Blocks smaller than N (a ragged last block) and larger; coordinates
    at 50-100 m with nearest neighbours centimetres away."""
    rng = np.random.RandomState(n)
    a = rng.uniform(50, 100, (n, 3)).astype(np.float32)
    b = (a[rng.randint(0, n, m)] + 0.03 * rng.randn(m, 3)).astype(np.float32)
    want = jpc.chamfer_distance(a, b)
    got = pc_metrics.chamfer_distance(a, b, block=block)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    d = np.sqrt(((a[:, None].astype(np.float64) - b[None]) ** 2).sum(-1))
    np.testing.assert_allclose(got["chamfer_a_to_b"], d.min(1).mean(),
                               rtol=1e-5)
    assert pc_metrics.block_rows(10 ** 6) * 8 * 10 ** 6 <= \
        pc_metrics.BLOCK_BUDGET_BYTES


def test_eval_miou_equals_jax():
    rng = np.random.RandomState(7)
    pred = rng.randint(0, 6, 3000)
    gt = rng.randint(0, 7, 3000)
    gt[gt == 6] = 255
    gt[gt == 4] = 3  # class 4 absent from gt
    names = [f"c{i}" for i in range(6)]
    for kw in ({}, {"class_names": names}):
        assert pc_metrics.eval_miou(pred, gt, 6, **kw) == \
            jpc.eval_miou(pred, gt, 6, **kw)
    cm = pc_metrics.confusion_matrix(pred, gt, 6)
    np.testing.assert_array_equal(cm, jpc.confusion_matrix(pred, gt, 6))
    iou, miou = pc_metrics.iou_from_confusion(cm)
    jiou, jmiou = jpc.iou_from_confusion(cm)
    np.testing.assert_array_equal(iou, jiou)
    assert miou == jmiou


def _step_fn(seed, rays=40, s=12):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.uniform(0.2, 8.0, (rays, s + 1)), -1).astype(np.float32)
    w = rng.exponential(1.0, (rays, s)).astype(np.float32)
    w[:4] = 0.0
    w[4:8, 3] = 50.0  # a peaked ray
    return t, w


def test_weighted_percentile_equals_jax():
    t, w = _step_fn(8)
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-12)
    for ps in ([5, 50, 95], [0, 100], [37.5]):
        np.testing.assert_allclose(
            stepfun.weighted_percentile(torch.from_numpy(t),
                                        torch.from_numpy(w), ps).numpy(),
            np.asarray(jstepfun.weighted_percentile(jnp.asarray(t),
                                                    jnp.asarray(w), ps)),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("extras", [False, True])
def test_volumetric_rendering_extras_equal_jax(extras):
    t, w = _step_fn(9)
    rng = np.random.RandomState(9)
    density = w * 2.0
    dirs = rng.randn(t.shape[0], 3).astype(np.float32)
    rgbs = rng.rand(t.shape[0], t.shape[1] - 1, 3).astype(np.float32)
    far = np.full((t.shape[0], 1), 9.0, np.float32)
    jw, _, _ = jrender.compute_alpha_weights(jnp.asarray(density),
                                             jnp.asarray(t),
                                             jnp.asarray(dirs))
    want = jrender.volumetric_rendering(jnp.asarray(rgbs), jw, jnp.asarray(t),
                                        1.0, jnp.asarray(far), extras)
    got = render.volumetric_rendering(
        torch.from_numpy(rgbs), torch.from_numpy(np.array(jw)),
        torch.from_numpy(t), 1.0, t_far=torch.from_numpy(far),
        compute_extras=extras)
    assert set(got) == set(want)
    if extras:
        assert {"acc", "distance_mean", "distance_median",
                "distance_percentile_5", "distance_percentile_95"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


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
    """JAX tiny_debug params (numpy) with informative tables, and the
    port's model holding the same weights."""
    jcfg, cfg = configs.tiny_debug(), tconfigs.tiny_debug()
    probe = {k: jnp.asarray(v) for k, v in _rays(8, 0).items()}
    params = jax.jit(JaxModel(jcfg.model).init)(jax.random.PRNGKey(0), None,
                                                probe)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(1)
    for sub in params["params"].values():
        sub["table"] = rng.uniform(-1, 1, sub["table"].shape).astype(
            np.float32)
    model = Model(cfg.model)
    model.load_state_dict(convert.flax_to_state_dict(params, cfg.model))
    return jcfg, cfg, params, model


def _close_render(got, want, where):
    assert set(got) == set(want), where
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (where, k)
        if k == "depth" or k.startswith("distance"):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{where} {k}")
        else:
            np.testing.assert_allclose(g, w, atol=1e-5,
                                       err_msg=f"{where} {k}")


def test_model_compute_extras_equals_jax(tiny):
    """Every level's renderings with `compute_extras` (the fused final
    level is not taken then, in either package)."""
    jcfg, cfg, params, model = tiny
    rays = _rays(64, 3)
    want, _ = jax.jit(lambda p, b: JaxModel(jcfg.model).apply(
        p, None, b, compute_extras=True, fused_final=True))(
            params, {k: jnp.asarray(v) for k, v in rays.items()})
    with torch.no_grad():
        got, _ = model({k: torch.from_numpy(v) for k, v in rays.items()},
                       compute_extras=True, fused_final=True)
    for level, (g, w) in enumerate(zip(got, want)):
        _close_render({k: v.numpy() for k, v in g.items()}, w,
                      f"level {level}")
        assert "distance_median" in g


@pytest.mark.parametrize("extras", [False, True])
def test_render_view_equals_jax(tiny, extras):
    """An [H, W] ray grid through `render_view`: [H, W, ...] images, the
    last chunk padded (H * W = 90 rays, chunk 32)."""
    jcfg, cfg, params, model = tiny
    flat = _rays(90, 4)
    grid = {k: v.reshape((9, 10) + v.shape[1:]) for k, v in flat.items()}
    want = jrenderer.render_view(
        jrenderer.ChunkRenderer(JaxModel(jcfg.model), jcfg, 32,
                                compute_extras=extras), params, grid)
    rend = renderer.ChunkRenderer(model, cfg, 32, compute_extras=extras)
    assert rend.fused == (not extras)
    got = renderer.render_view(rend, grid)
    assert got["rgb"].shape == (9, 10, 3) and got["depth"].shape == (9, 10)
    _close_render(got, want, f"extras={extras}")


def test_visualize_suite_equals_jax(tmp_path):
    """Panels of a rendering with every output within 1/255 of the JAX
    ones (the turbo table is looked up as matplotlib looks it up), and the
    PNGs that save_panels writes read back as imageio reads the JAX ones."""
    import imageio.v2 as imageio
    rng = np.random.RandomState(10)
    h, w = 12, 17
    rendering = dict(
        rgb=rng.uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32),
        depth=rng.uniform(0.3, 40.0, (h, w)).astype(np.float32),
        acc=rng.rand(h, w).astype(np.float32),
        semantic=rng.rand(h, w, 19).astype(np.float32),
        normals=rng.uniform(-1, 1, (h, w, 3)).astype(np.float32))
    for near, far in ((None, None), (0.2, 50.0)):
        want = jvis.visualize_suite(rendering, near=near, far=far)
        got = vis.visualize_suite(rendering, near=near, far=far)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1 / 255,
                                       err_msg=k)
    x = np.linspace(0, 1, 2049)
    np.testing.assert_array_equal(vis._turbo(x), jvis._turbo(x))
    np.testing.assert_array_equal(vis.def_color_map(7),
                                  jvis.def_color_map(7))
    vis.save_panels(got, str(tmp_path / "port"), 3)
    jvis.save_panels(want, str(tmp_path / "jax"), 3)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        a = imageio.imread(tmp_path / "port" / name).astype(int)
        b = imageio.imread(tmp_path / "jax" / name).astype(int)
        assert np.abs(a - b).max() <= 1, name


# -------------------------------------------- follow_checkpoints (eval)
def _touch(d, step, kind="ckpt"):
    name = f"checkpoint_{step}.ckpt" if kind == "ckpt" else \
        f"params_{step}.npz"
    with open(os.path.join(d, name), "wb") as f:
        f.write(b"x")


@pytest.mark.parametrize("kind", ["ckpt", "npz"])
def test_follow_checkpoints_evaluates_each_new_ckpt(tmp_path, kind):
    """The JAX daemon's case (tests/test_cli.py), with the JAX package's
    checkpoint_<step>.ckpt and with the port's params_<step>.npz."""
    d = str(tmp_path)
    seen = []

    def writer():
        for step in (10, 20, 30):
            _touch(d, step, kind)
            time.sleep(0.5)

    t = threading.Thread(target=writer)
    t.start()
    cli.follow_checkpoints(d, seen.append, poll_every=0.05, timeout=5.0,
                           stop_step=30)
    t.join()
    assert seen == [10, 20, 30]


def test_follow_checkpoints_times_out_when_idle(tmp_path):
    d = str(tmp_path)
    _touch(d, 5)
    seen = []
    t0 = time.time()
    cli.follow_checkpoints(d, seen.append, poll_every=0.05, timeout=0.2,
                           stop_step=100)
    assert seen == [5]
    assert time.time() - t0 < 3.0


def test_follow_checkpoints_trusts_returned_step(tmp_path):
    """If eval_fn restores a NEWER checkpoint than detected (the trainer
    saved and pruned between detection and restore), that newer checkpoint
    is not evaluated a second time."""
    d = str(tmp_path)
    _touch(d, 10)
    calls = []

    def eval_fn(detected):
        calls.append(detected)
        if len(calls) == 1:
            os.remove(os.path.join(d, "checkpoint_10.ckpt"))
            _touch(d, 20)
            return 20
        return detected

    cli.follow_checkpoints(d, eval_fn, poll_every=0.05, timeout=1.0,
                           stop_step=20)
    assert calls == [10], calls


def test_metrics_logger_and_timer(tmp_path, capsys):
    """metrics.jsonl gets one record per call (values as floats where they
    convert); --tensorboard without tensorboardX says so and goes on."""
    import json
    lg = MetricsLogger(str(tmp_path), tensorboard=True)
    if lg.tb is None:
        assert "tensorboard logging disabled" in capsys.readouterr().out
    lg.log(1, loss=torch.tensor(0.5), psnr=np.float32(20.0), note="s")
    lg.log(2, loss=0.4)
    recs = [json.loads(x) for x in
            open(tmp_path / "metrics.jsonl").read().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert recs[0]["loss"] == 0.5 and recs[0]["note"] == "s"
    timer = Timer()
    timer.tick(100)
    dt, rate = timer.mark()
    assert dt > 0 and rate == pytest.approx(100 / dt)
