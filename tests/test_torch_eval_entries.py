"""The port's `eval`, `lidar_eval` and `render` entries and its in-train
test render, on a field that the JAX package trained (2 steps of
`tiny_debug` with a moving car and its tracknet, on a small synth_nusc
scene with per-point LiDAR labels) and saved as its msgpack
`checkpoint_2.ckpt`, which the port reads with its own decoder.

Tolerances: the restored field rendered by both packages (float32, TF32
off) rtol 1e-5 / atol 1e-6, depth rtol 1e-4 (the model tolerance of
tests/test_torch_model.py); the entries' metrics rtol 1e-4 (PSNR, SSIM,
psnr_cc, depth errors, Chamfer; render times are not compared), mIoU and
the per-class IoUs exactly, the `--max_rays` subset exactly; the render
entry's frames at the model tolerance of tests/test_torch_model.py (depth
rtol 1e-4, the rest atol 1e-5, with compute_extras' distance statistics).
"""

import dataclasses
import glob
import json
import os
import shutil
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import cli as jcli
from nerf_lidar_tpu import configs as jconfigs
from nerf_lidar_tpu import renderer as jrenderer
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.train import checkpoints as jcheckpoints
from nerf_lidar_tpu.utils import image as jimage
from nerf_lidar_tpu_torch import cli, convert
from nerf_lidar_tpu_torch.data import synth_nusc
from nerf_lidar_tpu_torch.renderer import render_view

SCENE_ARGS = ["--config", "tiny_debug", "--data_dir", "scene",
              "--set", "dataset_loader=nusc", "--set", "sensor_num=1",
              "--set", "model.instance_obj=true",
              "--set", "model.latent_size=8",
              "--set", "model.obj_mlp.class_num=5",
              "--set", "model.obj_mlp.grid.desired_resolution=16",
              "--set", "model.obj_mlp.grid.log2_hashmap_size=8",
              "--set", "track_refine=true", "--set", "track_start_opt=0"]
PORT = [*SCENE_ARGS, "--device", "cpu", "--exp_name", "p"]
JAX = [*SCENE_ARGS, "--exp_name", "j"]


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


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    """A directory holding the scene, exp/j/ (the JAX run: its
    checkpoint_2.ckpt, which holds {"model", "tracknet"} params, and its
    config.json) and exp/p/ holding a copy of that checkpoint for the
    port's entries."""
    root = tmp_path_factory.mktemp("eval_entries")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        synth_nusc.write_scene_dir("scene", num_frames=4, sensor_num=1,
                                   height=24, width=40,
                                   lidar_points_per_beam=32)
        rng = np.random.RandomState(0)
        for path in sorted(glob.glob("scene/lidar_points/*.bin")):
            n = np.fromfile(path, np.float32).reshape(-1, 5).shape[0]
            rng.randint(0, 5, n).astype(np.uint32).tofile(
                path[:-4] + ".label")
        jcli.main(["train", *JAX, "--steps", "2"])
        os.makedirs("exp/p")
        shutil.copy("exp/j/checkpoint_2.ckpt", "exp/p/checkpoint_2.ckpt")
        yield types.SimpleNamespace(root=root)
    finally:
        os.chdir(cwd)


def _jax_model(port_cfg):
    """The JAX model of the port's resolved config (objects included)."""
    jcfg = jconfigs.Config.from_dict(json.loads(port_cfg.to_json()))
    return JaxModel(jcfg.model), jcfg


# The JAX renderers the tests compare with, one per model config and
# options: a renderer's jitted chunk program is traced and compiled once
# and then serves every test that renders with the same field.
_RENDERERS = {}


def _jax_renderer(port_cfg, **options):
    """The JAX ChunkRenderer of the port's resolved config (its model and
    chunk size, the only parts of the config its program reads off a TPU)
    with `options` (fused, compute_extras), built once for this module."""
    model, jcfg = _jax_model(port_cfg)
    key = (json.dumps(json.loads(port_cfg.to_json())["model"],
                      sort_keys=True), jcfg.render_chunk_size,
           tuple(sorted(options.items())))
    if key not in _RENDERERS:
        _RENDERERS[key] = jrenderer.ChunkRenderer(
            model, jcfg, jcfg.render_chunk_size, **options)
    return _RENDERERS[key]


def _np(t):
    return None if t is None else t.cpu().numpy()


def test_jax_checkpoint_renders_the_same_in_the_port(field):
    """The port's eval restores exp/p/checkpoint_2.ckpt (a JAX train state
    with the tracknet beside the model); a test view of the car's scene
    rendered by the port and by JAX from that checkpoint agree at rtol 1e-5
    / atol 1e-6, depth at rtol 1e-4 (measured: 1.5e-5 on 1% of the
    values, where the resampled sample positions carry the two packages'
    last-bit differences)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = cli.main(["eval", *PORT, "--max_views", "1"])
    assert run.steps == [2] and run.cfg.model.num_objects == 1
    params, step = jcheckpoints.restore_model_params("exp/j")
    assert step == 2 and "obj_latents" in params["params"]
    rays = cli._view_rays(run.data, 0)
    np.testing.assert_array_equal(rays["origins"],
                                  jcli._view_rays(run.data, 0)["origins"])
    want = jrenderer.render_view(
        _jax_renderer(run.cfg, fused=False), params, rays,
        jnp.asarray(_np(run.tracks)), jnp.asarray(_np(run.track_mask)))
    got = render_view(run.renderer, rays, run.tracks, run.track_mask)
    assert set(got) == set(want) and "obj_mask" in got
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                   rtol=1e-4 if k == "depth" else 1e-5,
                                   atol=1e-6, err_msg=k)


def test_eval_entry_equals_jax(field):
    """`eval` of both packages on the same checkpoint: the same metric keys
    and files, values at rtol 1e-4."""
    jcli.main(["eval", *JAX])
    run = cli.main(["eval", *PORT])
    for name in ("metrics.json", "metrics_2.json"):
        want = json.load(open(os.path.join("exp/j/eval", name)))
        got = json.load(open(os.path.join("exp/p/eval", name)))
        assert set(got) == set(want) == {
            "psnr", "ssim", "psnr_cc", "ssim_cc", "median_render_time_s",
            "step"}
        assert got["step"] == want["step"] == 2
        for k in ("psnr", "ssim", "psnr_cc", "ssim_cc"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)
    assert run.metrics == json.load(open("exp/p/eval/metrics.json"))
    assert sorted(os.listdir("exp/p/eval")) == sorted(
        os.listdir("exp/j/eval"))
    for name in os.listdir("exp/j/eval"):
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(f"exp/p/eval/{name}"),
                                       np.load(f"exp/j/eval/{name}"),
                                       atol=1e-5, err_msg=name)
    times = open("exp/p/eval/render_times_2.txt").read().split()
    assert len(times) == len(run.steps) * run.data.num_views


@pytest.mark.parametrize("max_rays", [0, 97])
def test_lidar_eval_entry_equals_jax(field, max_rays):
    """`lidar_eval` of both packages: the same rays (all, or the same
    RandomState(0) subset), depth errors and Chamfer at rtol 1e-4, the
    per-point classes, mIoU and per-class IoUs exactly."""
    args = ["--max_rays", str(max_rays)]
    jcli.main(["lidar_eval", *JAX, *args])
    run = cli.main(["lidar_eval", *PORT, *args])
    want = json.load(open("exp/j/lidar_eval/metrics.json"))
    got = json.load(open("exp/p/lidar_eval/metrics.json"))
    assert got == run.metrics and set(got) == set(want)
    assert "miou" in got and got["num_rays"] == want["num_rays"]
    assert got["num_rays"] == (max_rays or got["num_rays"])
    for k in want:
        if k.startswith(("depth", "chamfer")):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)
        else:
            assert got[k] == want[k], k
    np.testing.assert_array_equal(np.load("exp/p/lidar_eval/gt_depth.npy"),
                                  np.load("exp/j/lidar_eval/gt_depth.npy"))
    np.testing.assert_array_equal(
        np.load("exp/p/lidar_eval/pred_semantic.npy"),
        np.load("exp/j/lidar_eval/pred_semantic.npy"))
    np.testing.assert_allclose(np.load("exp/p/lidar_eval/pred_depth.npy"),
                               np.load("exp/j/lidar_eval/pred_depth.npy"),
                               rtol=1e-4)
    assert open("exp/p/lidar_eval/iou.txt").read() == \
        open("exp/j/lidar_eval/iou.txt").read()


@pytest.mark.parametrize("path", ["test", "ellipse"])
def test_render_entry_panels_and_frames(field, path):
    """`render --path test` (the scene's one test view) and `--path
    ellipse --num_frames 2` write the same panel files as the JAX entry,
    their frames (compute_extras: acc and the distance statistics) equal
    JAX's render of the same rays at the model tolerance, and the colour
    panels lie within one level of 255."""
    import imageio.v2 as imageio
    from nerf_lidar_tpu.data import camera as jcamera
    args = ["--path", path, "--num_frames", "2" if path == "ellipse"
            else "0"]
    jcli.main(["render", *JAX, *args])
    run = cli.main(["render", *PORT, *args])
    scene = cli.load_scene_for(run.cfg, "test")
    n = 2 if path == "ellipse" else scene.data.num_views
    assert len(run.frames) == n
    names = sorted(os.listdir(f"exp/j/render_{path}"))
    assert names == sorted(os.listdir(run.render_dir))
    assert len(names) == 4 * n
    for i in range(n):
        a = imageio.imread(f"exp/p/render_{path}/color_{i:03d}.png")
        b = imageio.imread(f"exp/j/render_{path}/color_{i:03d}.png")
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    params, _ = jcheckpoints.restore_model_params("exp/j")
    rend = _jax_renderer(run.cfg, compute_extras=True)
    poses = (jcamera.generate_ellipse_path(scene.data.camtoworlds,
                                           n_frames=2)
             if path == "ellipse" else scene.data.camtoworlds)
    for i, frame in enumerate(run.frames):
        want = jrenderer.render_view(
            rend, params, cli._view_rays(scene.data, i, poses[i]),
            jnp.asarray(scene.tracks), jnp.asarray(scene.track_mask))
        assert set(frame) == set(want) and "distance_median" in frame
        for k in want:
            if k == "depth" or k.startswith("distance"):
                np.testing.assert_allclose(frame[k], want[k], rtol=1e-4,
                                           atol=1e-6, err_msg=k)
            else:
                np.testing.assert_allclose(frame[k], want[k], atol=1e-5,
                                           err_msg=k)


def test_entries_refuse(field, monkeypatch):
    # --video joins the frames through imageio (tests/test_torch_loaders.py
    # runs it): what refuses is a machine without imageio, before rendering.
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "imageio", None)
        m.setitem(sys.modules, "imageio.v2", None)
        with pytest.raises(SystemExit, match="needs imageio"):
            cli.main(["render", *PORT, "--video"])
    with pytest.raises(SystemExit, match="no checkpoint in exp/none"):
        cli.main(["eval", *PORT, "--exp_name", "none"])
    with pytest.raises(SystemExit, match="no such file"):
        cli.main(["lidar_eval", *PORT, "--params", "exp/p/missing.ckpt"])
    for flag in (["--params", "exp/p/checkpoint_2.ckpt"], ["--allow_fresh"]):
        with pytest.raises(SystemExit, match="drop --params"):
            cli.main(["eval", *PORT, "--follow", *flag])
    if not torch.cuda.is_available():
        for entry in ("eval", "lidar_eval", "render"):
            with pytest.raises(SystemExit, match="no CUDA device"):
                cli.main([entry, *SCENE_ARGS, "--exp_name", "p",
                          "--device", "cuda"])


def test_eval_follow_skips_a_pruned_checkpoint(field, monkeypatch):
    """A checkpoint pruned between detection and restore scores nothing:
    no metrics of a fresh init are written."""
    from nerf_lidar_tpu_torch.train import checkpoints
    monkeypatch.setattr(checkpoints, "restore_model_params",
                        lambda directory: (None, 0))
    run = cli.main(["eval", *PORT, "--follow",
                    "--poll_every", "0.01", "--follow_timeout", "0.05"])
    assert run.steps == [] and run.metrics is None
    assert not os.path.exists("exp/p/eval/metrics_0.json")


def test_train_test_view_rule():
    """The in-train render's view: the first test-split view, through the
    loader's "loaded" ids, else the last loaded view."""
    def scene(n, splits):
        return types.SimpleNamespace(
            data=types.SimpleNamespace(num_views=n), splits=splits)
    assert cli.train_test_view(scene(5, None)) == 4
    assert cli.train_test_view(scene(5, {"test": np.array([])})) == 4
    assert cli.train_test_view(scene(5, {"test": np.array([2, 7])})) == 2
    assert cli.train_test_view(scene(
        3, {"test": np.array([8]), "loaded": np.array([4, 8, 12])})) == 1
    assert cli.train_test_view(scene(
        3, {"test": np.array([0]), "loaded": np.array([4, 8, 12])})) == 2


def test_in_train_render_view_and_psnr(field):
    """`train` with train_render_every=2 renders the JAX rule's view at
    step 2 through the plain compositor: train_renders/rgb_000002.png, and
    test_psnr (also in metrics.jsonl beside render_s and the train scalars)
    equal at rtol 1e-5 to the JAX render of the same weights."""
    run = cli.main(["train", *SCENE_ARGS, "--device", "cpu", "--exp_name",
                    "t", "--steps", "2", "--set", "train_render_every=2",
                    "--set", "print_every=1"])
    scene = cli.load_scene_for(run.cfg, "train")
    assert scene.splits["test"][0] in scene.splits["loaded"]
    want_view = int(np.nonzero(np.asarray(scene.splits["loaded"])
                               == scene.splits["test"][0])[0][0])
    assert run.test_view == want_view
    assert os.path.exists("exp/t/train_renders/rgb_000002.png")
    recs = [json.loads(x) for x in open("exp/t/metrics.jsonl")]
    assert [r["test_psnr"] for r in recs if "test_psnr" in r] == \
        run.test_psnr and len(run.test_psnr) == 1
    assert any("render_s" in r for r in recs)
    assert [r["step"] for r in recs if "loss" in r] == [1, 2]
    assert {"psnr", "rays_per_sec", "data"} <= set(recs[-1])
    img = jrenderer.render_view(
        _jax_renderer(run.cfg, fused=False),
        convert.load_npz_params(run.params),
        jcli._view_rays(scene.data, want_view),
        jnp.asarray(_np(run.tracks)), jnp.asarray(_np(run.track_mask)))
    want = float(jimage.psnr(jnp.asarray(img["rgb"]),
                             jnp.asarray(scene.data.images[want_view])))
    np.testing.assert_allclose(run.test_psnr[0], want, rtol=1e-5)


def test_restore_takes_params_or_the_newest(field):
    """--params takes a .ckpt or a .npz; without it the newest weights of
    exp/<name>/, the port's params_<step>.npz on a tie with a JAX
    checkpoint_<step>.ckpt."""
    cfg = cli.build_config(cli.parse_args(["eval", *PORT]))
    params, step = cli._restore_model_params(cfg)
    assert step == 2
    tree = jcheckpoints.restore_model_params("exp/j")[0]
    np.testing.assert_array_equal(params["params"]["nerf_mlp"]["table"],
                                  np.asarray(tree["params"]["nerf_mlp"]
                                             ["table"]))
    os.makedirs("exp/tie", exist_ok=True)
    shutil.copy("exp/j/checkpoint_2.ckpt", "exp/tie/checkpoint_2.ckpt")
    marked = jax_tree_plus_one(tree)
    convert.save_npz_params("exp/tie/params_2.npz", marked)
    tie = dataclasses.replace(cfg, exp_name="tie")
    params, step = cli._restore_model_params(tie)
    np.testing.assert_array_equal(params["params"]["nerf_mlp"]["table"],
                                  marked["params"]["nerf_mlp"]["table"])
    params, step = cli._restore_model_params(
        tie, "exp/tie/checkpoint_2.ckpt")
    np.testing.assert_array_equal(params["params"]["nerf_mlp"]["table"],
                                  np.asarray(tree["params"]["nerf_mlp"]
                                             ["table"]))


def jax_tree_plus_one(tree):
    return {k: jax_tree_plus_one(v) if isinstance(v, dict)
            else np.asarray(v) + 1 for k, v in tree.items()}
