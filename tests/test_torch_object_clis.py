"""The port's object-scene entries against the JAX package's: `render_video`
(the scene-edit frames), `render_instance` (one object's orbit) and the
transplant of object MLPs (`save_obj_mlp_params`, `restore_obj_mlp_params`,
`train --obj_ckpt`), on a small synth_nusc scene with one moving car and a
`tiny_debug` field with objects. The field is the port's seeded init with
every hash table uniform(-0.5, 0.5), saved as a JAX `checkpoint_1.ckpt` by
the port's msgpack writer; the JAX entries read it from exp/j/, the port's
from `--params`. Plain versions on the CPU, TF32 off.

Tolerances: the float frames at chip_smoke.py [5]'s (depth and the
distance statistics rtol 1e-3, the rest atol 1e-4; measured: distances
2.6e-5 relative); the PNG panels within one level of 255; the
object MLP files byte for byte, their leaves exactly.
"""

import glob
import json
import os
import shutil
import sys
import types

import flax.serialization
import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import cli as jcli
from nerf_lidar_tpu import configs as jconfigs
from nerf_lidar_tpu import renderer as jrenderer
from nerf_lidar_tpu.models import objects as jobjects
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.train import checkpoints as jcheckpoints
from nerf_lidar_tpu_torch import cli, convert
from nerf_lidar_tpu_torch.data import synth_nusc
from nerf_lidar_tpu_torch.models.model import Model
from nerf_lidar_tpu_torch.train import checkpoints
from nerf_lidar_tpu_torch.utils import msgpack

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
SCENE_ARGS = ["--config", "tiny_debug", "--data_dir", "scene",
              "--set", "dataset_loader=nusc", "--set", "sensor_num=1",
              "--set", "model.instance_obj=true",
              "--set", "model.latent_size=8",
              "--set", "model.obj_mlp.class_num=5",
              "--set", "model.obj_mlp.grid.desired_resolution=16",
              "--set", "model.obj_mlp.grid.log2_hashmap_size=8"]
CKPT = os.path.join("exp", "j", "checkpoint_1.ckpt")
PORT = [*SCENE_ARGS, "--device", "cpu", "--exp_name", "p",
        "--params", CKPT]
JAX = [*SCENE_ARGS, "--exp_name", "j"]
# chip_smoke.py [5]'s tolerances: (rtol, atol) per output.
TOL = dict(depth=(1e-3, 1e-5))
DEFAULT_TOL = (0.0, 1e-4)


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    """A directory holding the scene and exp/j/checkpoint_1.ckpt; yields the
    Flax param tree written there."""
    root = tmp_path_factory.mktemp("object_clis")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        synth_nusc.write_scene_dir("scene", num_frames=4, sensor_num=1,
                                   height=24, width=40,
                                   lidar_points_per_beam=32)
        cfg = cli.build_config(cli.parse_args(["render_video", *PORT]))
        scene = cli.load_scene_for(cfg, "train")
        cfg = cli._with_objects(cfg, scene.tracks, scene.track_classes)
        model = Model(cfg.model)
        model.init_weights(torch.Generator().manual_seed(3))
        g = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("table"):
                    p.copy_(torch.rand(p.shape, generator=g) - 0.5)
        tree = convert.state_dict_to_flax(model.state_dict())
        os.makedirs("exp/j")
        msgpack.write_file(CKPT, {"params": tree, "step": 1})
        yield types.SimpleNamespace(root=root, tree=tree, cfg=cfg)
    finally:
        os.chdir(cwd)


def _jax_model(port_cfg):
    jcfg = jconfigs.Config.from_dict(json.loads(port_cfg.to_json()))
    return JaxModel(jcfg.model), jcfg


def _np(t):
    return None if t is None else t.cpu().numpy()


def _close(got, want, what):
    for k in want:
        rtol, atol = TOL["depth"] if k.startswith("distance") else TOL.get(
            k, DEFAULT_TOL)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


def _same_pngs(got_dir, want_dir, n):
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir)) and len(names) == n
    for name in names:
        a = imageio.imread(os.path.join(got_dir, name)).astype(int)
        b = imageio.imread(os.path.join(want_dir, name)).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name


@pytest.mark.parametrize("mode", ["replay", "laneshift", "removal",
                                  "rotate"])
def test_render_video_equals_jax(field, mode):
    """One frame per scene edit: the port's frame against JAX's render of
    the same rays, tracks and weights, and the four panels of both CLIs."""
    args = ["--mode", mode, "--num_frames", "1"]
    jcli.main(["render_video", *JAX, *args])
    run = cli.main(["render_video", *PORT, *args])
    assert run.render_dir == os.path.join("exp", "p", f"video_{mode}")
    assert run.cfg.model.instance_obj == (mode != "removal")
    assert len(run.frames) == 1 and "distance_median" in run.frames[0]
    _same_pngs(run.render_dir, f"exp/j/video_{mode}", 4)
    model, jcfg = _jax_model(run.cfg)
    params = jcli._pad_obj_latents(
        jcheckpoints.restore_model_params("exp/j")[0],
        run.cfg.model.num_objects) if run.cfg.model.instance_obj \
        else jcheckpoints.restore_model_params("exp/j")[0]
    scene = cli.load_scene_for(run.cfg, "train")
    want = jrenderer.render_view(
        jrenderer.ChunkRenderer(model, jcfg, jcfg.render_chunk_size,
                                compute_extras=True),
        params, jcli._view_rays(scene.data, 0),
        None if run.tracks is None else jnp.asarray(_np(run.tracks)),
        None if run.track_mask is None else jnp.asarray(
            _np(run.track_mask)))
    assert set(run.frames[0]) == set(want)
    _close(run.frames[0], want, mode)


def test_render_video_hq_and_refusals(field, monkeypatch):
    """--hq renders 256 + 64 proposal and 64 NeRF samples (two proposal
    levels, as the nuScenes presets have; a seeded init here); --video on
    a machine without imageio (it joins the frames through imageio,
    tests/test_torch_loaders.py) and a missing checkpoint are refused."""
    run = cli.main(["render_video", *SCENE_ARGS, "--device", "cpu",
                    "--exp_name", "hq", "--allow_fresh",
                    "--set", "model.num_prop_samples=(8,8)",
                    "--set", "model.prop_desired_grid_size=(32,64)",
                    "--mode", "laneshift", "--num_frames", "1", "--hq"])
    assert run.cfg.model.num_prop_samples == (256, 64)
    assert run.cfg.model.num_nerf_samples == 64
    assert np.isfinite(run.frames[0]["depth"]).all()
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "imageio", None)
        m.setitem(sys.modules, "imageio.v2", None)
        with pytest.raises(SystemExit, match="needs imageio"):
            cli.main(["render_video", *PORT, "--video"])
    with pytest.raises(SystemExit, match="no checkpoint in exp/none"):
        cli.main(["render_video", *SCENE_ARGS, "--device", "cpu",
                  "--exp_name", "none"])


def test_render_instance_equals_jax(field):
    """Three 12 x 12 views of the car's field: the port's frames against
    the JAX `render_instance` of the same weights, and the views' PNGs of
    both CLIs."""
    args = ["--track_id", "0", "--size", "12", "--num_views", "3"]
    jcli.main(["render_instance", *JAX, *args])
    run = cli.main(["render_instance", *PORT, *args])
    assert run.out == os.path.join("exp", "p", "instance_0")
    _same_pngs(run.out, "exp/j/instance_0", 3)
    model, _ = _jax_model(run.cfg)
    want = jobjects.render_instance(
        model, jcheckpoints.restore_model_params("exp/j")[0], 0, height=12,
        width=12, num_views=3)
    assert run.frames.shape == (3, 12, 12, 3)
    assert float(np.ptp(run.frames)) > 1e-3
    np.testing.assert_allclose(run.frames, want, rtol=0, atol=1e-4)


def test_obj_mlp_files_equal_jax(field, tmp_path):
    """The port writes an object MLP's subtree in the bytes of the JAX
    `save_obj_mlp_params` (Flax `to_bytes`), restores a JAX-written one
    exactly, and raises KeyError for a subtree the model lacks, as JAX
    does."""
    cfg = field.cfg
    model = Model(cfg.model)
    model.load_state_dict(convert.flax_to_state_dict(field.tree, cfg.model))
    path = checkpoints.save_obj_mlp_params(model, "obj_mlp",
                                           str(tmp_path / "port.ckpt"))
    jpath = jcheckpoints.save_obj_mlp_params(
        jax.tree_util.tree_map(jnp.asarray, field.tree), "obj_mlp",
        str(tmp_path / "jax.ckpt"))
    assert open(path, "rb").read() == open(jpath, "rb").read()
    # A JAX-written subtree of other values into a model that differs there.
    rng = np.random.RandomState(5)
    other = jax.tree_util.tree_map(
        lambda v: rng.uniform(-1, 1, np.shape(v)).astype(np.float32),
        field.tree)
    jcheckpoints.save_obj_mlp_params(other, "obj_mlp", jpath)
    checkpoints.restore_obj_mlp_params(model, "obj_mlp", jpath)
    got = convert.flatten_params(convert.state_dict_to_flax(
        model.state_dict()))
    for k, v in convert.flatten_params(other).items():
        want = v if "/obj_mlp/" in k else convert.flatten_params(
            field.tree)[k]
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    with pytest.raises(KeyError, match="obj_mlp_cls2"):
        checkpoints.restore_obj_mlp_params(model, "obj_mlp_cls2", jpath)
    with pytest.raises(KeyError, match="obj_mlp_cls2"):
        jcheckpoints.restore_obj_mlp_params(field.tree, "obj_mlp_cls2",
                                            jpath)
    # The flax reader takes the port's file into the JAX tree as well.
    sub = flax.serialization.from_bytes(field.tree["params"]["obj_mlp"],
                                        open(path, "rb").read())
    np.testing.assert_array_equal(sub["table"],
                                  field.tree["params"]["obj_mlp"]["table"])


def test_train_obj_ckpt_transplants_the_subtree(field, monkeypatch):
    """`train --obj_ckpt obj_mlp=<file>` starts its first step (step 0)
    with the file's subtree and the seeded init elsewhere, as the JAX
    entry's transplant does; an unknown name raises KeyError."""
    from nerf_lidar_tpu_torch.train import train_step
    rng = np.random.RandomState(6)
    sub = jax.tree_util.tree_map(
        lambda v: rng.uniform(-1, 1, np.shape(v)).astype(np.float32),
        field.tree["params"]["obj_mlp"])
    with open("car.ckpt", "wb") as f:
        f.write(flax.serialization.to_bytes(sub))
    seen = []
    orig = train_step.train_step

    def first(model, *a, **kw):
        if not seen:
            seen.append(convert.flatten_params(convert.state_dict_to_flax(
                {k: v.clone() for k, v in model.state_dict().items()})))
        return orig(model, *a, **kw)

    monkeypatch.setattr(train_step, "train_step", first)
    train = ["train", *SCENE_ARGS, "--device", "cpu", "--steps", "1"]
    run = cli.main([*train, "--exp_name", "t", "--obj_ckpt",
                    "obj_mlp=car.ckpt"])
    assert run.init_step == 0 and len(seen) == 1
    fresh = Model(run.cfg.model)
    fresh.init_weights(torch.Generator().manual_seed(run.cfg.seed))
    fresh = convert.flatten_params(convert.state_dict_to_flax(
        fresh.state_dict()))
    want = convert.flatten_params({"params": {"obj_mlp": sub}})
    for k, v in seen[0].items():
        np.testing.assert_array_equal(v, want.get(k, fresh[k]), err_msg=k)
    assert any(k.startswith("params/obj_mlp/") for k in seen[0])
    with pytest.raises(KeyError, match="no obj MLP subtree 'obj_mlp_cls9'"):
        cli.main([*train, "--exp_name", "t2", "--obj_ckpt",
                  "obj_mlp_cls9=car.ckpt"])
    shutil.rmtree("exp/t2", ignore_errors=True)
    assert glob.glob("exp/t/params_1.npz")
