"""The port's llff / blender / colmap, tat_nerfpp / tat_fvs / dtu loaders
and `validate_scene` against the JAX package's, on captures the tests
write (`data/synth_llff.py`, and the Tanks and Temples / DTU layouts of
`tests/test_tat_dtu.py`): the scenes each `load_scene_for` returns are
equal, array for array and exactly (the port keeps numpy copies of the
loaders; only its PNG decoder differs from imageio, and it keeps the
pixels)."""

import argparse
import dataclasses
import os
import sys
import types

import numpy as np
import pytest

from nerf_lidar_tpu import cli as jcli
from nerf_lidar_tpu import configs as jconfigs
from nerf_lidar_tpu.data import llff as jllff
from nerf_lidar_tpu.data import synth_nusc
from nerf_lidar_tpu.data import validate as jvalidate
from nerf_lidar_tpu_torch import cli, configs
from nerf_lidar_tpu_torch.data import camera as camlib
from nerf_lidar_tpu_torch.data import png, synth_llff


def assert_same(got, want, where="scene"):
    """Exact equality through namespaces, dicts, sequences and arrays."""
    if dataclasses.is_dataclass(want) or isinstance(
            want, types.SimpleNamespace):
        assert type(got).__name__ == type(want).__name__, where
        got, want = vars(got), vars(want)
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def _both(loader, data_dir, split, **kw):
    """(port scene, JAX scene) of `load_scene_for` at tiny_debug."""
    out = []
    for mod, cl in ((configs, cli), (jconfigs, jcli)):
        cfg = dataclasses.replace(mod.tiny_debug(), dataset_loader=loader,
                                  data_dir=data_dir, **kw)
        out.append(cl.load_scene_for(cfg, split))
    return out


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    root = tmp_path_factory.mktemp("captures")
    small = dict(num_views=8, height=18, width=24)
    return {kind: synth_llff.write_capture(str(root / kind), **small, **kw)
            for kind, kw in (("bin", {}), ("txt", dict(text_model=True)),
                             ("transforms", dict(transforms=True)),
                             ("raw", dict(raw=True)))}


@pytest.mark.parametrize("kind,kw", [
    ("bin", {}), ("txt", {}), ("transforms", {}),
    ("bin", dict(forward_facing=True)), ("raw", dict(rawnerf_mode=True)),
    ("bin", dict(factor=2))])
@pytest.mark.parametrize("split", ["train", "test"])
def test_llff_equals_jax(captures, kind, kw, split):
    loader = "blender" if kind == "transforms" else "llff"
    got, want = _both(loader, captures[kind], split, llffhold=4, **kw)
    assert_same(got, want)
    assert got.data.images.shape[0] == (6 if split == "train" else 2)
    if kind == "raw":
        assert set(got.data.exposure_values) <= {0.5, 1.0}
    if kw.get("forward_facing"):
        assert got.data.pixtocam_ndc is not None


def test_llff_shards_train_views_by_host(captures, monkeypatch):
    """Under a torchrun launch the train views are split over the hosts
    (GROUP_RANK of WORLD_SIZE / LOCAL_WORLD_SIZE), as the JAX loader
    splits them over processes: on one host every rank loads them all."""
    root = captures["bin"]
    cfg = dataclasses.replace(configs.tiny_debug(), dataset_loader="llff",
                              data_dir=root, llffhold=4)
    for env, index, count in ((dict(WORLD_SIZE="4", LOCAL_WORLD_SIZE="2",
                                    GROUP_RANK="1"), 1, 2),
                              (dict(WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                                    GROUP_RANK="0"), 0, 1)):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        want = jllff.load_scene(root, split="train", llffhold=4,
                                process_index=index, process_count=count)
        got = cli.load_scene_for(cfg, "train")
        assert_same(got, want)
        assert got.data.num_views == (3 if count == 2 else 6)
        # The test split is never sharded.
        assert cli.load_scene_for(cfg, "test").data.num_views == 2


def test_non_png_capture_without_imageio_names_it(tmp_path, monkeypatch):
    """A .jpg capture on a machine without imageio stops with a message
    that names imageio (the port reads PNG itself)."""
    root = synth_llff.write_capture(str(tmp_path / "c"), num_views=4,
                                    height=8, width=8)
    img_dir = os.path.join(root, "images")
    for name in os.listdir(img_dir):
        os.rename(os.path.join(img_dir, name),
                  os.path.join(img_dir, name[:-4] + ".jpg"))
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    cfg = dataclasses.replace(configs.tiny_debug(), dataset_loader="llff",
                              data_dir=root)
    with pytest.raises(ImportError, match="needs imageio"):
        cli.load_scene_for(cfg, "train")


def _ring_poses(n, radius=4.0):
    return np.stack([camlib.lookat_pose(
        np.array([radius * np.cos(2 * np.pi * i / n),
                  radius * np.sin(2 * np.pi * i / n), 1.0]), np.zeros(3))
        for i in range(n)])


def _write_png(path, seed, h=6, w=8):
    png.write_png(path, np.random.RandomState(seed).randint(
        0, 255, (h, w, 3)).astype(np.uint8))


def _tat_nerfpp(root):
    poses = _ring_poses(5)
    intrin = np.eye(4)
    intrin[0, 0] = intrin[1, 1] = 100.0
    intrin[0, 2], intrin[1, 2] = 4.0, 3.0
    for sp, n in (("train", 3), ("test", 2)):
        for d in ("rgb", "pose", "intrinsics"):
            os.makedirs(os.path.join(root, sp, d))
        for i in range(n):
            _write_png(os.path.join(root, sp, "rgb", f"{i:05d}.png"), i)
            np.savetxt(os.path.join(root, sp, "pose", f"{i:05d}.txt"),
                       camlib.pad_poses(poses[i][None])[0]
                       @ np.diag([1.0, -1.0, -1.0, 1.0]))
            np.savetxt(os.path.join(root, sp, "intrinsics", f"{i:05d}.txt"),
                       intrin)
    return root


def _tat_fvs(root):
    n = 10
    base = os.path.join(root, "dense", "ibr3d_pw_0.25")
    os.makedirs(base)
    w2c = np.linalg.inv(camlib.pad_poses(_ring_poses(n) @ np.diag(
        [1.0, -1.0, -1.0, 1.0])))
    np.save(os.path.join(base, "Rs.npy"), w2c[:, :3, :3])
    np.save(os.path.join(base, "ts.npy"), w2c[:, :3, 3])
    np.save(os.path.join(base, "Ks.npy"), np.tile(
        camlib.intrinsic_matrix(80.0, 80.0, 4.0, 3.0), (n, 1, 1)))
    for i in range(n):
        _write_png(os.path.join(base, f"im_{i:05d}.png"), i)
    return root


def _dtu(root):
    scan = os.path.join(root, "scans", "scan1")
    cal = os.path.join(root, "cal18")
    os.makedirs(scan)
    os.makedirs(cal)
    k = np.array([[90.0, 0.0, 4.0], [0.0, 90.0, 3.0], [0.0, 0.0, 1.0]])
    poses = _ring_poses(4)
    for i in range(1, 5):
        for light in [f"{j}_r5000" for j in range(7)] + ["max"]:
            _write_png(os.path.join(scan, f"rect_{i:03d}_{light}.png"), i)
        w2c = np.linalg.inv(camlib.pad_poses(
            poses[i - 1][None] @ np.diag([1.0, -1.0, -1.0, 1.0])))[0]
        np.savetxt(os.path.join(cal, f"pos_{i:03d}.txt"), k @ w2c[:3])
    return scan


@pytest.mark.parametrize("loader,write,kw", [
    ("tat_nerfpp", _tat_nerfpp, {}),
    ("tat_fvs", _tat_fvs, dict(llffhold=5, factor=0)),
    ("dtu", _dtu, dict(dtuhold=2))])
def test_tat_and_dtu_equal_jax(tmp_path, loader, write, kw):
    root = write(str(tmp_path))
    for split in ("train", "test"):
        got, want = _both(loader, root, split, **kw)
        assert_same(got, want)
        assert got.data.images.shape[0] > 0


@pytest.fixture(scope="module")
def nusc_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc") / "scene")
    synth_nusc.write_scene_dir(root, num_frames=4, sensor_num=1, height=24,
                               width=40, lidar_points_per_beam=16)
    return root


def _report(rep):
    return [str(i) for i in rep.issues], list(rep.info), rep.ok


def test_validate_scene_equals_jax(nusc_scene, tmp_path, capsys):
    """The CLI's validate_scene on a clean synth_nusc scene (no ERROR,
    code 0) and on one without poses_bounds.npy (code 1): the same issues
    and notes as the JAX validator, printed as the JAX CLI prints them."""
    args = argparse.Namespace(scene_dir=nusc_scene, sensor_num=1, factor=1)
    run = cli.cmd_validate_scene(args)
    assert run.code == 0 and run.report.ok
    assert _report(run.report) == _report(jvalidate.validate_scene(
        nusc_scene, sensor_num=1, factor=1))
    port_out = capsys.readouterr().out
    assert jcli.cmd_validate_scene(args) == 0
    assert capsys.readouterr().out == port_out
    assert "OK: 0 errors" in port_out

    broken = tmp_path / "broken"
    os.makedirs(broken)
    for name in os.listdir(nusc_scene):
        if name != "poses_bounds.npy":
            os.symlink(os.path.join(nusc_scene, name), broken / name)
    run = cli.main(["validate_scene", str(broken), "--sensor_num", "1"])
    assert run.code == 1 and not run.report.ok
    assert _report(run.report) == _report(jvalidate.validate_scene(
        str(broken), sensor_num=1, factor=1))


def test_render_video_joins_the_frames(tmp_path, monkeypatch):
    """`render --video` and `render_video --video` join the colour frames
    into color.mp4, or color.gif where imageio has no ffmpeg backend (the
    branch this machine takes without imageio_ffmpeg); without imageio
    they stop before rendering, with a message that names it."""
    import importlib.util
    monkeypatch.chdir(tmp_path)
    ext = ".mp4" if importlib.util.find_spec("imageio_ffmpeg") else ".gif"
    base = ["--config", "tiny_debug", "--set", "dataset_loader=synthetic",
            "--device", "cpu", "--exp_name", "v", "--allow_fresh", "--video",
            "--fps", "5"]
    run = cli.main(["render", *base, "--num_frames", "2"])
    assert run.video.endswith("color" + ext) and os.path.getsize(run.video)
    if ext == ".gif":
        import imageio.v2 as imageio
        frames = imageio.mimread(run.video)
        assert len(frames) == 2 and frames[0].shape[:2] == \
            run.frames[0]["rgb"].shape[:2]
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    for cmd in (["render", *base], ["render_video", *base]):
        with pytest.raises(SystemExit, match="needs imageio"):
            cli.main(cmd)


def test_raw_view_rays_carry_the_exposure_to_the_model(captures,
                                                       monkeypatch):
    """`cli._view_rays` of a RawNeRF view carries its exposure_values /
    exposure_idx as the JAX CLI's does, and the chunked renderer hands
    them to the model padded (the last ray repeated) with their dtypes:
    exposure_idx stays int32."""
    import torch
    from nerf_lidar_tpu_torch.models import model as model_lib
    from nerf_lidar_tpu_torch.renderer import ChunkRenderer, render_view
    got, want = _both("llff", captures["raw"], "test", llffhold=4,
                      rawnerf_mode=True)
    cfg = dataclasses.replace(configs.tiny_debug(), dataset_loader="llff",
                              data_dir=captures["raw"], llffhold=4,
                              rawnerf_mode=True)
    for i in range(got.data.num_views):
        assert_same(cli._view_rays(got.data, i),
                    jcli._view_rays(want.data, i), f"view {i}")
    rays = cli._view_rays(got.data, 1)
    model = model_lib.Model(dataclasses.replace(
        cfg.model, learned_exposure_scaling=True))
    model.init_weights(torch.Generator().manual_seed(0))
    seen = []
    forward = model_lib.Model.forward

    def record(self, batch, *a, **kw):
        seen.append({k: (v.dtype, v[-1].clone()) for k, v in batch.items()})
        return forward(self, batch, *a, **kw)

    monkeypatch.setattr(model_lib.Model, "forward", record)
    out = render_view(ChunkRenderer(model, cfg, chunk_size=100), rays)
    assert out["rgb"].shape == rays["origins"].shape
    assert len(seen) == -(-rays["origins"][..., 0].size // 100)
    assert seen[0]["exposure_idx"][0] == torch.int32
    assert seen[0]["exposure_values"][0] == torch.float32
    last = seen[-1]
    assert int(last["exposure_idx"][1]) == int(rays["exposure_idx"][-1, -1])
    assert float(last["exposure_values"][1][0]) == float(
        rays["exposure_values"][-1, -1, 0])
