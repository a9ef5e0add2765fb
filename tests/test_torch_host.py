"""The port's copies of the JAX package's host-side code, held equal to the
originals, and the port's isolation from the JAX package.

The port keeps its own `configs`, `lidar/{sensor,transforms}`, `data/*`
and the config/scene helpers of `cli.py`; each copy must give exactly what
the original gives on the same inputs (numpy in, numpy out), except where
the JAX loader decodes LiDAR natively (`LIDAR_ULP`).
The ray-drop host code (`lidar/{range_image,export}`, `raydrop/features`)
is held to the JAX package's numpy branch, which the port always takes:
the JAX package switches to its native library where it loads, and the
tests turn that off (`no_native`).
The isolation tests show that importing and running the port loads no
module of jax, flax, optax or `nerf_lidar_tpu`.
"""

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest

from nerf_lidar_tpu import cli as jcli
from nerf_lidar_tpu import configs as jconfigs
from nerf_lidar_tpu.data import batching as jbatching
from nerf_lidar_tpu.data import nuscenes as jnuscenes
from nerf_lidar_tpu.data import synth_nusc
from nerf_lidar_tpu.data import synthetic as jsynthetic
from nerf_lidar_tpu import native as jnative
from nerf_lidar_tpu.lidar import export as jexport
from nerf_lidar_tpu.lidar import range_image as jri
from nerf_lidar_tpu.lidar import sensor as jsensor
from nerf_lidar_tpu.lidar import transforms as jtransforms
from nerf_lidar_tpu.raydrop import features as jfeatures
from nerf_lidar_tpu_torch import cli, configs
from nerf_lidar_tpu_torch.data import batching, nuscenes, synthetic
from nerf_lidar_tpu_torch.data import png
from nerf_lidar_tpu_torch.data import synth_nusc as port_synth_nusc
from nerf_lidar_tpu_torch.lidar import export, range_image, sensor, transforms
from nerf_lidar_tpu_torch.raydrop import features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "nerf_lidar_tpu_torch")
BARRED = ("jax", "jaxlib", "flax", "optax", "nerf_lidar_tpu")


def assert_same(got, want, where="value", maxulp=0):
    """Equality through dataclasses, namespaces, dicts, sequences and arrays
    (NaN equal to NaN): exact, or float arrays within `maxulp` units in the
    last place."""
    if dataclasses.is_dataclass(want) or isinstance(
            want, types.SimpleNamespace):
        assert type(got).__name__ == type(want).__name__, where
        got, want = vars(got), vars(want)
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}", maxulp)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]", maxulp)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        if maxulp and want.dtype.kind == "f":
            np.testing.assert_array_max_ulp(got, want, maxulp=maxulp)
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


# -------------------------------------------------------------- configs
def _presets(mod):
    """name -> Config of every preset function and of every `*_variant`
    applied to nuscenes_single."""
    out = {}
    for name in dir(mod):
        fn = getattr(mod, name)
        if name.startswith("_") or not callable(fn) or name[0].isupper():
            continue
        if name.endswith("_variant"):
            out[name] = fn(mod.nuscenes_single())
        elif name.startswith(("nuscenes_", "tiny_")):
            out[name] = fn()
    out["default"] = mod.Config()
    return out


def test_presets_equal_jax():
    want = _presets(jconfigs)
    got = _presets(configs)
    assert set(got) == set(want) and len(want) >= 15
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(
            want[name]), name


@pytest.mark.parametrize("name", ["nuscenes_single", "nuscenes_multi",
                                  "tiny_debug", "default",
                                  "nuscenes_single_speed"])
@pytest.mark.parametrize("overrides", [
    [], ["batch_size=1024", "lr_init=0.005", "aug_road=true"],
    ["model.nerf_mlp.grid.log2_hashmap_size=19",
     "model.num_prop_samples=(32,32)", "dataset_loader=synthetic"]])
def test_build_config_equals_jax(name, overrides):
    args = argparse.Namespace(config=name, set=overrides, data_dir="d",
                              exp_name="e", config_json=None)
    got, want = cli.build_config(args), jcli.build_config(args)
    assert isinstance(got, configs.Config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_build_config_from_json_equals_jax(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(jconfigs.nuscenes_multi_mxu().to_json())
    args = argparse.Namespace(config="tiny_debug", set=["batch_size=64"],
                              data_dir=None, exp_name="r",
                              config_json=str(path))
    got, want = cli.build_config(args), jcli.build_config(args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.batch_size == 64 and cli.exp_dir(got) == jcli.exp_dir(want)


def test_unported_loaders_refuse():
    for loader in ("llff", "blender", "colmap", "tat_nerfpp", "dtu"):
        cfg = dataclasses.replace(configs.tiny_debug(),
                                  dataset_loader=loader, data_dir="x")
        with pytest.raises(SystemExit, match="not ported yet"):
            cli.load_scene_for(cfg)


# ---------------------------------------------------------------- data
def test_synthetic_scene_equals_jax():
    for kw in (dict(), dict(num_views=3, height=16, width=24, seed=2,
                            num_lidar=300)):
        got, want = synthetic.make_scene_data(**kw), \
            jsynthetic.make_scene_data(**kw)
        assert_same(got, want, "make_scene_data")


def test_load_scene_for_synthetic_equals_jax():
    cfg = dataclasses.replace(configs.tiny_debug(),
                              dataset_loader="synthetic")
    jcfg = dataclasses.replace(jconfigs.tiny_debug(),
                               dataset_loader="synthetic")
    assert_same(cli.load_scene_for(cfg), jcli.load_scene_for(jcfg), "scene")


@pytest.mark.parametrize("kw", [
    dict(batch_size=256, patch_size=8, lidar_supervision=True,
         lidar_batch_ratio=4, seed=0),
    dict(batch_size=200, patch_size=4, lidar_supervision=True,
         lidar_batch_ratio=8, aug_road=True, aug_delta=0.2, seed=5,
         only_lidar_depth=True),
    dict(batch_size=64, seed=9, mask_moving=False, apply_bayer_mask=True)])
def test_ray_batcher_equals_jax(kw):
    _, data, _ = synthetic.make_scene_data()
    _, jdata, _ = jsynthetic.make_scene_data()
    a, b = batching.RayBatcher(data, **kw), jbatching.RayBatcher(jdata, **kw)
    assert (a.num_patch_rays, a.total_rays) == (b.num_patch_rays,
                                                b.total_rays)
    for draw in range(3):
        assert_same(a.next(), b.next(), f"batch {draw}")


def _frame(mod):
    """A non-trivial SceneFrame: rotated, shifted and scaled."""
    c, s = np.cos(0.3), np.sin(0.3)
    rigid = np.array([[c, -s, 0, 1.5], [s, c, 0, -0.5], [0, 0, 1, 0.2],
                      [0, 0, 0, 1]])
    return mod.SceneFrame(rigid, 0.25)


def test_simulated_sweeps_equal_jax():
    for complicated in (False, True):
        args = (np.array([0.0, 0.0, 0.6]), np.array([10.0, 2.0, 0.6]),
                np.eye(4))
        kw = dict(num_sweeps=3, complicated=complicated, seed=4,
                  points_per_beam=50, timestamps=np.array([0.1, 0.2]))
        got = sensor.simulated_sweeps(*args, _frame(transforms), **kw)
        want = jsensor.simulated_sweeps(*args, _frame(jtransforms), **kw)
        assert_same(got, want, "simulated_sweeps")
        assert_same(got[0][2].ray_batch(0.1, 9.0),
                    want[0][2].ray_batch(0.1, 9.0), "ray_batch")


def test_replay_sweeps_equal_jax():
    rng = np.random.RandomState(2)
    centers = rng.randn(4, 3)
    l2g = np.tile(np.eye(4), (4, 1, 1))
    l2g[:, :3, 3] = centers
    l2g[:, :2, :2] = [[0.8, -0.6], [0.6, 0.8]]
    kw = dict(points_per_beam=40, timestamps=np.arange(4) * 0.05)
    assert_same(sensor.replay_sweeps(centers, l2g, _frame(transforms), **kw),
                jsensor.replay_sweeps(centers, l2g, _frame(jtransforms),
                                      **kw), "replay_sweeps")


# Without bounding boxes the JAX loader decodes a .bin with its native C
# decoder, whose float32 norm and divide differ from numpy's in the last
# place (measured: LiDAR depths and directions, at most 2 ulp); the port
# always takes the numpy branch. Everything else is equal exactly.
LIDAR_ULP = 2


@pytest.fixture(scope="module")
def nusc_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    synth_nusc.write_scene_dir(root, num_frames=4, sensor_num=2, height=40,
                               width=64, lidar_points_per_beam=64)
    return root


def test_synth_nusc_writer_equals_jax(tmp_path):
    """The port's copy of the synthetic nuScenes writer writes the same
    files as the original (the scene with one moving "vehicle.car" and its
    bboxes.json track): byte for byte, PNGs pixel for pixel as imageio
    reads them (the port encodes them itself)."""
    import imageio.v2 as imageio
    kw = dict(num_frames=3, sensor_num=2, height=24, width=40,
              lidar_points_per_beam=16)
    got = port_synth_nusc.write_scene_dir(str(tmp_path / "port"), **kw)
    want = synth_nusc.write_scene_dir(str(tmp_path / "jax"), **kw)
    files = sorted(os.path.relpath(os.path.join(r, n), want)
                   for r, _, names in os.walk(want) for n in names)
    assert files == sorted(os.path.relpath(os.path.join(r, n), got)
                           for r, _, names in os.walk(got) for n in names)
    assert "bboxes.json" in files and len(files) > 10
    for rel in files:
        a, b = os.path.join(got, rel), os.path.join(want, rel)
        if rel.endswith(".png"):
            pa, pb = imageio.imread(a), imageio.imread(b)
            assert pa.dtype == pb.dtype, rel
            np.testing.assert_array_equal(pa, pb, err_msg=rel)
            continue
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("kind", ["grey8", "rgb8", "rgba8", "grey16",
                                  "grey_alpha8"])
def test_png_codec_matches_imageio(tmp_path, kind):
    """data/png.py reads what imageio writes (its adaptive row filters
    included) and writes what imageio reads, pixel for pixel."""
    import imageio.v2 as imageio
    rng = np.random.RandomState(3)
    shape, dtype = dict(grey8=((17, 23), np.uint8),
                        rgb8=((17, 23, 3), np.uint8),
                        rgba8=((17, 23, 4), np.uint8),
                        grey16=((17, 23), np.uint16),
                        grey_alpha8=((17, 23, 2), np.uint8))[kind]
    # Smooth ramps (which the encoder filters) plus noise.
    ramp = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 3
    img = (ramp.reshape(shape[:2] + (1,) * (len(shape) - 2))
           + rng.randint(0, 40, shape)).astype(dtype)
    if dtype == np.uint16:
        img = img * 251
    path = str(tmp_path / "a.png")
    imageio.imwrite(path, img)
    got = png.read_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    if kind != "grey_alpha8":
        png.write_png(path, img)
        np.testing.assert_array_equal(imageio.imread(path), img)
        np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("split", ["train", "lidar"])
def test_nuscenes_loader_equals_jax(nusc_dir, split):
    """Both loaders read the scene the JAX writer made into equal arrays;
    the port reads LiDAR through the numpy branch of read_lidar_bin."""
    kw = dict(split=split, sensor_num=2, load_lidar=True, load_objects=True)
    assert_same(nuscenes.load_scene(nusc_dir, **kw),
                jnuscenes.load_scene(nusc_dir, **kw), "scene", LIDAR_ULP)


def test_read_lidar_bin_equals_jax(nusc_dir):
    path = os.path.join(nusc_dir, "lidar_points", "000000.bin")
    assert_same(nuscenes.read_lidar_bin(path),
                jnuscenes.read_lidar_bin(path), "read_lidar_bin", LIDAR_ULP)
    # With return_keep the JAX loader takes its numpy branch too: exact.
    assert_same(nuscenes.read_lidar_bin(path, return_keep=True),
                jnuscenes.read_lidar_bin(path, return_keep=True), "keep")


def test_cli_nusc_scene_equals_jax(nusc_dir):
    cfg = dataclasses.replace(configs.tiny_debug(), dataset_loader="nusc",
                              data_dir=nusc_dir, sensor_num=2)
    jcfg = dataclasses.replace(jconfigs.tiny_debug(), dataset_loader="nusc",
                               data_dir=nusc_dir, sensor_num=2)
    assert_same(cli.load_scene_for(cfg, "lidar"),
                jcli.load_scene_for(jcfg, "lidar"), "scene", LIDAR_ULP)


# ---------------------------------------------- ray-drop host code
@pytest.fixture
def no_native(monkeypatch):
    """The JAX package's numpy branches (its native library off)."""
    monkeypatch.setattr(jnative, "available", lambda: False)


def _sweep(seed, w=1100, near=2.0, far=80.0):
    """A sensor-frame sweep on the 32 nuScenes beams: points, labels, rgb."""
    rng = np.random.RandomState(seed)
    d = jsensor.beam_directions(azimuths=jsensor.azimuth_angles(w))
    pts = np.stack([d[:, 1], -d[:, 0], d[:, 2]], -1) * rng.uniform(
        near, far, (len(d), 1))
    sem = rng.randint(0, 19, len(d))
    probs = rng.rand(len(d), 19).astype(np.float32)
    return (pts.astype(np.float32), sem, probs,
            rng.rand(len(d), 3).astype(np.float32))


@pytest.mark.parametrize("h,w", [(32, 1024), (16, 64)])
def test_range_image_equals_jax(h, w):
    """project_points equals the JAX numpy branch exactly (float32 and
    integer labels, with and without semantic / rgb), and so do
    unproject_grid, normalize / denormalize_range and local_variance."""
    pts, sem, _, rgb = _sweep(0)
    for args in ((pts, sem.astype(np.float32), rgb), (pts, sem, None),
                 (pts, None, None)):
        got = range_image.project_points(*args, h=h, w=w)
        want = jri.project_points(*args, h=h, w=w, use_native=False)
        assert_same(got, want, "project_points")
    r = got.range
    assert_same(range_image.unproject_grid(r), jri.unproject_grid(r))
    norm = range_image.normalize_range(r)
    assert_same(norm, jri.normalize_range(r))
    assert_same(range_image.denormalize_range(norm),
                jri.denormalize_range(norm))
    for size in (1, 2):
        assert_same(range_image.local_variance(norm, size),
                    jri.local_variance(norm, size))


def test_range_image_native_branch_differs_on_few_pixels():
    """Where the JAX package loads its native library, its projection puts
    a few points in the neighbouring column (float rounding at a bin edge)
    and so lets another point win a few pixels; the port is the numpy
    branch. Measured on 4 seeded full sweeps (35,200 points, 32 x 1024):
    32 points in another column, 19-25 of 32,768 pixels hold another
    point, the return masks equal."""
    if not jnative.available():
        pytest.skip("the JAX package's native library does not load here")
    for seed in range(4):
        pts, sem, _, rgb = _sweep(seed)
        sem = sem.astype(np.float32)
        got = range_image.project_points(pts, sem, rgb)
        nat = jri.project_points(pts, sem, rgb, use_native=True)
        np.testing.assert_array_equal(got.mask, nat.mask)
        assert (got.proj_x != nat.proj_x).sum() <= 64
        assert (got.idx != nat.idx).sum() <= 50  # 0.15% of the pixels


def test_project_range_image_torch_equals_jax():
    """The scatter-min range image equals JAX's segment_min version."""
    import torch
    pts, *_ = _sweep(1, w=300)
    got, bins = range_image.project_range_image_torch(torch.from_numpy(pts))
    want, jbins = jri.project_range_image_jax(pts)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbins))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isinf(got.numpy()).any() and np.isfinite(got.numpy()).any()


def test_export_writes_the_same_files(tmp_path):
    """write_bin_label / write_sensor_metadata / write_obj write the bytes
    the JAX package writes; the readers give what it reads."""
    pts, sem, _, _ = _sweep(2, w=40)
    inten = np.random.RandomState(0).rand(len(pts)).astype(np.float32)
    l2e, e2g = np.tile(np.eye(4), (3, 1, 1)), np.random.RandomState(1).rand(
        3, 4, 4)
    for mod, root in ((export, tmp_path / "port"), (jexport,
                                                    tmp_path / "jax")):
        mod.write_bin_label(str(root), 0, pts, sem, inten)
        mod.write_bin_label(str(root), 1, pts[:5], None, None)
        mod.write_sensor_metadata(str(root), l2e, e2g)
        mod.write_obj(str(root / "a.obj"), np.c_[pts[:7], sem[:7]])
    files = sorted(str(p.relative_to(tmp_path / "jax"))
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 6
    for rel in files:
        assert ((tmp_path / "port" / rel).read_bytes()
                == (tmp_path / "jax" / rel).read_bytes()), rel
    b = str(tmp_path / "port" / "velodyne" / "000000.bin")
    lab = str(tmp_path / "port" / "labels" / "000000.label")
    assert_same(export.read_bin(b), jexport.read_bin(b))
    assert_same(export.read_label(lab), jexport.read_label(lab))
    np.save(tmp_path / "p.npy", pts.T)
    for path, kw in ((b, {}), (b, dict(n_points=len(pts))), (b, dict(dims=4)),
                     (str(tmp_path / "p.npy"), {})):
        assert_same(export.load_points_any(path, **kw),
                    jexport.load_points_any(path, **kw))


def test_features_equal_jax(no_native):
    """depth_filter_mask (with and without semantics), real and simulated
    sweep features (labels and probabilities, filter on / off) and
    world_points_to_sensor equal the JAX numpy branch exactly."""
    pts, sem, probs, rgb = _sweep(3, near=2.0, far=9.0)
    for kw in (dict(), dict(semantic=sem.astype(np.float32)),
               dict(threshold=2, radius=0.5, width=5)):
        assert_same(features.depth_filter_mask(pts, **kw),
                    jfeatures.depth_filter_mask(pts, **kw))
    assert_same(features.real_sweep_features(pts),
                jfeatures.real_sweep_features(pts))
    for s, kw in ((sem, {}), (probs, dict(semantic_align=False)),
                  (sem, dict(apply_depth_filter=False, h=16, w=64))):
        assert_same(features.simulated_sweep_features(pts, s, rgb, **kw),
                    jfeatures.simulated_sweep_features(pts, s, rgb, **kw))
    l2g = np.eye(4)
    l2g[:3, :3] = [[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1]]
    l2g[:3, 3] = [3.0, -1.0, 1.8]
    assert_same(features.world_points_to_sensor(pts, l2g),
                jfeatures.world_points_to_sensor(pts, l2g))


def _write_sim_dir(root, l2g, n_points, seed=0):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(len(l2g)):
        pts = rng.randn(n_points, 3).astype(np.float32) * 8
        np.save(os.path.join(root, f"points_{i:04d}.npy"),
                pts + l2g[i][:3, 3].astype(np.float32))
        np.save(os.path.join(root, f"points_semantic_{i:04d}.npy"),
                rng.rand(n_points, 5).astype(np.float32))
        np.save(os.path.join(root, f"points_rgb_{i:04d}.npy"),
                rng.rand(n_points, 3).astype(np.float32))
    np.save(os.path.join(root, "lidar2globals.npy"), l2g)


def test_training_set_assembly_equals_jax(nusc_dir, tmp_path, no_native):
    """load_sim_sweep_dir, assemble_training_set (the scene's real .bin
    sweeps, sim sweeps brought into the sensor frame),
    build_training_set and concat_training_sets equal the JAX ones; both
    refuse a directory with stale sweeps past its lidar2globals."""
    l2g = np.load(os.path.join(nusc_dir, "lidar_points", "lidar2global.npy"))
    sim = str(tmp_path / "sim")
    _write_sim_dir(sim, l2g, 32 * 20)
    assert_same(features.load_sim_sweep_dir(sim),
                jfeatures.load_sim_sweep_dir(sim))
    kw = dict(h=16, w=64)
    got = features.assemble_training_set(nusc_dir, sim, **kw)
    want = jfeatures.assemble_training_set(nusc_dir, sim, **kw)
    assert_same(got, want, "training set", LIDAR_ULP)
    assert got["images"].shape == (len(l2g), 16, 64, 6)
    assert_same(features.concat_training_sets([got, got]),
                jfeatures.concat_training_sets([want, want]), "concat",
                LIDAR_ULP)
    np.save(os.path.join(sim, "lidar2globals.npy"), l2g[:2])
    for mod in (features, jfeatures):
        with pytest.raises(ValueError, match="stale"):
            mod.load_sim_sweep_dir(sim)


# ----------------------------------------------------------- isolation
_ISOLATED = """
import importlib, os, pkgutil, sys
import nerf_lidar_tpu_torch as P
names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')]
for name in names:
    importlib.import_module(name)
from nerf_lidar_tpu_torch import cli
base = ['--config', 'tiny_debug', '--set', 'dataset_loader=synthetic',
        '--device', 'cpu', '--exp_name', 'iso']
run = cli.main(['train', *base, '--steps', '2'])
cli.main(['render_lidar', *base, '--num_sweeps', '1', '--azimuth_steps',
          '8', '--params', run.params])
from nerf_lidar_tpu_torch.data import synth_nusc
synth_nusc.write_scene_dir('scene', num_frames=4, sensor_num=1, height=24,
                           width=40, lidar_points_per_beam=32)
objs = ['--config', 'tiny_debug', '--data_dir', 'scene', '--device', 'cpu',
        '--exp_name', 'iso_objects', '--set', 'dataset_loader=nusc',
        '--set', 'sensor_num=1', '--set', 'model.instance_obj=true',
        '--set', 'model.latent_size=8', '--set', 'model.obj_mlp.class_num=5',
        '--set', 'model.obj_mlp.grid.desired_resolution=16',
        '--set', 'model.obj_mlp.grid.log2_hashmap_size=8',
        '--set', 'track_refine=true', '--set', 'track_start_opt=0']
run = cli.main(['train', *objs, '--steps', '2'])
assert run.tracknet is not None and run.cfg.model.num_objects == 1
cli.main(['render_lidar', *objs, '--mode', 'replay', '--num_sweeps', '2',
          '--azimuth_steps', '8', '--params', run.params])
sim = 'exp/iso_objects/lidar_replay'
cli.main(['raydrop_features', '--pair', 'scene:' + sim, '--out', 'f.npy',
          '--width', '64'])
import torch
from nerf_lidar_tpu_torch.raydrop import darknet, vgg
torch.save({{'features.%d.%s' % (i, k): v for n, i in zip(
    vgg.conv_names(), vgg.TORCHVISION_CONV_IDX) for k, v in
    vgg.init_vgg().convs[n].state_dict().items()}}, 'vgg.pth')
torch.save(darknet.init_darknet().state_dict(), 'rangenet.pth')
cli.main(['convert_vgg', '--ckpt', 'vgg.pth', '--out', 'vgg.npz'])
cli.main(['convert_rangenet', '--backbone', 'rangenet.pth', '--out', 'dk.npz'])
rd = cli.main(['raydrop_train', '--features', 'f.npy', '--exp_name', 'rd',
               '--epochs', '0', '--batch_size', '1', '--vgg_npz', 'vgg.npz',
               '--darknet', '--darknet_npz', 'dk.npz', '--device', 'cpu'])
assert set(rd.history[0]) >= {{'ce', 'vgg', 'darknet', 'loss'}}
ckpt = 'exp/rd/raydrop_00001.pt'
cli.main(['raydrop_drop', '--ckpt', ckpt, '--simulation_path', sim, '--out',
          'kitti', '--width', '64', '--place_car', '--features', 'f.npy',
          '--device', 'cpu'])
cli.main(['raydrop_val_vis', '--features', 'f.npy', '--ckpt', ckpt, '--out',
          'vis', '--device', 'cpu'])
cli.main(['points_vis', '--points', 'kitti/velodyne/000000.bin', '--out',
          'pv'])
bad = sorted(m for m in sys.modules if m.split('.')[0] in {barred})
assert not bad, bad
# The port needs no imageio, PIL or torchvision: it writes and reads its
# PNGs itself and writes VGG19 out by hand.
for name in ('imageio', 'PIL', 'torchvision'):
    assert name not in sys.modules, name
print('MODULES', len(names))
"""


def test_port_runs_without_the_jax_package(tmp_path):
    """Every module of the port imported, two tiny_debug train steps and a
    render on the CPU, on the synthetic scene and on a synth_nusc scene with
    its moving car (objects, tracknet, replay render), then the ray-drop
    CLIs on that render (features, the VGG / Darknet converters, training
    with both losses, drop and export, val_vis, points_vis): no jax, flax,
    optax or nerf_lidar_tpu module is loaded, nor imageio, PIL or
    torchvision."""
    # Two intra-op threads: the tier runs other test files beside this one.
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED.format(barred=BARRED)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split("MODULES")[-1]) >= 30
    assert (tmp_path / "exp" / "iso" / "lidar_simu").is_dir()
    assert (tmp_path / "exp" / "iso_objects" / "lidar_replay" /
            "points_0000.npy").is_file()
    assert (tmp_path / "kitti" / "labels" / "000001.label").is_file()
    assert (tmp_path / "vis" / "val_vis.json").is_file()


_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from|import)\s+(nerf_lidar_tpu|jax|jaxlib|flax|optax)(\.|\s|$)",
    re.MULTILINE)


def test_port_sources_name_no_jax_package_import():
    """A static scan of the port's sources and chip_smoke.py for imports of
    nerf_lidar_tpu (not nerf_lidar_tpu_torch), jax, flax or optax."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 30
    for path in files:
        with open(path) as f:
            hits = _JAX_PACKAGE_IMPORT.findall(f.read())
        assert not hits, (path, hits)


def test_copies_name_their_original():
    """Each copied module's first line names the file it copies."""
    for rel in ("configs.py", "lidar/sensor.py", "lidar/transforms.py",
                "data/camera.py", "data/quaternion.py",
                "data/road_augment.py", "data/batching.py",
                "data/synthetic.py", "data/nuscenes.py",
                "data/synth_nusc.py", "lidar/range_image.py",
                "lidar/export.py", "raydrop/features.py"):
        with open(os.path.join(PORT, rel)) as f:
            first = f.readline()
        assert first.startswith(f"# Copy of nerf_lidar_tpu/{rel} "), rel
        assert os.path.exists(os.path.join(REPO, "nerf_lidar_tpu", rel))


def test_config_json_round_trips_into_jax(tmp_path):
    """A config the port writes (train's config.json) rebuilds the same JAX
    Config, so both packages resume from one snapshot."""
    cfg = configs.nuscenes_single()
    assert dataclasses.asdict(jconfigs.Config.from_dict(
        json.loads(cfg.to_json()))) == dataclasses.asdict(cfg)
