"""The port's copies of the JAX package's host-side code, held equal to the
originals, and the port's isolation from the JAX package.

The port keeps its own `configs`, `lidar/{sensor,transforms}`, `data/*`
and the config/scene helpers of `cli.py`; each copy must give exactly what
the original gives on the same inputs (numpy in, numpy out), except where
the JAX loader decodes LiDAR natively (`LIDAR_ULP`).
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
from nerf_lidar_tpu.lidar import sensor as jsensor
from nerf_lidar_tpu.lidar import transforms as jtransforms
from nerf_lidar_tpu_torch import cli, configs
from nerf_lidar_tpu_torch.data import batching, nuscenes, synthetic
from nerf_lidar_tpu_torch.lidar import sensor, transforms

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
bad = sorted(m for m in sys.modules if m.split('.')[0] in {barred})
assert not bad, bad
print('MODULES', len(names))
"""


def test_port_runs_without_the_jax_package(tmp_path):
    """Every module of the port imported, two tiny_debug train steps and a
    render on the CPU: no jax, flax, optax or nerf_lidar_tpu module is
    loaded."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED.format(barred=BARRED)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split("MODULES")[-1]) >= 30
    assert (tmp_path / "exp" / "iso" / "lidar_simu").is_dir()


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
                "data/synthetic.py", "data/nuscenes.py"):
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
