"""The port's product path through its CLI on the CPU, the counterpart of
tests/test_pipeline_e2e.py::test_full_pipeline_cli: train (tiny_debug, with
the scene's moving car) -> render_lidar --mode replay -> raydrop_features
-> raydrop_train -> raydrop_drop --place_car -> SemanticKITTI export and
sensor metadata, then raydrop_val_vis and points_vis on what it wrote.

Sizes: the JAX test's scene and train steps. The sweeps have 400 azimuth
steps (the JAX test: 64): a 12-step field still puts most returns near its
far plane (~45 m), and the depth filter keeps a point only when a ring
neighbour lies within 1 m, 2 pi r / 400 < 1 m at that range (the JAX
field's random semantic edges, which the filter also keeps, carry its
export at 64). `raydrop_train` runs 10 epochs, so that one eval runs and
the BatchNorm statistics the drop uses have moved off their init.
"""

import json
import os

import numpy as np
import pytest
import torch

from nerf_lidar_tpu_torch import cli
from nerf_lidar_tpu_torch.data import synth_nusc
from nerf_lidar_tpu_torch.lidar import export


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this module runs: the tier runs several
    test files at once, and convolutions at the U-Net's widths on every
    core of each worker oversubscribe the machine (measured 10x slower)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipe_scene"))
    synth_nusc.write_scene_dir(root, num_frames=4, sensor_num=2,
                               height=48, width=64,
                               lidar_points_per_beam=96)
    return root


TINY_OBJ = [
    "--set", "model.latent_size=8",
    "--set", "model.obj_mlp.class_num=5",  # match tiny_debug's nerf head
    "--set", "model.obj_mlp.grid.desired_resolution=16",
    "--set", "model.obj_mlp.grid.log2_hashmap_size=8",
]


def test_full_pipeline_cli(scene_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # exp/ lands in the test's tmp_path
    common = ["--config", "tiny_debug", "--data_dir", scene_root,
              "--exp_name", "pipe", "--device", "cpu",
              "--set", "dataset_loader=nusc", "--set", "sensor_num=2",
              "--set", "model.instance_obj=true", *TINY_OBJ]
    run = cli.main(["train", *common, "--steps", "12",
                    "--set", "batch_size=128", "--set", "max_steps=12",
                    "--set", "checkpoint_every=12", "--set", "patch_size=1",
                    "--set", "lidar_supervision=true"])
    assert run.cfg.model.num_objects == 1
    assert os.path.exists("exp/pipe/params_12.npz")

    cli.main(["render_lidar", *common, "--mode", "replay",
              "--num_sweeps", "2", "--azimuth_steps", "400",
              "--params", "exp/pipe/params_12.npz"])
    sweep_dir = "exp/pipe/lidar_replay"
    pts = np.load(os.path.join(sweep_dir, "points_0000.npy"))
    assert pts.shape == (32 * 400, 3)
    l2g = np.load(os.path.join(sweep_dir, "lidar2globals.npy"))
    assert l2g.shape[0] >= 2

    feats = cli.main(["raydrop_features", "--pair",
                      f"{scene_root}:{sweep_dir}",
                      "--out", "exp/pipe/feats.npy", "--width", "128"])
    assert feats["images"].shape == (2, 32, 128, 6)
    assert feats["masks"].shape == (2, 32, 128)
    assert 0 < feats["masks"].mean() <= 1.0
    on_disk = np.load("exp/pipe/feats.npy", allow_pickle=True).item()
    np.testing.assert_array_equal(on_disk["images"], feats["images"])

    rd = cli.main(["raydrop_train", "--features", "exp/pipe/feats.npy",
                   "--exp_name", "pipe_rd", "--epochs", "10",
                   "--batch_size", "1", "--no_vgg", "--device", "cpu"])
    assert rd.history[-1]["ce"] < rd.history[0]["ce"]
    assert "val_ce" in rd.history[10]
    ckpts = sorted(f for f in os.listdir("exp/pipe_rd") if f.endswith(".pt"))
    assert ckpts and os.path.exists(
        os.path.join("exp/pipe_rd", ckpts[-1][:-3] + ".npz"))
    metrics = json.load(open("exp/pipe_rd/metrics.json"))
    assert metrics["split"] == "val" and metrics["n_frames"] == 1

    drop = cli.main(["raydrop_drop", "--ckpt",
                     os.path.join("exp/pipe_rd", ckpts[-1]),
                     "--simulation_path", sweep_dir, "--out",
                     "exp/pipe/kitti", "--width", "128", "--place_car",
                     "--features", "exp/pipe/feats.npy", "--device", "cpu"])
    b = export.read_bin("exp/pipe/kitti/velodyne/000000.bin")
    lab = export.read_label("exp/pipe/kitti/labels/000000.label")
    assert b.shape[0] == lab.shape[0] > 0
    # Sensor metadata persisted (lidar2egos = I, ego2globals = the poses).
    assert np.load("exp/pipe/kitti/ego2globals.npy").shape[0] == 2
    assert np.load("exp/pipe/kitti/lidar2egos.npy").shape == (2, 4, 4)
    # Exported points are sensor-frame: the synthetic sensor sits ~1.3 m
    # above ground, so ground returns must be negative-z in sensor frame.
    assert b[:, 2].min() < -0.5
    summary = json.load(open("exp/pipe/kitti/summary.json"))
    assert summary == drop.summary and summary["sweeps"] == 2
    assert {"iou", "precision", "recall"} <= set(summary)

    vis = cli.main(["raydrop_val_vis", "--features", "exp/pipe/feats.npy",
                    "--ckpt", os.path.join("exp/pipe_rd", ckpts[-1]),
                    "--out", "exp/pipe/vis", "--device", "cpu"])
    (frame,) = vis["frames"]
    for kind in ("raw", "gt", "pred", "real"):
        assert os.path.exists(f"exp/pipe/vis/{kind}_{frame:04d}.obj")
    written = cli.main(["points_vis", "--points",
                        "exp/pipe/kitti/velodyne/000000.bin", "--out",
                        "exp/pipe/pv", "--drop_sky"])
    assert written == [("exp/pipe/pv/000000.obj", b.shape[0])]
