"""The train loop's host side (`train/prefetch.py`, `AsyncCheckpointer`)
on the CPU: the ray stream of the port's `train` against the JAX
package's worker batchers, the prefetcher's order, bound, close and
errors, and the asynchronous checkpoints against `save_checkpoint`.

Exactness: batches are compared bit for bit; a checkpoint's tensors are
compared exactly (the same float32 values are copied, never computed)."""

import copy
import dataclasses
import os
import shutil
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import cli as jcli
from nerf_lidar_tpu import configs as jconfigs
from nerf_lidar_tpu.data.batching import RayBatcher as JaxRayBatcher
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.train import checkpoints as jcheckpoints
from nerf_lidar_tpu_torch import cli, configs, convert
from nerf_lidar_tpu_torch.models.model import Model
from nerf_lidar_tpu_torch.train import checkpoints, train_step
from nerf_lidar_tpu_torch.train.prefetch import BatchPrefetcher

BASE = ["--config", "tiny_debug", "--set", "dataset_loader=synthetic",
        "--device", "cpu"]
# A worker's error must reach next() within this, not hang it.
ERROR_S = 5.0


def _record_batches(monkeypatch):
    seen = []
    step_fn = train_step.train_step

    def recording(model, optimizer, config, batch, *args, **kwargs):
        seen.append({k: v.numpy().copy() for k, v in batch.items()})
        return step_fn(model, optimizer, config, batch, *args, **kwargs)

    monkeypatch.setattr(train_step, "train_step", recording)
    return seen


def test_train_draws_the_jax_worker_stream(tmp_path, monkeypatch):
    """The port's `train` takes step k's batch from the JAX loop's worker
    k % 2, a RayBatcher seeded seed + 1000 + w with the loop's arguments
    (`nerf_lidar_tpu/cli.py:259-276`), key by key and exactly."""
    monkeypatch.chdir(tmp_path)
    seen = _record_batches(monkeypatch)
    cli.main(["train", *BASE, "--exp_name", "stream", "--steps", "6"])
    assert len(seen) == 6
    cfg = dataclasses.replace(jconfigs.tiny_debug(),
                              dataset_loader="synthetic")
    data = jcli.load_scene_for(cfg, "train").data
    workers = [JaxRayBatcher(
        data, cfg.batch_size, cfg.patch_size,
        lidar_supervision=cfg.lidar_supervision,
        lidar_batch_ratio=cfg.lidar_batch_ratio,
        only_lidar_depth=cfg.only_lidar_supervision, aug_road=cfg.aug_road,
        aug_delta=cfg.aug_delta, apply_bayer_mask=cfg.apply_bayer_mask,
        seed=cfg.seed + 1000 + w, mask_moving=True) for w in range(2)]
    for k, got in enumerate(seen):
        want = workers[k % 2].next()
        assert set(got) == set(want)
        for key, v in want.items():
            assert got[key].dtype == v.dtype, (k, key)
            np.testing.assert_array_equal(got[key], v, err_msg=f"{k} {key}")


def _counting_source(delays):
    """make_batch(w): worker w's i-th batch {"w": w, "i": i}, after
    delays[w] seconds."""
    counts = [0] * len(delays)

    def make(w):
        time.sleep(delays[w])
        counts[w] += 1
        return {"w": np.array([w]), "i": np.array([counts[w] - 1])}
    return make


@pytest.mark.parametrize("delays", [(0.03, 0.0), (0.0, 0.03)])
def test_order_alternates_whatever_the_timing(delays):
    """next() takes worker 0, 1, 0, 1, ... and each worker's batches in
    order, when either worker is the slow one."""
    pf = BatchPrefetcher(_counting_source(delays), depth=3, num_workers=2)
    try:
        got = [pf.next() for _ in range(8)]
    finally:
        pf.close()
    assert [(int(b["w"][0]), int(b["i"][0])) for b in got] == [
        (k % 2, k // 2) for k in range(8)]


def test_depth_bounds_the_staged_batches():
    """With nobody taking, the workers stage `depth` batches in all and
    build no more; rows= stages only those rows."""
    made = []

    def make(w):
        made.append(w)
        return {"x": np.arange(8) + 100 * w}
    pf = BatchPrefetcher(make, depth=3, num_workers=2, rows=slice(2, 6))
    try:
        deadline = time.time() + ERROR_S
        staged = lambda: sum(q.qsize() for q in pf._queues)  # noqa: E731
        while staged() < 3 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        assert staged() == 3
        # Each worker stops after its share and one batch it holds.
        assert len(made) <= 5
        b = pf.next()
        assert torch.equal(b["x"], torch.arange(2, 6))
    finally:
        pf.close()
    with pytest.raises(ValueError):
        BatchPrefetcher(make, depth=1, num_workers=2)


def test_close_stops_the_workers():
    pf = BatchPrefetcher(lambda w: {"x": np.zeros(4)}, depth=2,
                         num_workers=2)
    pf.next()
    pf.close()
    assert not any(t.is_alive() for t in pf._threads)
    with pytest.raises(RuntimeError, match="closed"):
        pf.next()


def test_worker_error_is_raised_by_next():
    """A worker's exception reaches the next next() within ERROR_S, also
    when next() waits on the other worker."""
    def make(w):
        if w == 1:
            raise OSError("disk gone")
        time.sleep(0.05)
        return {"x": np.zeros(2)}
    pf = BatchPrefetcher(make, depth=2, num_workers=2)
    t0 = time.time()
    try:
        with pytest.raises(OSError, match="disk gone"):
            for _ in range(4):
                pf.next()
    finally:
        pf.close()
    assert time.time() - t0 < ERROR_S


@pytest.fixture(scope="module")
def trained_dir(tmp_path_factory):
    """A directory where `train` ran two tiny_debug steps (exp/state/), and
    that run: its model and Adam state, which the tests read only (or
    copy)."""
    root = tmp_path_factory.mktemp("trained")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        run = cli.main(["train", *BASE, "--exp_name", "state", "--steps",
                        "2"])
    return root, run


@pytest.fixture
def trained(trained_dir, monkeypatch):
    monkeypatch.chdir(trained_dir[0])
    return trained_dir[1]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _assert_tree_equal(a, b, where="state"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def test_async_save_equals_save_checkpoint(trained, tmp_path):
    """The .pt holds what save_checkpoint's holds; the .npz the same
    arrays."""
    run = trained
    ck = checkpoints.AsyncCheckpointer()
    ck.save(str(tmp_path / "a"), run.model, run.optimizer, 7)
    pt, npz = ck.wait()
    pt_s, npz_s = checkpoints.save_checkpoint(str(tmp_path / "s"),
                                              run.model, run.optimizer, 7)
    assert os.path.basename(pt) == os.path.basename(pt_s)
    _assert_tree_equal(_load(pt), _load(pt_s))
    a, s = np.load(npz), np.load(npz_s)
    assert set(a.files) == set(s.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], s[k], err_msg=k)


def test_async_save_snapshots_the_state(trained, tmp_path):
    """A parameter and a moment changed right after save() do not reach
    the file: the save holds the state as it was."""
    run = types.SimpleNamespace()
    run.model, run.optimizer = copy.deepcopy((trained.model,
                                              trained.optimizer))
    want = {k: v.clone() for k, v in run.model.state_dict().items()}
    table = run.model.nerf_mlp.table
    moment = run.optimizer.state[table]["exp_avg"]
    want_moment = moment.clone()
    ck = checkpoints.AsyncCheckpointer()
    ck.save(str(tmp_path / "a"), run.model, run.optimizer, 3)
    with torch.no_grad():
        table.add_(1.0)
        moment.add_(1.0)
    pt, _ = ck.wait()
    state = _load(pt)
    _assert_tree_equal(dict(state["model"]), want, "model")
    idx = [p is table for p in run.model.parameters()].index(True)
    assert torch.equal(state["optimizer"]["state"][idx]["exp_avg"],
                       want_moment)


def test_async_save_keeps_and_prunes_as_before(trained, tmp_path):
    run = trained
    out = str(tmp_path / "k")
    ck = checkpoints.AsyncCheckpointer()
    for step in (1, 2, 3):
        ck.save(out, run.model, run.optimizer, step, keep=2)
    ck.wait()
    assert sorted(os.listdir(out)) == [
        "checkpoint_2.pt", "checkpoint_3.pt", "params_2.npz",
        "params_3.npz"]


def test_wait_raises_the_writers_error(trained, tmp_path):
    run = trained
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = checkpoints.AsyncCheckpointer()
    ck.save(str(blocker / "sub"), run.model, run.optimizer, 1)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # raised once


def test_train_resumes_from_its_async_checkpoint(trained_dir, tmp_path,
                                                 monkeypatch):
    """The second run resumes from what the first run's writer saved:
    its weights and Adam state at step 2 (in a copy of its directory)."""
    root, trained = trained_dir
    shutil.copytree(root / "exp", tmp_path / "exp")
    monkeypatch.chdir(tmp_path)
    saved = _load(os.path.join("exp", "state", "checkpoint_2.pt"))
    _assert_tree_equal(dict(saved["model"]),
                       dict(trained.model.state_dict()), "model")
    loaded = []
    restore = checkpoints.restore_checkpoint

    def spy(directory, model, optimizer, *args):
        step = restore(directory, model, optimizer, *args)
        loaded.append(({k: v.clone() for k, v in model.state_dict().items()},
                       step))
        return step
    monkeypatch.setattr(checkpoints, "restore_checkpoint", spy)
    run = cli.main(["train", *BASE, "--exp_name", "state", "--steps", "3"])
    assert run.init_step == 2 and loaded[0][1] == 2
    _assert_tree_equal(loaded[0][0], dict(saved["model"]), "restored")
    assert sorted(os.listdir(os.path.join("exp", "state"))) == [
        "checkpoint_3.pt", "config.json", "params_3.npz"]


def test_async_params_load_in_the_jax_package(trained, tmp_path):
    """params_<step>.npz of the asynchronous save, as a JAX train state's
    params in a msgpack checkpoint, comes back through the JAX package's
    `restore_model_params` with the tree of the JAX model's init."""
    import flax.serialization
    tree = convert.load_npz_params(os.path.join("exp", "state",
                                                "params_2.npz"))
    path = tmp_path / "checkpoint_2.ckpt"
    path.write_bytes(flax.serialization.msgpack_serialize(
        {"params": tree, "step": 2}))
    params, step = jcheckpoints.restore_model_params(str(tmp_path))
    assert step == 2
    jcfg = dataclasses.replace(jconfigs.tiny_debug(),
                               dataset_loader="synthetic")
    probe = {k: jnp.asarray(v) for k, v in jcli._probe_batch(
        types.SimpleNamespace(near=0.2, far=8.0)).items()}
    shapes = jax.eval_shape(JaxModel(jcfg.model).init,
                            jax.random.PRNGKey(0), None, probe)
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(got) == len(want)
    for key, leaf in want:
        assert got[key].shape == leaf.shape, key
    model = Model(configs.tiny_debug().model)
    model.load_state_dict(convert.flax_to_state_dict(
        params, configs.tiny_debug().model))
    _assert_tree_equal(dict(model.state_dict()),
                       dict(trained.model.state_dict()), "via JAX")
