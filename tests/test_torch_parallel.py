"""The port's data parallelism (`nerf_lidar_tpu_torch/parallel/`) on the
CPU: two ranks over gloo, each in a process of its own
(`tests/_torch_dp_worker.py`, which imports no JAX), against one process
and against the JAX package's 2-device mesh step, at tiny_debug shapes.

The train steps against one process run 256 patch rays (four 8 x 8
patches) of a 320-ray batch, so the smoothness patches cross the two
shards' boundary at row 160; against JAX, the batcher's own 64.
Tolerances: those of `test_torch_train.py::
test_two_steps_match_jax_train_step` (loss rtol 1e-4, parameters atol
1e-5); the renderer those of `tests/test_parallel.py::
test_chunk_renderer_mesh_matches_single_device` (rtol 1e-5, atol 1e-6).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.parallel import data_mesh as jax_data_mesh
from nerf_lidar_tpu.train import train_step as jtrain
from nerf_lidar_tpu_torch import cli, convert, parallel
from nerf_lidar_tpu_torch import configs as tconfigs
from nerf_lidar_tpu_torch.data.batching import RayBatcher
from nerf_lidar_tpu_torch.models.model import Model
from nerf_lidar_tpu_torch.renderer import ChunkRenderer
from nerf_lidar_tpu_torch.train import train_step

import _torch_dp_worker as dp
from test_torch_objects import _batch as _object_batch
from test_torch_objects import _cfg as _object_cfg
from test_torch_objects import _tracks

PATCH_RAYS = 256
JAX_PATCH_RAYS = 64
GEN_SEED = 5
TIMEOUT_S = 180


def _cfg(cfgs=configs):
    return dataclasses.replace(cfgs.tiny_debug(), batch_size=256,
                               lidar_supervision=True,
                               dataset_loader="synthetic")


def _rays(n=200):
    rng = np.random.RandomState(0)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(origins=np.zeros((n, 3), np.float32), directions=d,
                viewdirs=d, base_x=d, base_y=d,
                radii=np.full((n, 1), 1e-3, np.float32),
                near=np.full((n, 1), 0.2, np.float32),
                far=np.full((n, 1), 6.0, np.float32))


def _steps_one_rank(cfg, state, batches, seed, num_patch_rays=PATCH_RAYS,
                    tracks=None, track_mask=None):
    """The one-process reference of the worker's `steps` job."""
    model = Model(cfg.model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    opt = train_step.make_optimizer(model, cfg)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    objects = {} if tracks is None else dict(
        tracks=torch.from_numpy(tracks),
        track_mask=torch.from_numpy(track_mask))
    stats = [train_step.train_step(
        model, opt, cfg, {k: torch.from_numpy(v) for k, v in b.items()},
        step, num_patch_rays, gen, **objects)
        for step, b in enumerate(batches)]
    return stats, model.state_dict(), {
        k: p.grad for k, p in model.named_parameters()}


def _objects_case():
    """The object model's budget case (tests/test_torch_objects.py,
    "overflow": 64 rays through one big box, budget frac 0.01, so the
    global batch's first K samples in a box are kept and the rest
    overflow), with the symmetry term on from the first step; its state dict
    (a seeded init, every table uniform(-0.5, 0.5)), two batches and the
    tracks."""
    cfg = dataclasses.replace(
        _object_cfg(tconfigs, symmetrize=True, obj_sample_frac=0.01),
        sym_start=-1)
    model = Model(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    for k in state:
        if k.endswith("table"):
            state[k] = rng.uniform(-0.5, 0.5, state[k].shape).astype(
                np.float32)
    tracks, mask = _tracks()
    tracks[:, :, 0] = 3.0
    tracks[:, :, 4:7] = 4.0
    tracks[1, :, -1] = 1
    batch = _object_batch(64, labels=True)
    return cfg, state, [batch, batch], tracks, mask


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX params with informative tables, two batches, and one launch of
    two ranks running: two steps without randomness, two with a
    generator, a render, two steps as the JAX test takes them, and then
    the CLI as two hosts (GROUP_RANK 0 and 1, each rank in its own working
    directory): `train --multihost` for 3 steps and `render_lidar` of a
    fresh init."""
    jcfg = _cfg()
    cfg = _cfg(tconfigs)
    scene = cli.load_scene_for(cfg, "train")
    batcher = RayBatcher(scene.data, cfg.batch_size, cfg.patch_size,
                         lidar_supervision=True,
                         lidar_batch_ratio=cfg.lidar_batch_ratio, seed=0)
    batches = [batcher.next(), batcher.next()]
    assert len(batches[0]["rgb"]) == 320
    jmodel = JaxModel(jcfg.model)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), None,
        {k: jnp.asarray(v) for k, v in batches[0].items()})
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(1)
    for sub in params["params"].values():
        sub["table"] = rng.uniform(-0.1, 0.1, sub["table"].shape).astype(
            np.float32)
    state = {k: v.numpy() for k, v in
             convert.flax_to_state_dict(params, cfg.model).items()}
    common = dict(cfg_json=cfg.to_json(), state=state)
    jobs = [dict(fn="steps", batches=batches, num_patch_rays=PATCH_RAYS,
                 seed=None, **common),
            dict(fn="steps", batches=batches, num_patch_rays=PATCH_RAYS,
                 seed=GEN_SEED, **common),
            dict(fn="render", rays=_rays(), chunk=64, **common),
            dict(fn="steps", batches=batches, num_patch_rays=JAX_PATCH_RAYS,
                 seed=None, **common)]
    root = tmp_path_factory.mktemp("dp")
    cwds = [str(root / f"host{r}") for r in range(2)]
    for d in cwds:
        os.makedirs(d)
    base = ["--config", "tiny_debug", "--set", "dataset_loader=synthetic",
            "--device", "cpu", "--exp_name", "mh"]
    jobs.append(dict(
        fn="cli_runs", record_batches=3, cwd=cwds,
        env=[dict(GROUP_RANK=str(r), LOCAL_WORLD_SIZE="1") for r in range(2)],
        argvs=[["train", *base, "--steps", "3", "--multihost"],
               ["render_lidar", *base, "--num_sweeps", "1",
                "--azimuth_steps", "8", "--allow_fresh"]]))
    ocfg, ostate, obatches, tracks, mask = _objects_case()
    jobs.append(dict(fn="steps", cfg_json=ocfg.to_json(), state=ostate,
                     batches=obatches, num_patch_rays=0, tracks=tracks,
                     track_mask=mask))
    ranks = dp.launch(jobs, 2, str(root), TIMEOUT_S)
    return dict(cfg=cfg, jcfg=jcfg, params=params, jmodel=jmodel,
                batches=batches, state=state, ranks=ranks,
                objects=(ocfg, ostate, obatches, tracks, mask))


@pytest.mark.parametrize("shape,axes,want", [
    ((-1,), ("data",), dict(size=4, index=[0, 1, 2, 3], shards=(0, 1, 2, 3),
                            rows=[(0, 2), (2, 4), (4, 6), (6, 8)])),
    ((-1, 2), ("data", "model"), dict(size=2, index=[0, 0, 1, 1],
                                      shards=(0, 2),
                                      rows=[(0, 4), (0, 4), (4, 8),
                                            (4, 8)])),
])
def test_data_mesh_rows_and_index(shape, axes, want):
    """Rank r's data index is its row in np.arange(world).reshape(shape),
    as the JAX mesh reshapes its devices; replicas share rows."""
    for r in range(4):
        mesh = parallel.data_mesh(r, 4, shape, axes)
        assert mesh.data_size == want["size"]
        assert mesh.data_index == want["index"][r]
        assert mesh.shard_ranks == want["shards"]
        rows = mesh.rows(8)
        assert (rows.start, rows.stop) == want["rows"][r]
    with pytest.raises(ValueError):
        parallel.data_mesh(0, 4).rows(6)


@pytest.mark.parametrize("job,seed", [(0, None), (1, GEN_SEED)],
                         ids=["key_none", "generator"])
def test_two_steps_at_two_ranks_equal_one_rank(setup, job, seed):
    """Two ranks on one global batch take the one-process step, with the
    randomness drawn at the global batch's shape, and hold equal
    parameters after every step."""
    cfg = setup["cfg"]
    want_stats, want_state, _ = _steps_one_rank(cfg, setup["state"],
                                                setup["batches"], seed)
    got = [rank["results"][job] for rank in setup["ranks"]]
    for name, v in got[0]["state"].items():
        np.testing.assert_array_equal(got[1]["state"][name], v,
                                      err_msg=name)
        np.testing.assert_allclose(v, want_state[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    for step, want in enumerate(want_stats):
        for rank in got:
            stats = rank["stats"][step]
            assert set(stats) == set(want)
            for k, w in want.items():
                np.testing.assert_allclose(stats[k], w.numpy(), rtol=1e-4,
                                           atol=1e-7, err_msg=f"{step} {k}")


def test_two_ranks_with_objects_equal_one_rank(setup):
    """Dynamic objects under the sample budget: the global batch's first K
    samples in a box are kept across the two shards, and the loss terms
    (symmetry included), the overflow and hit-share stats, the gradients
    and the parameters equal one process's."""
    cfg, state, batches, tracks, mask = setup["objects"]
    want_stats, want_state, want_grads = _steps_one_rank(
        cfg, state, batches, None, 0, tracks, mask)
    got = [rank["results"][5] for rank in setup["ranks"]]
    assert float(want_stats[0]["obj_overflow"]) > 0
    assert float(want_stats[0]["sym"]) > 0
    for step, want in enumerate(want_stats):
        for rank in got:
            stats = rank["stats"][step]
            assert set(stats) == set(want)
            for k, w in want.items():
                np.testing.assert_allclose(stats[k], w.float().numpy(),
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"{step} {k}")
    for name, v in got[0]["state"].items():
        np.testing.assert_array_equal(got[1]["state"][name], v,
                                      err_msg=name)
        np.testing.assert_allclose(v, want_state[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    for name, g in got[0]["grads"].items():
        w = want_grads[name].numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)


def test_two_ranks_match_the_jax_mesh_step(setup):
    """The two-rank step with key=None against the JAX package's
    `make_train_step(mesh=data_mesh(2 devices))`, from the same weights
    (carried by `convert.py`)."""
    jcfg = setup["jcfg"]
    state, tx = jtrain.create_train_state(
        jcfg, jax.tree_util.tree_map(jnp.asarray, setup["params"]))
    step_fn = jtrain.make_train_step(
        setup["jmodel"], tx, jcfg, mesh=jax_data_mesh(jax.devices()[:2]),
        donate=False, num_patch_rays=JAX_PATCH_RAYS)
    got = setup["ranks"][0]["results"][3]
    for step, batch in enumerate(setup["batches"]):
        state, jstats = step_fn(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                                None, None, None)
        np.testing.assert_allclose(float(got["stats"][step]["loss"]),
                                   float(jstats["loss"]), rtol=1e-4)
    want = convert.flatten_params(
        jax.tree_util.tree_map(np.asarray, state.params))
    have = convert.flatten_params(convert.state_dict_to_flax(
        {k: torch.from_numpy(v) for k, v in got["state"].items()}))
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_chunk_renderer_mesh_equals_one_rank(setup):
    """ChunkRenderer(mesh=) over two ranks, 200 rays at chunk 64 (padding
    by the last ray), equals the unsharded render on every rank."""
    cfg = setup["cfg"]
    model = Model(cfg.model)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in setup["state"].items()})
    want = ChunkRenderer(model.eval(), cfg, 64).render(_rays())
    for rank in setup["ranks"]:
        got = rank["results"][2]
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_multihost_seeds_each_host_by_group_rank(setup):
    """`--multihost`: host g's batches come from batchers seeded seed + g
    + 1000 + w, the rank keeping its rows; every rank still ends with the
    same weights (the gradients are summed)."""
    cfg = dataclasses.replace(tconfigs.tiny_debug(),
                              dataset_loader="synthetic")
    scene = cli.load_scene_for(cfg, "train")
    states = []
    for g, rank in enumerate(setup["ranks"]):
        res = rank["results"][4]
        assert res["runs"][0]["seed"] == cfg.seed + g
        states.append(res["runs"][0]["state"])
        workers = cli.step_batchers(
            dataclasses.replace(cfg, seed=cfg.seed + g), scene, True)
        total = workers[0].total_rays
        for k, got in enumerate(res["batches"]):
            want = workers[k % 2].next()
            rows = slice(g * total // 2, (g + 1) * total // 2)
            assert set(got) == set(want)
            for key, v in want.items():
                np.testing.assert_array_equal(got[key], v[rows],
                                              err_msg=f"{g} {k} {key}")
    for name, v in states[0].items():
        np.testing.assert_array_equal(states[1][name], v, err_msg=name)


def test_only_rank_zero_writes(setup):
    """Rank 0 writes config.json, the checkpoint, the params, the metrics
    and the sweep; rank 1's working directory stays empty."""
    files = [rank["results"][4]["files"] for rank in setup["ranks"]]
    assert files[1] == []
    names = {os.path.basename(f) for f in files[0]}
    assert {"config.json", "checkpoint_3.pt", "params_3.npz",
            "points_0000.npy", "lidar2globals.npy"} <= names, names
    for rank in setup["ranks"]:
        assert rank["modules"] == []


def test_init_distributed_needs_multihost_across_hosts(monkeypatch):
    """A launch whose world spans hosts is refused without --multihost;
    a world of 1 initialises nothing."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="--multihost"):
        parallel.init_distributed(False, torch.device("cpu"))
    monkeypatch.setenv("WORLD_SIZE", "1")
    parallel.init_distributed(False, torch.device("cpu"))
    assert parallel.maybe_data_mesh() is None and parallel.is_main()


def test_device_cuda_is_the_local_rank(monkeypatch):
    """--device cuda is cuda:LOCAL_RANK under torchrun, cuda:0 without;
    an explicit index is kept."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert cli._device("cuda") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert cli._device("cuda") == torch.device("cuda", 3)
    assert cli._device("cuda:1") == torch.device("cuda", 1)
    assert cli._device("cpu") == torch.device("cpu")


def test_eval_follow_on_two_ranks(tmp_path):
    """`eval --follow` under a data mesh: rank 0 polls its experiment
    directory (rank 1 works in another, which holds no checkpoint), both
    ranks evaluate the step rank 0 found with rank 0's weights, each
    rendering its rows of every chunk, and stop after --steps; the
    metrics equal one process's eval of the same weights."""
    base = ["--config", "tiny_debug", "--set", "dataset_loader=synthetic",
            "--device", "cpu", "--exp_name", "f"]
    dirs = [str(tmp_path / f"rank{r}") for r in range(2)]
    for d in dirs:
        os.makedirs(d)
    here = os.getcwd()
    os.chdir(dirs[0])
    try:
        cli.main(["train", *base, "--steps", "2"])
        want = cli.main(["eval", *base, "--exp_name", "one", "--params",
                         os.path.join("exp", "f", "params_2.npz"),
                         "--max_views", "1"]).metrics
    finally:
        os.chdir(here)
    ranks = dp.launch([dict(fn="cli_runs", cwd=dirs, argvs=[
        ["eval", *base, "--follow", "--steps", "2", "--poll_every", "0.1",
         "--follow_timeout", "20", "--max_views", "1"]])], 2, str(tmp_path),
        TIMEOUT_S)
    runs = [r["results"][0]["runs"][0] for r in ranks]
    assert [r["steps"] for r in runs] == [[2], [2]]
    for run in runs:
        assert {k: v for k, v in run["metrics"].items()
                if k != "median_render_time_s"} == {
            k: v for k, v in want.items() if k != "median_render_time_s"}
    for name, v in runs[0]["state"].items():
        np.testing.assert_array_equal(runs[1]["state"][name], v,
                                      err_msg=name)
    assert os.listdir(dirs[1]) == []
