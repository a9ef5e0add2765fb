"""The port's msgpack reader (`utils/msgpack.py`) against
`flax.serialization.msgpack_restore`, and the checkpoint lookups built on it
(`train/checkpoints.py`, `RayDropTrainer.restore`) against the JAX package.

Trees must agree key for key and leaf for leaf, bit for bit: arrays of the
same dtype and shape with equal bytes (NaN payloads included), numpy scalars
of the same type and bits, bfloat16 leaves (torch tensors in the port) with
the same 16 bits. The JAX U-Net restored from its `.ckpt` is held to the
U-Net eval tolerance of tests/test_torch_raydrop_model.py: logits within
1e-5 of their largest value.
"""

import dataclasses
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs as jconfigs
from nerf_lidar_tpu.models import posenet as jposenet
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu.raydrop import trainer as jtrainer
from nerf_lidar_tpu.train import checkpoints as jcheckpoints
from nerf_lidar_tpu.train import train_step as jtrain_step
from nerf_lidar_tpu_torch.raydrop import trainer
from nerf_lidar_tpu_torch.train import checkpoints
from nerf_lidar_tpu_torch.utils import msgpack


def assert_bits_equal(got, want, where="tree"):
    """got (the port's tree) equals want (Flax's) bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            assert_bits_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_bits_equal(a, b, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and \
            want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor), where
        assert got.dtype == torch.bfloat16, where
        assert tuple(got.shape) == np.shape(want), where
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            np.asarray(want).view(np.uint16), err_msg=where)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    elif isinstance(want, np.generic):
        assert type(got) is type(want), where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert type(got) is type(want) and (
            got == want or (got != got and want != want)), where


def both(data: bytes):
    return msgpack.msgpack_restore(data), \
        flax.serialization.msgpack_restore(data)


def _tiny_params():
    cfg = jconfigs.tiny_debug()
    rng = np.random.RandomState(0)
    d = rng.randn(8, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    probe = {k: jnp.asarray(v) for k, v in dict(
        origins=np.zeros((8, 3), np.float32), directions=d, viewdirs=d,
        base_x=d, base_y=d, radii=np.full((8, 1), 1e-3, np.float32),
        near=np.full((8, 1), 0.2, np.float32),
        far=np.full((8, 1), 8.0, np.float32)).items()}
    params = jax.jit(JaxModel(cfg.model).init)(jax.random.PRNGKey(0), None,
                                               probe)
    return cfg, params


@pytest.fixture(scope="module")
def tiny_params():
    return _tiny_params()


@pytest.mark.parametrize("refine", ["plain", "posenet_tracknet"])
def test_train_state_checkpoint_equals_flax(tiny_params, tmp_path, refine):
    """A JAX `save_checkpoint` of a train state (model params, optax Adam
    state, step), with and without the pose / track refiners."""
    cfg, params = tiny_params
    pn = tn = None
    if refine != "plain":
        cfg = dataclasses.replace(cfg, pose_refine=True, track_refine=True)
        pn = jposenet.LearnPose(num_cams=3, num_lidars=1).init(
            jax.random.PRNGKey(1), jnp.zeros(1, jnp.int32))
        tracks = jnp.zeros((2, 4, 9))
        tn = jposenet.TrackOpt(num_objects=2, num_timestamps=4).init(
            jax.random.PRNGKey(2), tracks)
    state, _ = jtrain_step.create_train_state(cfg, params, pn, tn)
    path = jcheckpoints.save_checkpoint(str(tmp_path), state, 7)
    with open(path, "rb") as f:
        data = f.read()
    got, want = both(data)
    assert_bits_equal(got, want)
    assert ("model" in got["params"]) == (refine != "plain")
    # The model's params, peeled as the JAX restore_model_params peels them.
    jp, jstep = jcheckpoints.restore_model_params(str(tmp_path))
    pp, pstep = checkpoints.restore_model_params(str(tmp_path))
    assert pstep == jstep == 7
    assert_bits_equal(pp, jp)
    assert set(pp) == {"params"}


def test_raydrop_state_equals_flax(tmp_path):
    """`to_bytes` of a JAX `RayDropState` (U-Net params, BatchNorm
    statistics, optax state, step) as the JAX trainer saves it."""
    jt = jtrainer.RayDropTrainer(jtrainer.RayDropConfig(vgg=False))
    path = jt.save(str(tmp_path), jt.init_state(jax.random.PRNGKey(3),
                                                16, 64), 12)
    with open(path, "rb") as f:
        got, want = both(f.read())
    assert_bits_equal(got, want)
    assert set(got) == {"step", "params", "batch_stats", "opt_state"}


def test_jax_unet_ckpt_restores_into_the_port(tmp_path):
    """The port's `RayDropTrainer.restore` of the JAX trainer's
    raydrop_#####.ckpt: its step, and eval logits within 1e-5 of their
    largest value of the JAX U-Net's on the same images."""
    jt = jtrainer.RayDropTrainer(jtrainer.RayDropConfig(vgg=False))
    js = jt.init_state(jax.random.PRNGKey(4), 16, 64)
    rng = np.random.RandomState(4)
    # BatchNorm statistics off their init, so that eval mode uses them.
    js = js.replace(step=jnp.asarray(9), batch_stats=jax.tree.map(
        lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape), v.dtype),
        js.batch_stats))
    path = jt.save(str(tmp_path), js, 9)
    pt = trainer.RayDropTrainer(trainer.RayDropConfig(vgg=False))
    ps = pt.restore(path)
    assert ps.step == 9
    images = rng.uniform(-1, 1, (2, 16, 64, 6)).astype(np.float32)
    want = np.asarray(jt._apply(js.params, js.batch_stats,
                                jnp.asarray(images), False)[0])
    with torch.no_grad():
        ps.model.eval()
        got = ps.model(trainer.to_nchw(images, "cpu")).permute(
            0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_chunked_arrays_equal_flax(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE arrive as chunk dicts (set small here, in
    this process only), at the top of the tree and nested; bfloat16 too."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(5)
    tree = {"table": rng.randn(37, 4).astype(np.float32),
            "deep": {"idx": np.arange(50, dtype=np.int32),
                     "bf": jnp.asarray(rng.randn(3, 33), jnp.bfloat16),
                     "small": np.ones(3, np.float32)}}
    data = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got, want = both(data)
    assert_bits_equal(got, want)
    top = flax.serialization.msgpack_serialize(rng.randn(40).astype(
        np.float32))
    got, want = both(top)
    assert_bits_equal(got, want)


def test_scalars_bfloat16_and_complex_equal_flax():
    """numpy scalars (ext 3), bfloat16 arrays and scalars, Python complex
    (ext 2), NaN and inf, ints of every width, nil, bool, str and bytes."""
    tree = {
        "f32": np.float32(1.5), "f64": np.float64(-2.25),
        "i64": np.int64(-(2 ** 40)), "u8": np.uint8(200),
        "b": np.bool_(True), "bf_scalar": jnp.bfloat16(3.0),
        "bf": jnp.asarray([[1.0, -2.5, np.inf], [np.nan, 0.0, 1e-3]],
                          jnp.bfloat16),
        "c": complex(1.5, -2.0), "nan": np.array([np.nan, -np.inf]),
        "ints": [0, 127, 128, -1, -32, -33, 255, 256, 65535, 65536,
                 2 ** 31, -(2 ** 31), 2 ** 63 - 1, -(2 ** 63)],
        "none": None, "yes": True, "no": False, "s": "x" * 40,
        "raw": b"\x00\xff" * 20, "f": 0.1, "empty": {},
        "shapes": {"0": np.zeros((0, 3), np.float32),
                   "1": np.arange(24, dtype=np.int16).reshape(2, 3, 4)},
    }
    got, want = both(flax.serialization.msgpack_serialize(tree))
    assert_bits_equal(got, want)
    assert isinstance(got["bf_scalar"], torch.Tensor)


def test_msgpack_rejects_what_flax_never_writes():
    with pytest.raises(ValueError, match="extension type"):
        msgpack.msgpack_restore(b"\xd4\x05\x00")
    with pytest.raises(ValueError, match="truncated"):
        msgpack.msgpack_restore(b"\xc4\x05ab")
    with pytest.raises(ValueError, match="after the first object"):
        msgpack.msgpack_restore(b"\x01\x02")


def test_newest_weights_across_both_layouts(tmp_path, tiny_params):
    """restore_model_params of a directory takes the higher step of the
    port's params_<step>.npz and the JAX checkpoint_<step>.ckpt, the port's
    on a tie; natural sort (checkpoint_10 after checkpoint_9)."""
    from nerf_lidar_tpu_torch import convert
    cfg, params = tiny_params
    host = jax.tree.map(np.asarray, params)
    d = str(tmp_path)
    assert checkpoints.restore_model_params(d) == (None, 0)
    state, _ = jtrain_step.create_train_state(cfg, params)
    for step in (9, 10):
        jcheckpoints.save_checkpoint(d, state, step, keep=2)
    assert checkpoints.list_checkpoints(d) == jcheckpoints.list_checkpoints(d)
    assert checkpoints.latest_checkpoint(d) == \
        jcheckpoints.latest_checkpoint(d) == os.path.join(
            d, "checkpoint_10.ckpt")
    assert checkpoints.newest_params(d)[1] == 10
    marked = jax.tree.map(lambda v: v + 1, host)
    convert.save_npz_params(os.path.join(d, "params_9.npz"), marked)
    path, step = checkpoints.newest_params(d)
    assert (os.path.basename(path), step) == ("checkpoint_10.ckpt", 10)
    convert.save_npz_params(os.path.join(d, "params_10.npz"), marked)
    path, step = checkpoints.newest_params(d)
    assert (os.path.basename(path), step) == ("params_10.npz", 10)
    got, step = checkpoints.restore_model_params(d)
    np.testing.assert_array_equal(got["params"]["nerf_mlp"]["table"],
                                  marked["params"]["nerf_mlp"]["table"])
    got, step = checkpoints.restore_model_params(
        os.path.join(d, "checkpoint_9.ckpt"))
    assert step == 9
    assert_bits_equal(got, flax.serialization.msgpack_restore(open(
        os.path.join(d, "checkpoint_9.ckpt"), "rb").read())["params"])


def test_smoke_encoder_writes_flax_layout():
    """The port's msgpack writer (`msgpack.msgpack_serialize`, which writes
    chip_smoke.py [14]'s JAX checkpoint on the card's machine, where flax
    is absent) gives the bytes Flax's `msgpack_serialize` gives for the
    same tree, which the port decodes as Flax does."""
    rng = np.random.RandomState(6)
    tree = {"step": np.asarray(60, np.int32), "params": {
        "model": {"params": {f"layer_{i}": {
            "kernel": rng.randn(3, 40).astype(np.float32),
            "bias": np.zeros(40, np.float32)} for i in range(20)}},
        "tracknet": {"params": {"opt_t": rng.randn(1, 8, 3)}}},
        "name": "n" * 40, "count": 300, "neg": -5, "list": [1, 2, "x"],
        "idx": np.arange(70000, dtype=np.int64)}
    data = msgpack.msgpack_serialize(tree)
    assert data == flax.serialization.msgpack_serialize(tree)
    want = flax.serialization.msgpack_restore(data)
    assert_bits_equal(msgpack.msgpack_restore(data), want)


@pytest.mark.parametrize("chunk", [None, 64])
def test_writer_bytes_equal_flax(monkeypatch, chunk):
    """Every kind of value Flax writes, in every length class of msgpack
    (fix, 8, 16 and 32 bits: strings, bytes, lists, maps, ints, ext
    payloads), numpy scalars (ext 3), complex (ext 2), and with a small
    MAX_CHUNK_SIZE (in this process only) the chunked arrays, at the top
    and nested: the bytes of Flax's `msgpack_serialize`."""
    if chunk:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.RandomState(7)
    tree = {
        "f32": np.float32(1.5), "f64": np.float64(-2.25),
        "i64": np.int64(-(2 ** 40)), "u8": np.uint8(200), "b": np.bool_(1),
        "c": complex(1.5, -2.0), "nan": np.array([np.nan, -np.inf]),
        "ints": [0, 127, 128, -1, -32, -33, -128, -129, 255, 256, 65535,
                 65536, -32768, -32769, 2 ** 31, -(2 ** 31), 2 ** 32,
                 2 ** 63 - 1, -(2 ** 63), 2 ** 64 - 1],
        "none": None, "yes": True, "no": False, "f": 0.1,
        "strs": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "v" * 65536],
        "raw": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536],
        "lists": [[1] * 15, [2] * 16, [3] * 65536],
        "maps": {f"k{i}": i for i in range(16)}, "empty": {},
        "ext": [np.zeros(n, np.uint8) for n in (0, 1, 2, 3, 8, 16, 17, 300,
                                                70000)],
        "table": rng.randn(37, 4).astype(np.float32),
        "deep": {"idx": np.arange(50, dtype=np.int32),
                 "small": np.ones(3, np.float32)},
        "shapes": {"0": np.zeros((0, 3), np.float32),
                   "1": np.arange(24, dtype=np.int16).reshape(2, 3, 4)},
    }
    data = msgpack.msgpack_serialize(tree)
    assert data == flax.serialization.msgpack_serialize(tree)
    assert (b"__msgpack_chunked_array__" in data) == bool(chunk)
    assert_bits_equal(msgpack.msgpack_restore(data),
                      flax.serialization.msgpack_restore(data))
    top = rng.randn(40).astype(np.float32)
    assert msgpack.msgpack_serialize(top) == \
        flax.serialization.msgpack_serialize(top)
    with pytest.raises(TypeError, match="cannot serialise"):
        msgpack.msgpack_serialize({"x": object()})
