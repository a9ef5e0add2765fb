"""Flax <-> torch weight conversion on `tiny_debug` parameters (exact)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_lidar_tpu import configs
from nerf_lidar_tpu.models.model import Model as JaxModel
from nerf_lidar_tpu_torch import convert
from nerf_lidar_tpu_torch.models.model import Model


def _probe_batch(n=8):
    rng = np.random.RandomState(0)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {k: jnp.asarray(v) for k, v in dict(
        origins=np.zeros((n, 3), np.float32), directions=d, viewdirs=d,
        base_x=d, base_y=d, radii=np.full((n, 1), 1e-3, np.float32),
        near=np.full((n, 1), 0.2, np.float32),
        far=np.full((n, 1), 8.0, np.float32)).items()}


@pytest.fixture(scope="module")
def tiny():
    cfg = configs.tiny_debug()
    params = jax.jit(JaxModel(cfg.model).init)(jax.random.PRNGKey(0), None,
                                               _probe_batch())
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def test_every_leaf_maps_and_every_parameter_fills(tiny):
    cfg, params = tiny
    flat = convert.flatten_params(params)
    assert "params/nerf_mlp/table" in flat
    assert "params/nerf_mlp/view_layers_1/kernel" in flat
    sd = convert.flax_to_state_dict(params, cfg.model)
    assert len(sd) == len(flat)
    model = Model(cfg.model)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)  # strict: shapes and names all agree

    for path, v in flat.items():
        name = convert._torch_name(path.split("/", 1)[1])
        want = v.T if path.endswith("/kernel") else v
        np.testing.assert_array_equal(sd[name].numpy(), want)
    # The skip concat widens view_layers_1: W + (W + 27) = 32 + 59.
    assert sd["nerf_mlp.view_layers.1.weight"].shape == (32, 91)


def test_npz_round_trip(tiny, tmp_path):
    cfg, params = tiny
    path = tmp_path / "params.npz"
    np.savez(path, **convert.flatten_params(params))
    a = convert.flax_to_state_dict(params, cfg.model)
    b = convert.flax_to_state_dict(convert.load_npz_params(str(path)),
                                   cfg.model)
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_state_dict_to_flax_inverts_and_saves(tiny, tmp_path):
    """The port's weights back to the Flax tree: exactly the tree they came
    from, through the .npz layout `--params` reads."""
    cfg, params = tiny
    model = Model(cfg.model)
    model.load_state_dict(convert.flax_to_state_dict(params, cfg.model))
    tree = convert.state_dict_to_flax(model.state_dict())
    path = convert.save_npz_params(str(tmp_path / "p.npz"), tree)
    assert sorted(os.listdir(tmp_path)) == ["p.npz"]
    want = convert.flatten_params(params)
    for got in (convert.flatten_params(tree),
                convert.flatten_params(convert.load_npz_params(path))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_leftover_or_missing_leaves_raise(tiny):
    cfg, params = tiny
    flat = convert.flatten_params(params)
    extra = dict(flat)
    extra["params/nerf_mlp/normal_layer/kernel"] = np.zeros((32, 3),
                                                            np.float32)
    with pytest.raises(KeyError):
        convert.flax_to_state_dict(convert.unflatten_params(extra), cfg.model)
    missing = {k: v for k, v in flat.items() if "rgb_layer" not in k}
    with pytest.raises(KeyError):
        convert.flax_to_state_dict(convert.unflatten_params(missing),
                                   cfg.model)


def test_fresh_init_is_seeded():
    cfg = configs.tiny_debug()
    a, b = Model(cfg.model), Model(cfg.model)
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    table = a.nerf_mlp.table.detach()
    assert float(table.abs().max()) <= 1e-4 and float(table.std()) > 0
    assert float(a.nerf_mlp.density_layers[0].bias.detach().abs().max()) \
        == 0.0
