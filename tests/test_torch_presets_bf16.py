"""The bfloat16 presets against the JAX package: `speed_variant` over
`mxu_variant` (nuscenes_single_speed's composition: one 64-sample
proposal level, the 512-frequency spectral NeRF field, bfloat16 MLPs) and
`bf16_variant` of `tiny_debug` (the hash grids with bfloat16 MLPs), with
the helpers and inputs of test_torch_presets.py; and a JAX `_speed`
checkpoint read and evaluated by the port.

The bfloat16 tolerance: renderings atol 5e-4 (depth too; measured
2.8e-4 at most on the speed preset, 9.5e-5 on bf16); loss terms rtol 1e-3
(measured up to 2.3e-4, on the smoothness terms, which difference
neighbouring rays' outputs and so cancel most of each value); gradients 5% relative L2 per parameter, or the port no
farther than JAX from the port's float64 gradient of the float32 twin;
parameters after each step as test_torch_presets.py, with the update's
RMS within 10% of lr (measured 3.4%, the speed semantic head's first
layer). Both packages round
every Dense's input, weight, bias and product to bfloat16 at the same
places, so most values agree to the bit; a sum whose float32 accumulation
lands near a bfloat16 rounding boundary rounds the other way in the other
framework (one bfloat16 ulp, 2^-8 relative), which the next layers carry:
hence 5e-4 on renderings of O(1). JAX also reduces each bias cotangent in
bfloat16 where the port's reduction accumulates in float32, so JAX's bias
gradients sit up to 4.5% (L2) from the float64 gradient and the port's
within 0.7%. The float32 twin of the same weights (the port with
`compute_dtype='float32'`) misses the JAX bfloat16 renderings by 1.3e-3:
a port that ignored the policy would fail here.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from nerf_lidar_tpu import cli as jcli
from nerf_lidar_tpu_torch import cli
from nerf_lidar_tpu_torch.models.mlp import Dense
from test_torch_presets import (assert_steps_match, forward_both,
                                port_grads, port_grads_f64, port_model,
                                preset_cfg, preset_setup, two_steps)

BF16_ATOL = 5e-4


def f32_twin(cfg):
    """The same config with float32 MLPs."""
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, **{k: dataclasses.replace(getattr(m, k), compute_dtype="float32")
              for k in ("nerf_mlp", "prop_mlp", "obj_mlp")}))


@pytest.fixture(scope="module", params=["speed", "bf16"])
def bf16_preset(request):
    return request.param, preset_setup(request.param)


def _max_render_error(got, want):
    return max(float(np.abs(g[k] - w[k]).max())
               for g, w in zip(got, want) for k in w)


def test_bf16_preset_runs_bf16_matmuls(bf16_preset):
    name, (cfg, _, _, params, *_) = bf16_preset
    model = port_model(cfg, params)
    dense = [m for m in model.modules() if isinstance(m, Dense)]
    assert dense and all(m.compute_dtype == torch.bfloat16 for m in dense)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if name == "speed":
        assert len(model.prop_mlps) == 1
        assert model.nerf_mlp.fourier_freqs.shape == (3, 512)
        assert cfg.render_fused is False and cfg.render_chunk_size == 8800


def test_bf16_renderings_match_jax_and_not_float32(bf16_preset):
    _, setup = bf16_preset
    got, want = forward_both(setup)
    for level, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), level
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=BF16_ATOL,
                                       err_msg=f"{k} {level}")
    twin, _ = forward_both((f32_twin(setup[0]),) + setup[1:])
    assert _max_render_error(twin, want) > 2 * BF16_ATOL


def test_bf16_losses_and_gradients_match_jax(bf16_preset):
    _, (cfg, batches, _, params, _, want, _) = bf16_preset
    terms, grads = port_grads(cfg, port_model(cfg, params), batches[0])
    assert set(terms) == set(want["terms"])
    for k, v in terms.items():
        np.testing.assert_allclose(v.detach().numpy(), want["terms"][k],
                                   rtol=1e-3, atol=1e-9, err_msg=k)
    ref = port_grads_f64(f32_twin(cfg), params, batches[0])
    assert set(grads) == set(want["grads"])
    norm = lambda a: float(np.linalg.norm(a))
    for k, g in grads.items():
        w = want["grads"][k]
        assert norm(w) > 0, k
        if norm(g - w) <= 5e-2 * norm(w):
            continue
        assert norm(g - ref[k]) <= norm(w - ref[k]), k


def test_bf16_two_steps_match_jax(bf16_preset):
    _, setup = bf16_preset
    assert_steps_match(setup, two_steps(setup), rms_frac=0.1)


def test_jax_speed_checkpoint_evaluates_equal_in_the_port(tmp_path,
                                                          monkeypatch):
    """A JAX-trained `checkpoint_2.ckpt` of the speed preset on tiny_debug
    (speed_variant over mxu_variant), read by the port's msgpack reader:
    `eval` of both packages on it gives the same metrics at rtol 3e-3 and
    test views within atol 2e-3 (measured: 1.2e-3 relative on ssim_cc, a
    least-squares colour correction of the view, 7.6e-5 on psnr; 9.2e-4 on
    rgb over the 8 views' 12,288 rays, where a bfloat16 rounding of the
    proposal MLP moves a resampled interval; JAX rendering with the port's
    frequency matrix in place of its own moves them by 1e-4)."""
    monkeypatch.chdir(tmp_path)
    cfg = dataclasses.replace(preset_cfg("speed"), batch_size=64,
                              lidar_supervision=False)
    with open("speed.json", "w") as f:
        f.write(cfg.to_json())
    jcli.main(["train", "--config_json", "speed.json", "--exp_name", "j",
               "--steps", "2"])
    assert os.path.exists("exp/j/checkpoint_2.ckpt")
    os.makedirs("exp/p")
    shutil.copy("exp/j/checkpoint_2.ckpt", "exp/p/checkpoint_2.ckpt")
    jcli.main(["eval", "--config_json", "speed.json", "--exp_name", "j"])
    run = cli.main(["eval", "--config_json", "speed.json", "--exp_name", "p",
                    "--device", "cpu"])
    assert run.steps == [2]
    assert run.cfg.model.nerf_mlp.compute_dtype == "bfloat16"
    want = json.load(open("exp/j/eval/metrics.json"))
    got = json.load(open("exp/p/eval/metrics.json"))
    assert got["step"] == want["step"] == 2
    for k in ("psnr", "ssim", "psnr_cc", "ssim_cc"):
        np.testing.assert_allclose(got[k], want[k], rtol=3e-3, err_msg=k)
    names = [n for n in os.listdir("exp/j/eval") if n.endswith(".npy")]
    assert names and sorted(names) == sorted(
        n for n in os.listdir("exp/p/eval") if n.endswith(".npy"))
    for name in names:
        np.testing.assert_allclose(np.load(f"exp/p/eval/{name}"),
                                   np.load(f"exp/j/eval/{name}"),
                                   atol=2e-3, err_msg=name)

