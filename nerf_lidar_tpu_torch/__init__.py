"""PyTorch + CUDA port of `nerf_lidar_tpu` for one NVIDIA H100.

The JAX package `nerf_lidar_tpu` is the reference: every module here keeps
the name and layout of its JAX counterpart (`ops/`, `models/`, `renderer.py`,
`lidar/render.py`, `cli.py`) and is tested against it on the same inputs and
the same weights (`tests/test_torch_*.py`).

This package imports torch and never jax. It reuses the JAX package's
jax-free modules instead of copying them: `nerf_lidar_tpu.configs`,
`nerf_lidar_tpu.lidar.{sensor,transforms}`, `nerf_lidar_tpu.data.*` and the
config/scene helpers at the top of `nerf_lidar_tpu.cli`.

Ported so far: the LiDAR sweep render path (static scene, inference). The
two kernels on that path are hand-written CUDA for sm_90a under `csrc/`:
the fused compositor (`ops/render_fused.py`, replacing the Pallas
`render_pallas.fused_composite`) and the hash-grid multisample encode
(`ops/grid.py`). Each has a plain PyTorch twin that CPU tensors take.
"""
