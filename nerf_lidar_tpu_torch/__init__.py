"""PyTorch + CUDA port of `nerf_lidar_tpu` for one NVIDIA H100.

The JAX package `nerf_lidar_tpu` is the reference: every module here keeps
the name and layout of its JAX counterpart (`ops/`, `models/`, `renderer.py`,
`lidar/render.py`, `cli.py`) and is tested against it on the same inputs and
the same weights (`tests/test_torch_*.py`).

This package imports torch and nothing of jax or of the JAX package. It
keeps its own copies of the host-side numpy code it needs (`configs.py`,
`lidar/{sensor,transforms,range_image,export}.py`, `data/*.py`,
`raydrop/features.py` and the config/scene helpers of `cli.py`), held
equal to the originals by `tests/test_torch_host.py`.

Ported so far: the LiDAR sweep render path, the train step (both with
dynamic objects) and its host side (`train/prefetch.py`, asynchronous
checkpoints), data parallelism over `torch.distributed` (`parallel/`), the
ray-drop stage (`raydrop/`: range-image features,
the U-Net with its VGG19 / Darknet-53 losses, drop and SemanticKITTI
export), and the hash-table gather microbenchmark
(`experiments/gather_bench.py`). Their kernels are hand-written CUDA for
sm_90a under `csrc/`: the fused compositor (`ops/render_fused.py`), the
hash-grid multisample encode, its backward and the row scatter-add
(`ops/grid.py`), and the in-tile gathers (`ops/tile_gather.py`). Each has a
plain PyTorch twin that CPU tensors take.
"""
