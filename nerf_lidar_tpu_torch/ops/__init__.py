"""Tensor ops of the port (counterparts of `nerf_lidar_tpu.ops`)."""
