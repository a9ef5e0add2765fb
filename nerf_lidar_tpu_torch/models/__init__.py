"""Field MLPs and the scene model (counterparts of `nerf_lidar_tpu.models`)."""
