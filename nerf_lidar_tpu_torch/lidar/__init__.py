"""LiDAR sweep rendering (counterpart of `nerf_lidar_tpu.lidar.render`).
The sensor model and frame transforms are the JAX package's numpy modules
`nerf_lidar_tpu.lidar.sensor` and `nerf_lidar_tpu.lidar.transforms`."""
