"""LiDAR sweep rendering (counterpart of `nerf_lidar_tpu.lidar.render`), with
the port's copies of the sensor model (`sensor`) and frame transforms
(`transforms`)."""
