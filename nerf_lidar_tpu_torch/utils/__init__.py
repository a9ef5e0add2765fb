"""Host-side helpers of the port (copies from `nerf_lidar_tpu.utils`)."""
