"""Ray-drop stage (counterpart of `nerf_lidar_tpu.raydrop`): learn which
simulated LiDAR rays a real sensor would return (a U-Net over range images
with VGG / Darknet perceptual losses), then export labelled point clouds in
SemanticKITTI format. Networks are `nn.Module`s on NCHW tensors; the
feature assembly is the port's copy of the JAX package's host numpy."""
