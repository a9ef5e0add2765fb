"""Host-side data layer (numpy): copies of the JAX package's camera ray
casting, nuScenes-format scene loading, synthetic scenes and batching,
held equal by tests/test_torch_host.py."""
