"""Microbenchmarks of the port (counterparts of `experiments/`)."""
