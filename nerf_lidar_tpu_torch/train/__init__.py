"""Training of the port: losses, the train step, checkpoints."""
