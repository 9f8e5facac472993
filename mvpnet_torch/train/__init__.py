"""Batch preparation, the train and eval steps, solver, checkpoints, the
training loop, and metrics."""
