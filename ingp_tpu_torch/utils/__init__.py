"""Checkpoints and experiment loggers (counterpart of ingp_tpu/utils/)."""
