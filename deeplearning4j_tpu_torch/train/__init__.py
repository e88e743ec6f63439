"""Checkpoints (slice 3: the zip format and the checkpoint-validation
helpers the serving engine uses)."""
