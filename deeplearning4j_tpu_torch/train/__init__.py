"""Checkpoints (slice 3: the zip format and the checkpoint-validation
helpers the serving engine uses), bundled train steps (``pipeline.py``,
slice 18) and the training fault policy (``faults.py``, slice 20)."""
