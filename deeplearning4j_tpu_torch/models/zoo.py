"""ZooModel base: build and initialize a zoo architecture.

Counterpart of ``deeplearning4j_tpu/models/zoo.py`` without the pretrained
download machinery (slice 1 serves seeded or carried-over weights).
"""

from __future__ import annotations


class ZooModel:
    """Subclasses implement ``conf()`` returning a built configuration."""

    name: str = "zoo"

    def __init__(self, num_classes: int = 1000, seed: int = 123, **kwargs):
        self.num_classes = int(num_classes)
        self.seed = int(seed)
        self.kwargs = kwargs

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        """Build + init the network on ``device`` (default the CUDA card)."""
        conf = self.conf()
        for knob in ("compute_dtype", "remat_policy"):
            v = self.kwargs.get(knob)
            if v == "float32" and knob == "compute_dtype":
                v = None  # fp32 is the default: no cast pipeline for no-op casts
            if v is not None and getattr(conf, "global_conf", None) is not None:
                setattr(conf.global_conf, knob, v)
        from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
            ComputationGraphConfiguration,
        )

        if not isinstance(conf, ComputationGraphConfiguration):
            raise NotImplementedError(
                "MultiLayerNetwork zoo models come with the next slice "
                "(ROADMAP § A)")
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        return ComputationGraph(conf).init(device=device)
