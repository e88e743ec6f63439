"""ZooModel base: build and initialize a zoo architecture.

Counterpart of ``deeplearning4j_tpu/models/zoo.py`` without the pretrained
download machinery: the port serves seeded weights, or weights carried
over from a checkpoint (``train/model_serializer.py``).
"""

from __future__ import annotations


class ZooModel:
    """Subclasses implement ``conf()`` returning a built configuration."""

    name: str = "zoo"

    #: serving hint: whether this architecture tolerates int8 weight-only
    #: quantization of its dense/output heads (per-channel scales,
    #: ``nn/ops/int8_matmul.py``). Use is opt-in (``cli serve
    #: --int8-serving``, ``InferenceEngine(int8_serving=True)``); a model
    #: class that sets this False refuses the flag.
    serving_int8: bool = True

    def __init__(self, num_classes: int = 1000, seed: int = 123, **kwargs):
        self.num_classes = int(num_classes)
        self.seed = int(seed)
        self.kwargs = kwargs

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        """Build + init the network on ``device`` (default the CUDA card): a
        ``MultiLayerNetwork`` for a list configuration, else a
        ``ComputationGraph``."""
        conf = self.conf()
        for knob in ("compute_dtype", "remat_policy"):
            v = self.kwargs.get(knob)
            if v == "float32" and knob == "compute_dtype":
                v = None  # fp32 is the default: no cast pipeline for no-op casts
            if v is not None and getattr(conf, "global_conf", None) is not None:
                setattr(conf.global_conf, knob, v)
        from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration

        if isinstance(conf, MultiLayerConfiguration):
            from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

            return MultiLayerNetwork(conf).init(device=device)
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        return ComputationGraph(conf).init(device=device)
