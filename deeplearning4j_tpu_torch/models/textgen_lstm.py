"""TextGenerationLSTM: a character-level language model, two stacked
GravesLSTM layers and a per-timestep softmax head.

Counterpart of ``deeplearning4j_tpu/models/textgen_lstm.py`` (``:21-42``):
the same configuration, so its JSON is the reference's. The configuration
names ``RmsProp(1e-2)`` and tBPTT 40/40, which ``fit`` trains with
(``nn/multilayer.py``: chunks of 40 steps, one update a chunk); the model
serves through ``InferenceEngine`` (sequence buckets) and
``GenerationEngine``.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import GravesLSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.updaters import RmsProp


class TextGenerationLSTM(ZooModel):
    name = "textgenlstm"

    #: serving hint: sequences arrive at any length; the engines pad time
    #: to these buckets under a mask (padded steps hold the state)
    serving_seq_buckets = (8, 16, 32, 64)

    def __init__(self, num_classes: int = 77, units: int = 256,
                 max_length: int = 40, **kwargs):
        # num_classes: the vocabulary (character set) size
        super().__init__(num_classes=num_classes, **kwargs)
        self.units = int(units)
        self.max_length = int(max_length)

    def conf(self):
        return (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(self.kwargs.get("updater", RmsProp(1e-2)))
            .weight_init("xavier")
            .list()
            .layer(GravesLSTM(n_out=self.units, activation="tanh"))
            .layer(GravesLSTM(n_out=self.units, activation="tanh"))
            .layer(RnnOutputLayer(n_out=self.num_classes, activation="softmax",
                                  loss="mcxent"))
            .backprop_type("tbptt", self.max_length, self.max_length)
            .set_input_type(InputType.recurrent(self.num_classes))
            .build()
        )
