"""TextGenerationLSTM — the zoo's char-RNN (mirrors
``deeplearning4j_tpu/models/textgen_lstm.py``): 2 × GravesLSTM(256) and a
softmax/mcxent RnnOutputLayer, trained with TBPTT(50) and elementwise
gradient clipping at 1.0."""

from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.layers import GravesLSTM, RnnOutputLayer
from ..nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
from ..nn.updaters import GradientNormalization, RmsProp
from ..utils.device import DeviceLike


def TextGenerationLSTM(vocab_size: int = 77, hidden: int = 256,
                       tbptt_length: int = 50, seed: int = 42,
                       updater=None, device: DeviceLike = None) -> MultiLayerNetwork:
    """The char-RNN, initialized from ``seed`` on ``device`` (default
    ``cuda``); ``updater`` defaults to ``RmsProp(lr=1e-2)``."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater or RmsProp(lr=1e-2))
         .gradient_normalization(GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE, 1.0)
         .layer(GravesLSTM(n_out=hidden))
         .layer(GravesLSTM(n_out=hidden))
         .layer(RnnOutputLayer(n_out=vocab_size, activation="softmax", loss="mcxent"))
         .tbptt(tbptt_length)
         .set_input_type(InputType.recurrent(vocab_size)))
    net = MultiLayerNetwork(b.build(), device=device)
    net.init()
    return net
