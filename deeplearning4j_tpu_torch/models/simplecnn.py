"""SimpleCNN (mirrors ``deeplearning4j_tpu/models/simplecnn.py``): four
conv → BatchNorm → max-pool blocks and a dropout head, for small imagery."""

from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.layers import BatchNormalization, Convolution2D, Dense, OutputLayer, Subsampling2D
from ..nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
from ..nn.updaters import Adam
from ..utils.device import DeviceLike


def SimpleCNN(height: int = 48, width: int = 48, channels: int = 3, num_classes: int = 10,
              seed: int = 123, updater=None, device: DeviceLike = None) -> MultiLayerNetwork:
    """SimpleCNN, initialized from ``seed`` on ``device`` (default
    ``cuda``); ``updater`` defaults to ``Adam(lr=1e-3)``."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater or Adam(lr=1e-3)))
    for n_out in (16, 32, 64, 128):
        b.layer(Convolution2D(n_out=n_out, kernel=(3, 3), activation="relu",
                              convolution_mode="same"))
        b.layer(BatchNormalization())
        b.layer(Subsampling2D(pooling="max", kernel=(2, 2), stride=(2, 2)))
    b.layer(Dense(n_out=256, activation="relu", dropout=0.5))
    b.layer(OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"))
    b.set_input_type(InputType.convolutional(height, width, channels))
    net = MultiLayerNetwork(b.build(), device=device)
    net.init()
    return net
