"""LeNet (mirrors ``deeplearning4j_tpu/models/lenet.py``): conv 5x5 → max
pool → conv 5x5 → max pool → dense 500 → softmax, the dl4j-zoo variant."""

from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.layers import Convolution2D, Dense, OutputLayer, Subsampling2D
from ..nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
from ..nn.updaters import Adam
from ..utils.device import DeviceLike


def LeNet(height: int = 28, width: int = 28, channels: int = 1, num_classes: int = 10,
          seed: int = 123, updater=None, device: DeviceLike = None) -> MultiLayerNetwork:
    """LeNet, initialized from ``seed`` on ``device`` (default ``cuda``);
    ``updater`` defaults to ``Adam(lr=1e-3)``."""
    conf = (NeuralNetConfiguration.builder()
            .seed(seed)
            .updater(updater or Adam(lr=1e-3))
            .layer(Convolution2D(n_out=20, kernel=(5, 5), stride=(1, 1),
                                 activation="identity", convolution_mode="same"))
            .layer(Subsampling2D(pooling="max", kernel=(2, 2), stride=(2, 2)))
            .layer(Convolution2D(n_out=50, kernel=(5, 5), stride=(1, 1),
                                 activation="identity", convolution_mode="same"))
            .layer(Subsampling2D(pooling="max", kernel=(2, 2), stride=(2, 2)))
            .layer(Dense(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(height, width, channels))
            .build())
    net = MultiLayerNetwork(conf, device=device)
    net.init()
    return net
