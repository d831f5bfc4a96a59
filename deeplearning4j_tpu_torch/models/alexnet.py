"""AlexNet (mirrors ``deeplearning4j_tpu/models/alexnet.py``): Krizhevsky
2012 with LRN, the dl4j-zoo one-tower variant."""

from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.layers import (Convolution2D, Dense, LocalResponseNormalization, OutputLayer,
                         Subsampling2D)
from ..nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
from ..nn.updaters import Nesterovs
from ..utils.device import DeviceLike


def AlexNet(height: int = 224, width: int = 224, channels: int = 3, num_classes: int = 1000,
            seed: int = 42, updater=None, device: DeviceLike = None) -> MultiLayerNetwork:
    """AlexNet, initialized from ``seed`` on ``device`` (default ``cuda``);
    ``updater`` defaults to ``Nesterovs(lr=1e-2, momentum=0.9)``."""
    conf = (NeuralNetConfiguration.builder()
            .seed(seed)
            .updater(updater or Nesterovs(lr=1e-2, momentum=0.9))
            .layer(Convolution2D(n_out=96, kernel=(11, 11), stride=(4, 4),
                                 activation="relu"))
            .layer(LocalResponseNormalization())
            .layer(Subsampling2D(pooling="max", kernel=(3, 3), stride=(2, 2)))
            .layer(Convolution2D(n_out=256, kernel=(5, 5), convolution_mode="same",
                                 activation="relu", bias_init=1.0))
            .layer(LocalResponseNormalization())
            .layer(Subsampling2D(pooling="max", kernel=(3, 3), stride=(2, 2)))
            .layer(Convolution2D(n_out=384, kernel=(3, 3), convolution_mode="same",
                                 activation="relu"))
            .layer(Convolution2D(n_out=384, kernel=(3, 3), convolution_mode="same",
                                 activation="relu", bias_init=1.0))
            .layer(Convolution2D(n_out=256, kernel=(3, 3), convolution_mode="same",
                                 activation="relu", bias_init=1.0))
            .layer(Subsampling2D(pooling="max", kernel=(3, 3), stride=(2, 2)))
            .layer(Dense(n_out=4096, activation="relu", dropout=0.5, bias_init=1.0))
            .layer(Dense(n_out=4096, activation="relu", dropout=0.5, bias_init=1.0))
            .layer(OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(height, width, channels))
            .build())
    net = MultiLayerNetwork(conf, device=device)
    net.init()
    return net
