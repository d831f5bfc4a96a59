"""Darknet19 (mirrors ``deeplearning4j_tpu/models/darknet19.py``): the
YOLOv2 backbone, 19 conv layers with BatchNorm and leaky relu, 5 max
pools, global average pooling and a softmax head."""

from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.layers import (BatchNormalization, Convolution2D, GlobalPooling, OutputLayer,
                         Subsampling2D)
from ..nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
from ..nn.updaters import Nesterovs
from ..utils.device import DeviceLike


def _cbl(b, n_out, kernel=(3, 3)):
    b.layer(Convolution2D(n_out=n_out, kernel=kernel, convolution_mode="same",
                          activation="identity", has_bias=False))
    b.layer(BatchNormalization(activation="leakyrelu"))


def _pool(b):
    b.layer(Subsampling2D(pooling="max", kernel=(2, 2), stride=(2, 2)))


def Darknet19(height: int = 224, width: int = 224, channels: int = 3,
              num_classes: int = 1000, seed: int = 42, updater=None,
              device: DeviceLike = None) -> MultiLayerNetwork:
    """Darknet19 on ``device`` (default ``cuda``), Nesterovs(1e-3, 0.9) by
    default."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater or Nesterovs(lr=1e-3, momentum=0.9)))
    _cbl(b, 32)
    _pool(b)
    _cbl(b, 64)
    _pool(b)
    for n in (128, 64, 128):
        _cbl(b, n, (1, 1) if n == 64 else (3, 3))
    _pool(b)
    for n in (256, 128, 256):
        _cbl(b, n, (1, 1) if n == 128 else (3, 3))
    _pool(b)
    for n in (512, 256, 512, 256, 512):
        _cbl(b, n, (1, 1) if n == 256 else (3, 3))
    _pool(b)
    for n in (1024, 512, 1024, 512, 1024):
        _cbl(b, n, (1, 1) if n == 512 else (3, 3))
    b.layer(Convolution2D(n_out=num_classes, kernel=(1, 1), convolution_mode="same",
                          activation="identity"))
    b.layer(GlobalPooling(pooling="avg"))
    b.layer(OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"))
    b.set_input_type(InputType.convolutional(height, width, channels))
    net = MultiLayerNetwork(b.build(), device=device)
    net.init()
    return net
