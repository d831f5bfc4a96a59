"""VGG16 / VGG19 (mirrors ``deeplearning4j_tpu/models/vgg.py``): Simonyan
and Zisserman 2014, configurations D and E."""

from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.layers import Convolution2D, Dense, OutputLayer, Subsampling2D
from ..nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
from ..nn.updaters import Nesterovs
from ..utils.device import DeviceLike


def _vgg(block_convs, height, width, channels, num_classes, seed, updater, device):
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater or Nesterovs(lr=1e-2, momentum=0.9)))
    for n_out, reps in block_convs:
        for _ in range(reps):
            b.layer(Convolution2D(n_out=n_out, kernel=(3, 3), convolution_mode="same",
                                  activation="relu"))
        b.layer(Subsampling2D(pooling="max", kernel=(2, 2), stride=(2, 2)))
    b.layer(Dense(n_out=4096, activation="relu", dropout=0.5))
    b.layer(Dense(n_out=4096, activation="relu", dropout=0.5))
    b.layer(OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"))
    b.set_input_type(InputType.convolutional(height, width, channels))
    net = MultiLayerNetwork(b.build(), device=device)
    net.init()
    return net


def VGG16(height: int = 224, width: int = 224, channels: int = 3, num_classes: int = 1000,
          seed: int = 42, updater=None, device: DeviceLike = None) -> MultiLayerNetwork:
    """VGG16 on ``device`` (default ``cuda``), Nesterovs(1e-2, 0.9) by default."""
    return _vgg([(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)],
                height, width, channels, num_classes, seed, updater, device)


def VGG19(height: int = 224, width: int = 224, channels: int = 3, num_classes: int = 1000,
          seed: int = 42, updater=None, device: DeviceLike = None) -> MultiLayerNetwork:
    """VGG19 on ``device`` (default ``cuda``), Nesterovs(1e-2, 0.9) by default."""
    return _vgg([(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)],
                height, width, channels, num_classes, seed, updater, device)
