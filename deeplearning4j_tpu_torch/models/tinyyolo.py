"""TinyYOLO (mirrors ``deeplearning4j_tpu/models/tinyyolo.py``): tiny
YOLOv2 (darknet's ``tiny-yolo-voc.cfg``) — 9 convolutions, 8 of them
with BatchNorm and leaky relu, 6 max pools (the last of stride 1, so
416 → 13), a 1x1 head of B·(5 + C) channels and ``Yolo2OutputLayer``
with the VOC anchors."""

from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.layers import BatchNormalization, Convolution2D, Subsampling2D, Yolo2OutputLayer
from ..nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
from ..nn.updaters import Adam
from ..utils.device import DeviceLike

_DEFAULT_ANCHORS = [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11], [16.62, 10.52]]


def TinyYOLO(height: int = 416, width: int = 416, channels: int = 3,
             num_classes: int = 20, anchors=None, seed: int = 42,
             updater=None, device: DeviceLike = None) -> MultiLayerNetwork:
    """TinyYOLO on ``device`` (default ``cuda``), initialized; Adam(1e-3)
    by default."""
    anchors = anchors if anchors is not None else _DEFAULT_ANCHORS
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater or Adam(lr=1e-3)))
    for i, n_out in enumerate((16, 32, 64, 128, 256, 512)):
        b.layer(Convolution2D(n_out=n_out, kernel=(3, 3), convolution_mode="same",
                              activation="identity", has_bias=False))
        b.layer(BatchNormalization(activation="leakyrelu"))
        stride = 2 if i < 5 else 1
        b.layer(Subsampling2D(pooling="max", kernel=(2, 2), stride=(stride, stride),
                              convolution_mode="same"))
    for n_out in (1024, 1024):
        b.layer(Convolution2D(n_out=n_out, kernel=(3, 3), convolution_mode="same",
                              activation="identity", has_bias=False))
        b.layer(BatchNormalization(activation="leakyrelu"))
    b.layer(Convolution2D(n_out=len(anchors) * (5 + num_classes), kernel=(1, 1),
                          convolution_mode="same", activation="identity"))
    b.layer(Yolo2OutputLayer(anchors=anchors, n_classes=num_classes))
    b.set_input_type(InputType.convolutional(height, width, channels))
    net = MultiLayerNetwork(b.build(), device=device)
    net.init()
    return net
