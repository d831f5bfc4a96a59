"""ResNet-50 (mirrors ``deeplearning4j_tpu/models/resnet50.py``), the
repository's benchmarked CNN: conv 7x7 / 2 → max pool 3x3 / 2 → four
stages of bottleneck blocks [3, 4, 6, 3] → global average pool → softmax,
as a ComputationGraph with ``ElementWiseVertex(add)`` residuals: 53
conv + BatchNorm pairs (no conv bias), 16 residual adds."""

from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.graph import ComputationGraph, ElementWiseVertex, GraphBuilder
from ..nn.layers import (ActivationLayer, BatchNormalization, Convolution2D, GlobalPooling,
                         OutputLayer, Subsampling2D)
from ..nn.updaters import Adam
from ..utils.device import DeviceLike


def _conv_bn(b: GraphBuilder, name: str, inp: str, n_out: int, kernel, stride,
             mode="same", act="relu") -> str:
    b.add_layer(f"{name}_conv", Convolution2D(n_out=n_out, kernel=kernel, stride=stride,
                                              convolution_mode=mode, activation="identity",
                                              has_bias=False), inp)
    b.add_layer(f"{name}_bn", BatchNormalization(activation=act), f"{name}_conv")
    return f"{name}_bn"


def _bottleneck(b: GraphBuilder, name: str, inp: str, filters, stride=1) -> str:
    """1x1 reduce → 3x3 → 1x1 expand, with a projection shortcut in the
    first block of each stage."""
    f1, f2, f3 = filters
    x = _conv_bn(b, f"{name}_a", inp, f1, (1, 1), (stride, stride))
    x = _conv_bn(b, f"{name}_b", x, f2, (3, 3), (1, 1))
    x = _conv_bn(b, f"{name}_c", x, f3, (1, 1), (1, 1), act="identity")
    shortcut = inp
    if stride != 1 or name.endswith("block1"):
        shortcut = _conv_bn(b, f"{name}_sc", inp, f3, (1, 1), (stride, stride),
                            act="identity")
    b.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, shortcut)
    b.add_layer(f"{name}_relu", ActivationLayer(activation="relu"), f"{name}_add")
    return f"{name}_relu"


def ResNet50(height: int = 224, width: int = 224, channels: int = 3,
             num_classes: int = 1000, seed: int = 42, updater=None,
             device: DeviceLike = None) -> ComputationGraph:
    """ResNet-50, initialized from ``seed`` on ``device`` (default
    ``cuda``); ``updater`` defaults to ``Adam(lr=1e-3)``."""
    b = (GraphBuilder()
         .seed(seed)
         .updater(updater or Adam(lr=1e-3))
         .add_inputs("in")
         .set_input_types(**{"in": InputType.convolutional(height, width, channels)}))
    x = _conv_bn(b, "stem", "in", 64, (7, 7), (2, 2))
    b.add_layer("stem_pool", Subsampling2D(pooling="max", kernel=(3, 3), stride=(2, 2),
                                           convolution_mode="same"), x)
    x = "stem_pool"
    stages = [("stage1", [64, 64, 256], 3, 1), ("stage2", [128, 128, 512], 4, 2),
              ("stage3", [256, 256, 1024], 6, 2), ("stage4", [512, 512, 2048], 3, 2)]
    for sname, filters, blocks, first_stride in stages:
        for i in range(1, blocks + 1):
            x = _bottleneck(b, f"{sname}_block{i}", x, filters,
                            stride=first_stride if i == 1 else 1)
    b.add_layer("avgpool", GlobalPooling(pooling="avg"), x)
    b.add_layer("out", OutputLayer(n_out=num_classes, activation="softmax",
                                   loss="mcxent"), "avgpool")
    b.set_outputs("out")
    net = ComputationGraph(b.build(), device=device)
    net.init()
    return net
