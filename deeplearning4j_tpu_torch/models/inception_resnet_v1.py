"""Inception-ResNet-v1, the FaceNet backbone (mirrors
``deeplearning4j_tpu/models/inception_resnet_v1.py``): the stem, A/B/C
inception-resnet blocks (parallel conv branches → a linear 1x1 conv →
``ScaleVertex`` → residual add → relu) with reductions A and B between
them, then average pooling, dropout 0.2, a 128-d embedding, L2
normalization and a ``CenterLossOutputLayer``.  Block counts default to
the paper's 5/10/5.  Returns the graph without parameters: call
``init()``."""

from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.graph import (ComputationGraph, ElementWiseVertex, GraphBuilder, L2NormalizeVertex,
                        MergeVertex, ScaleVertex)
from ..nn.layers import (ActivationLayer, CenterLossOutputLayer, Convolution2D, Dense,
                         DropoutLayer, GlobalPooling, Subsampling2D)
from ..nn.updaters import Adam
from ..utils.device import DeviceLike


def _conv(b, name, inp, n_out, kernel, stride=(1, 1), mode="same", act="relu"):
    b.add_layer(name, Convolution2D(n_out=n_out, kernel=kernel, stride=stride,
                                    convolution_mode=mode, activation=act), inp)
    return name


def _res_block(b, name, inp, branches, n_channels, scale):
    """An inception-resnet block: each branch a chain of (n_out, kernel)
    convs, merged, a linear 1x1 up to ``n_channels``, scaled, added to
    the input, relu."""
    outs = []
    for bi, branch in enumerate(branches):
        x = inp
        for li, (n, k) in enumerate(branch):
            x = _conv(b, f"{name}_b{bi}_{li}", x, n, k)
        outs.append(x)
    if len(outs) > 1:
        b.add_vertex(f"{name}_cat", MergeVertex(), *outs)
        cat = f"{name}_cat"
    else:
        cat = outs[0]
    up = _conv(b, f"{name}_up", cat, n_channels, (1, 1), act="identity")
    b.add_vertex(f"{name}_scale", ScaleVertex(factor=scale), up)
    b.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp, f"{name}_scale")
    b.add_layer(name, ActivationLayer(activation="relu"), f"{name}_add")
    return name


def _maxpool(b, name, inp):
    b.add_layer(name, Subsampling2D(pooling="max", kernel=(3, 3), stride=(2, 2),
                                    convolution_mode="same"), inp)


def InceptionResNetV1(height: int = 160, width: int = 160, channels: int = 3,
                      num_classes: int = 1000, embedding_size: int = 128,
                      a_blocks: int = 5, b_blocks: int = 10, c_blocks: int = 5,
                      updater=None, device: DeviceLike = None) -> ComputationGraph:
    """The graph on ``device`` (default ``cuda``), not initialized;
    Adam(1e-3) by default."""
    b = (GraphBuilder()
         .seed(12345)
         .updater(updater if updater is not None else Adam(lr=1e-3))
         .add_inputs("in")
         .set_input_types(**{"in": InputType.convolutional(height, width, channels)}))
    x = _conv(b, "stem1", "in", 32, (3, 3), (2, 2), mode="truncate")
    x = _conv(b, "stem2", x, 32, (3, 3), mode="truncate")
    x = _conv(b, "stem3", x, 64, (3, 3))
    _maxpool(b, "stem_pool", x)
    x = _conv(b, "stem4", "stem_pool", 80, (1, 1))
    x = _conv(b, "stem5", x, 192, (3, 3), mode="truncate")
    x = _conv(b, "stem6", x, 256, (3, 3), (2, 2), mode="same")
    for i in range(a_blocks):          # block35
        x = _res_block(b, f"a{i}", x,
                       [[(32, (1, 1))],
                        [(32, (1, 1)), (32, (3, 3))],
                        [(32, (1, 1)), (32, (3, 3)), (32, (3, 3))]],
                       n_channels=256, scale=0.17)
    _conv(b, "redA_b0", x, 384, (3, 3), (2, 2), mode="same")
    _conv(b, "redA_b1a", x, 192, (1, 1))
    _conv(b, "redA_b1b", "redA_b1a", 192, (3, 3))
    _conv(b, "redA_b1c", "redA_b1b", 256, (3, 3), (2, 2), mode="same")
    _maxpool(b, "redA_pool", x)
    b.add_vertex("redA", MergeVertex(), "redA_b0", "redA_b1c", "redA_pool")
    x = "redA"
    for i in range(b_blocks):          # block17
        x = _res_block(b, f"b{i}", x,
                       [[(128, (1, 1))],
                        [(128, (1, 1)), (128, (1, 7)), (128, (7, 1))]],
                       n_channels=896, scale=0.10)
    _conv(b, "redB_b0a", x, 256, (1, 1))
    _conv(b, "redB_b0b", "redB_b0a", 384, (3, 3), (2, 2), mode="same")
    _conv(b, "redB_b1a", x, 256, (1, 1))
    _conv(b, "redB_b1b", "redB_b1a", 256, (3, 3), (2, 2), mode="same")
    _conv(b, "redB_b2a", x, 256, (1, 1))
    _conv(b, "redB_b2b", "redB_b2a", 256, (3, 3))
    _conv(b, "redB_b2c", "redB_b2b", 256, (3, 3), (2, 2), mode="same")
    _maxpool(b, "redB_pool", x)
    b.add_vertex("redB", MergeVertex(), "redB_b0b", "redB_b1b", "redB_b2c", "redB_pool")
    x = "redB"
    for i in range(c_blocks):          # block8
        x = _res_block(b, f"c{i}", x,
                       [[(192, (1, 1))],
                        [(192, (1, 1)), (192, (1, 3)), (192, (3, 1))]],
                       n_channels=1792, scale=0.20)
    b.add_layer("gap", GlobalPooling(pooling="avg"), x)
    b.add_layer("drop", DropoutLayer(dropout=0.2), "gap")
    b.add_layer("bottleneck", Dense(n_out=embedding_size, activation="identity"), "drop")
    b.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
    b.add_layer("out", CenterLossOutputLayer(n_out=num_classes, activation="softmax"),
                "embeddings")
    b.set_outputs("out")
    return ComputationGraph(b.build(), device=device)
