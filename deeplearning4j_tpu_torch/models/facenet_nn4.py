"""FaceNet NN4-small2, OpenFace's variant (mirrors
``deeplearning4j_tpu/models/facenet_nn4.py``): a conv stem with
BatchNorm and LRN, inception modules 3a-5b whose branches are 1x1 → 3x3,
1x1 → 5x5 and a max or L2 (pnorm) pool, projected through a 1x1 where the
module has a projection and merged bare where it has none, then average
pooling, a 128-d embedding, L2 normalization and a
``CenterLossOutputLayer``.  Like the reference's, the function returns
the graph without parameters: call ``init()``."""

from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.graph import ComputationGraph, GraphBuilder, L2NormalizeVertex, MergeVertex
from ..nn.layers import (BatchNormalization, CenterLossOutputLayer, Convolution2D, Dense,
                         GlobalPooling, LocalResponseNormalization, Subsampling2D)
from ..nn.updaters import Adam
from ..utils.device import DeviceLike


def _conv(b, name, inp, n_out, kernel, stride=(1, 1), act="relu"):
    b.add_layer(name, Convolution2D(n_out=n_out, kernel=kernel, stride=stride,
                                    convolution_mode="same", activation=act), inp)
    return name


def _inception(b, name, inp, r3, n3, s3, r5, n5, pool_kind, pp):
    """1x1 → 3x3 (stride ``s3``), 1x1 → 5x5 when ``n5``, and the pool
    branch, projected through a 1x1 when ``pp`` > 0, else merged bare."""
    outs = []
    x = _conv(b, f"{name}_3x3r", inp, r3, (1, 1))
    outs.append(_conv(b, f"{name}_3x3", x, n3, (3, 3), (s3, s3)))
    if n5 > 0:
        x = _conv(b, f"{name}_5x5r", inp, r5, (1, 1))
        outs.append(_conv(b, f"{name}_5x5", x, n5, (5, 5), (s3, s3)))
    b.add_layer(f"{name}_pool", Subsampling2D(pooling=pool_kind, pnorm=2, kernel=(3, 3),
                                              stride=(s3, s3), convolution_mode="same"), inp)
    if pp > 0:
        outs.append(_conv(b, f"{name}_poolp", f"{name}_pool", pp, (1, 1)))
    else:
        outs.append(f"{name}_pool")
    b.add_vertex(name, MergeVertex(), *outs)
    return name


def FaceNetNN4Small2(height: int = 96, width: int = 96, channels: int = 3,
                     num_classes: int = 1000, embedding_size: int = 128,
                     updater=None, device: DeviceLike = None) -> ComputationGraph:
    """The graph on ``device`` (default ``cuda``), not initialized;
    Adam(1e-3) by default."""
    b = (GraphBuilder()
         .seed(12345)
         .updater(updater if updater is not None else Adam(lr=1e-3))
         .add_inputs("in")
         .set_input_types(**{"in": InputType.convolutional(height, width, channels)}))
    x = _conv(b, "conv1", "in", 64, (7, 7), (2, 2))
    b.add_layer("bn1", BatchNormalization(activation="relu"), x)
    b.add_layer("pool1", Subsampling2D(pooling="max", kernel=(3, 3), stride=(2, 2),
                                       convolution_mode="same"), "bn1")
    b.add_layer("lrn1", LocalResponseNormalization(), "pool1")
    x = _conv(b, "conv2", "lrn1", 64, (1, 1))
    x = _conv(b, "conv3", x, 192, (3, 3))
    b.add_layer("bn3", BatchNormalization(activation="relu"), x)
    b.add_layer("lrn2", LocalResponseNormalization(), "bn3")
    b.add_layer("pool2", Subsampling2D(pooling="max", kernel=(3, 3), stride=(2, 2),
                                       convolution_mode="same"), "lrn2")
    # (r3, n3, stride, r5, n5, pool, projection)
    x = _inception(b, "3a", "pool2", 96, 128, 1, 16, 32, "max", 32)
    x = _inception(b, "3b", x, 96, 128, 1, 32, 64, "pnorm", 64)
    x = _inception(b, "3c", x, 128, 256, 2, 32, 64, "max", 0)
    x = _inception(b, "4a", x, 96, 192, 1, 32, 64, "pnorm", 128)
    x = _inception(b, "4e", x, 160, 256, 2, 64, 128, "max", 0)
    x = _inception(b, "5a", x, 96, 384, 1, 0, 0, "pnorm", 96)
    x = _inception(b, "5b", x, 96, 384, 1, 0, 0, "max", 96)
    b.add_layer("gap", GlobalPooling(pooling="avg"), x)
    b.add_layer("bottleneck", Dense(n_out=embedding_size, activation="identity"), "gap")
    b.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
    b.add_layer("out", CenterLossOutputLayer(n_out=num_classes, activation="softmax"),
                "embeddings")
    b.set_outputs("out")
    return ComputationGraph(b.build(), device=device)
