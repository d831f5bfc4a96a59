"""GoogLeNet, Inception v1 (mirrors ``deeplearning4j_tpu/models/googlenet.py``):
inception modules of four branches (1x1, 1x1 → 3x3, 1x1 → 5x5, max pool →
1x1) merged on the channel axis; no auxiliary heads.  Like the
reference's, the function returns the graph without parameters: call
``init()``."""

from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.graph import ComputationGraph, GraphBuilder, MergeVertex
from ..nn.layers import (Convolution2D, DropoutLayer, GlobalPooling,
                         LocalResponseNormalization, OutputLayer, Subsampling2D)
from ..nn.updaters import Adam
from ..utils.device import DeviceLike


def _conv(n_out, kernel, stride=(1, 1)):
    return Convolution2D(n_out=n_out, kernel=kernel, stride=stride, convolution_mode="same",
                         activation="relu")


def _maxpool(stride):
    return Subsampling2D(pooling="max", kernel=(3, 3), stride=stride, convolution_mode="same")


def _inception(b: GraphBuilder, name: str, inp: str,
               n1: int, r3: int, n3: int, r5: int, n5: int, pp: int) -> str:
    """An inception module; the filter counts are the paper's table 1
    columns (#1x1, #3x3 reduce, #3x3, #5x5 reduce, #5x5, pool proj)."""
    b.add_layer(f"{name}_1x1", _conv(n1, (1, 1)), inp)
    b.add_layer(f"{name}_3x3r", _conv(r3, (1, 1)), inp)
    b.add_layer(f"{name}_3x3", _conv(n3, (3, 3)), f"{name}_3x3r")
    b.add_layer(f"{name}_5x5r", _conv(r5, (1, 1)), inp)
    b.add_layer(f"{name}_5x5", _conv(n5, (5, 5)), f"{name}_5x5r")
    b.add_layer(f"{name}_pool", _maxpool((1, 1)), inp)
    b.add_layer(f"{name}_poolp", _conv(pp, (1, 1)), f"{name}_pool")
    b.add_vertex(name, MergeVertex(),
                 f"{name}_1x1", f"{name}_3x3", f"{name}_5x5", f"{name}_poolp")
    return name


def GoogLeNet(height: int = 224, width: int = 224, channels: int = 3,
              num_classes: int = 1000, updater=None,
              device: DeviceLike = None) -> ComputationGraph:
    """GoogLeNet's graph on ``device`` (default ``cuda``), not initialized;
    ``updater`` defaults to ``Adam(lr=1e-3)``."""
    b = (GraphBuilder()
         .seed(12345)
         .updater(updater if updater is not None else Adam(lr=1e-3))
         .add_inputs("in")
         .set_input_types(**{"in": InputType.convolutional(height, width, channels)}))
    b.add_layer("conv1", _conv(64, (7, 7), (2, 2)), "in")
    b.add_layer("pool1", _maxpool((2, 2)), "conv1")
    b.add_layer("lrn1", LocalResponseNormalization(), "pool1")
    b.add_layer("conv2r", _conv(64, (1, 1)), "lrn1")
    b.add_layer("conv2", _conv(192, (3, 3)), "conv2r")
    b.add_layer("lrn2", LocalResponseNormalization(), "conv2")
    b.add_layer("pool2", _maxpool((2, 2)), "lrn2")
    x = _inception(b, "3a", "pool2", 64, 96, 128, 16, 32, 32)
    x = _inception(b, "3b", x, 128, 128, 192, 32, 96, 64)
    b.add_layer("pool3", _maxpool((2, 2)), x)
    x = _inception(b, "4a", "pool3", 192, 96, 208, 16, 48, 64)
    x = _inception(b, "4b", x, 160, 112, 224, 24, 64, 64)
    x = _inception(b, "4c", x, 128, 128, 256, 24, 64, 64)
    x = _inception(b, "4d", x, 112, 144, 288, 32, 64, 64)
    x = _inception(b, "4e", x, 256, 160, 320, 32, 128, 128)
    b.add_layer("pool4", _maxpool((2, 2)), x)
    x = _inception(b, "5a", "pool4", 256, 160, 320, 32, 128, 128)
    x = _inception(b, "5b", x, 384, 192, 384, 48, 128, 128)
    b.add_layer("gap", GlobalPooling(pooling="avg"), x)
    b.add_layer("drop", DropoutLayer(dropout=0.4), "gap")
    b.add_layer("out", OutputLayer(n_out=num_classes, activation="softmax",
                                   loss="mcxent"), "drop")
    b.set_outputs("out")
    return ComputationGraph(b.build(), device=device)
