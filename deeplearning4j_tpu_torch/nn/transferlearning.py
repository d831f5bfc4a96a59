"""Transfer learning: surgery on a trained network (mirrors
``deeplearning4j_tpu/nn/transferlearning.py``).

Parameters are per-layer dicts, so the surgery is structural: freezing
wraps a layer's configuration in ``FrozenLayer`` (same parameter tree,
zero gradient), and replaced or appended layers are drawn fresh.  The
new network lives on the source network's device; its updater state is
fresh, so a frozen layer's update is exactly zero.
"""

from __future__ import annotations

import copy
from typing import List, Optional

from ..datasets.dataset import DataSet
from .layers.base import Layer
from .layers.special import FrozenLayer
from .multilayer import MultiLayerNetwork


class TransferLearning:
    """Builder for network surgery (the reference's TransferLearning.Builder).

    >>> new_net = (TransferLearning(trained)
    ...            .fine_tune_configuration(updater=Adam(lr=1e-4))
    ...            .set_feature_extractor(1)        # freeze layers 0..1
    ...            .remove_output_layer()
    ...            .add_layer(OutputLayer(n_out=5, activation="softmax"))
    ...            .build())
    """

    def __init__(self, net: MultiLayerNetwork):
        self._src = net
        self._conf = copy.deepcopy(net.conf)
        self._params = [dict(p) for p in net.params]
        self._state = [dict(s) for s in net.state]
        self._freeze_upto: Optional[int] = None
        self._appended: List[Layer] = []
        self._removed = 0
        self._nout_replace: Optional[tuple] = None

    def fine_tune_configuration(self, updater=None, seed: Optional[int] = None,
                                **conf_overrides) -> "TransferLearning":
        """Override the global training configuration (the reference's
        FineTuneConfiguration)."""
        if updater is not None:
            self._conf.updater = updater
        if seed is not None:
            self._conf.seed = seed
        for k, v in conf_overrides.items():
            if not hasattr(self._conf, k):
                raise ValueError(f"unknown conf field '{k}'")
            setattr(self._conf, k, v)
        return self

    def set_feature_extractor(self, layer_index: int) -> "TransferLearning":
        """Freeze layers [0, layer_index]."""
        self._freeze_upto = layer_index
        return self

    def remove_output_layer(self) -> "TransferLearning":
        return self.remove_last_layers(1)

    def remove_last_layers(self, n: int) -> "TransferLearning":
        self._removed += n
        return self

    def add_layer(self, layer: Layer) -> "TransferLearning":
        self._appended.append(layer)
        return self

    def n_out_replace(self, layer_index: int, n_out: int,
                      weight_init: str = "xavier") -> "TransferLearning":
        """Change a layer's n_out and draw it and the next layer afresh."""
        self._nout_replace = (layer_index, n_out, weight_init)
        return self

    def build(self) -> MultiLayerNetwork:
        conf, params, state = self._conf, self._params, self._state
        if self._removed:
            conf.layers = conf.layers[:-self._removed]
            params = params[:-self._removed]
            state = state[:-self._removed]
            for i in list(conf.preprocessors):
                if i >= len(conf.layers):
                    del conf.preprocessors[i]
        n_carried = len(conf.layers)
        conf.layers = conf.layers + list(self._appended)
        if self._nout_replace is not None:
            idx, n_out, winit = self._nout_replace
            conf.layers[idx].n_out = n_out
            conf.layers[idx].weight_init = winit
            conf.layers[idx].n_in = 0
            if idx + 1 < len(conf.layers) and hasattr(conf.layers[idx + 1], "n_in"):
                conf.layers[idx + 1].n_in = 0
        if self._freeze_upto is not None:
            for i in range(self._freeze_upto + 1):
                if not isinstance(conf.layers[i], FrozenLayer):
                    conf.layers[i] = FrozenLayer(layer=conf.layers[i])
        net = MultiLayerNetwork(conf, device=self._src.device)
        net.init()
        reinit = set()
        if self._nout_replace is not None:
            reinit = {self._nout_replace[0], self._nout_replace[0] + 1}
        for i in range(min(n_carried, len(conf.layers))):
            if i not in reinit and params[i]:
                net.params[i] = params[i]
                net.state[i] = state[i]
        return net


class TransferLearningHelper:
    """Featurization (the reference's TransferLearningHelper): the frozen
    front runs once per batch, and only the layers after ``frozen_upto``
    train, as a network of their own that shares the full network's
    parameter dicts."""

    def __init__(self, net: MultiLayerNetwork, frozen_upto: int):
        self.full = net
        self.frozen_upto = frozen_upto
        tail_conf = copy.deepcopy(net.conf)
        tail_conf.layers = net.conf.layers[frozen_upto + 1:]
        tail_conf.preprocessors = {
            i - (frozen_upto + 1): p for i, p in net.conf.preprocessors.items()
            if i > frozen_upto}
        # the tail's input is the OUTPUT type of layer frozen_upto, before
        # any preprocessor: the carried preprocessor at tail index 0 applies
        # its transform, and featurize() emits raw activations
        if frozen_upto + 1 < len(net.input_types):
            tail_conf.input_type = net.conf.layers[frozen_upto].output_type(
                net.input_types[frozen_upto])
        else:
            tail_conf.input_type = net.output_type
        self.tail = MultiLayerNetwork(tail_conf, device=net.device)
        self.tail.init()
        self.tail.params = net.params[frozen_upto + 1:]
        self.tail.state = net.state[frozen_upto + 1:]

    def featurize(self, ds: DataSet) -> DataSet:
        """The batch's features through the frozen front (tensors on the
        device), its labels and masks as they were."""
        acts = self.full.feed_forward(ds.features)
        return DataSet(acts[self.frozen_upto], ds.labels, ds.features_mask, ds.labels_mask)

    def fit_featurized(self, ds: DataSet, epochs: int = 1):
        """Train the tail on featurized batches; its parameters and state
        are written back into the full network."""
        losses = self.tail.fit(ds, epochs=epochs)
        for j, p in enumerate(self.tail.params):
            self.full.params[self.frozen_upto + 1 + j] = p
            self.full.state[self.frozen_upto + 1 + j] = self.tail.state[j]
        return losses

    def output(self, x):
        return self.full.output(x)
