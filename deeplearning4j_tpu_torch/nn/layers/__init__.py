from .base import (CONFIG_REGISTRY, ForwardOut, Layer, config_from_dict,
                   config_to_dict, layer_from_dict, layer_to_dict,
                   register_config, register_layer)
from .feedforward import Dense, Embedding, EmbeddingSequence, LossLayer, OutputLayer
from .normalization import layer_norm
from .recurrent import (LSTM, Bidirectional, GravesBidirectionalLSTM, GravesLSTM,
                        LastTimeStep, RnnOutputLayer, SimpleRnn)

__all__ = [
    "CONFIG_REGISTRY", "ForwardOut", "Layer", "config_from_dict",
    "config_to_dict", "layer_from_dict", "layer_to_dict", "register_config",
    "register_layer", "Dense", "Embedding", "EmbeddingSequence", "LossLayer",
    "OutputLayer", "layer_norm",
    "LSTM", "Bidirectional", "GravesBidirectionalLSTM", "GravesLSTM",
    "LastTimeStep", "RnnOutputLayer", "SimpleRnn",
]
