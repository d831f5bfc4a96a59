from .base import (AUX_LOSS_KEY, CONFIG_REGISTRY, ForwardOut, Layer, config_from_dict,
                   config_to_dict, layer_from_dict, layer_to_dict,
                   register_config, register_layer)
from .feedforward import (RBM, ActivationLayer, AutoEncoder, Dense, DropoutLayer,
                          ElementWiseMultiplication, Embedding, EmbeddingSequence,
                          LossLayer, OutputLayer)
from .convolution import (Convolution1D, Convolution2D, Cropping2D, Deconvolution2D,
                          SeparableConvolution2D, Upsampling1D, Upsampling2D,
                          ZeroPadding1D, ZeroPadding2D)
from .pooling import GlobalPooling, Subsampling1D, Subsampling2D
from .normalization import (BatchNormalization, LayerNorm, LocalResponseNormalization,
                            layer_norm)
from .recurrent import (LSTM, Bidirectional, GravesBidirectionalLSTM, GravesLSTM,
                        LastTimeStep, RnnOutputLayer, SimpleRnn)
from .attention import LearnedSelfAttention, SelfAttention
from .special import CenterLossOutputLayer, FrozenLayer
from .objdetect import Yolo2OutputLayer
from .variational import VariationalAutoencoder
# the dropout, weight-noise, constraint and preprocessor configs register
# here, so a layer's JSON that names one parses
from ..conf import preprocessors, regularizers  # noqa: E402,F401

__all__ = [
    "AUX_LOSS_KEY", "CONFIG_REGISTRY", "ForwardOut", "Layer", "config_from_dict",
    "config_to_dict", "layer_from_dict", "layer_to_dict", "register_config",
    "register_layer", "ActivationLayer", "AutoEncoder", "Dense", "DropoutLayer",
    "ElementWiseMultiplication", "Embedding", "EmbeddingSequence", "LayerNorm",
    "LearnedSelfAttention", "LossLayer", "OutputLayer", "RBM", "SelfAttention",
    "layer_norm",
    "BatchNormalization", "Convolution1D", "Convolution2D", "Cropping2D",
    "Deconvolution2D", "GlobalPooling", "LocalResponseNormalization",
    "SeparableConvolution2D", "Subsampling1D", "Subsampling2D", "Upsampling1D",
    "Upsampling2D", "ZeroPadding1D", "ZeroPadding2D",
    "LSTM", "Bidirectional", "GravesBidirectionalLSTM", "GravesLSTM",
    "LastTimeStep", "RnnOutputLayer", "SimpleRnn",
    "CenterLossOutputLayer", "FrozenLayer", "VariationalAutoencoder", "Yolo2OutputLayer",
]
