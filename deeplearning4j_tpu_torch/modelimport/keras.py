"""Keras HDF5 model import (the port of
``deeplearning4j_tpu/modelimport/keras.py``).

Parity targets in the reference (deeplearning4j-modelimport):
  KerasModelImport.java:41-269   — entry points (Sequential / functional)
  Hdf5Archive.java:22-24         — HDF5 traversal (h5py here)
  KerasModel.java / KerasSequentialModel.java — config parsing
  keras/layers/*                 — per-layer mappers (30+ classes)
  KerasLayerUtils.java           — activation / init name translation

The port keeps the reference package's layouts: Keras's HWIO conv kernels
and [in, out] dense kernels go into ``params`` as they are (the port's
layers are NHWC/HWIO too); only the LSTM gate order changes (Keras
[i,f,c,o] against the fused [i,f,o,g]) and Conv2DTranspose's kernel is
transposed and flipped.  Weights become tensors on the network's device
(``cuda`` unless ``device="cpu"`` is passed).

Every ``h5py`` call sits inside :class:`Hdf5Archive`; the stages after the
read (config mapping, weight layouts, the network they build) take any
object with its read methods (``has_attr``, ``read_attr_as_json``,
``has_group``, ``layer_weights``), so they also run where ``h5py`` is
not installed, from a config and arrays held in memory.

Supports the Keras 2.x save format (the `model_config` root attribute plus
a `model_weights` group; files with weight groups at the file root are also
handled) and the Keras 1.x Sequential config-list format.  Architecture
import requires a full-model file — `save_weights`-only files carry no
`model_config` and are rejected with a clear error.  `channels_first`
models are rejected explicitly, mirroring the reference's
unsupported-config errors (InvalidKerasConfigurationException).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..nn.conf.inputs import InputType
from ..nn.conf.preprocessors import CnnToFeedForward
from ..nn.graph import (
    ComputationGraph,
    ElementWiseVertex,
    GraphBuilder,
    LastTimeStepVertex,
    MergeVertex,
    PreprocessorVertex,
)
from ..nn.layers import (
    ActivationLayer,
    BatchNormalization,
    Convolution1D,
    Convolution2D,
    Cropping2D,
    Deconvolution2D,
    Dense,
    DropoutLayer,
    EmbeddingSequence,
    GlobalPooling,
    LSTM,
    LastTimeStep,
    LayerNorm,
    LossLayer,
    OutputLayer,
    SeparableConvolution2D,
    SimpleRnn,
    Subsampling1D,
    Subsampling2D,
    Upsampling2D,
    ZeroPadding1D,
    ZeroPadding2D,
)
from ..nn.layers.base import Layer
from ..nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
from ..ops.dtypes import canonical_dtype
from ..utils.device import DeviceLike


class InvalidKerasConfigurationException(ValueError):
    """Mirror of the reference's exceptions/InvalidKerasConfigurationException."""


# ---------------------------------------------------------------------------
# HDF5 traversal (Hdf5Archive.java parity, via h5py)
# ---------------------------------------------------------------------------


def _to_str(v: Any) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8")
    return str(v)


class Hdf5Archive:
    """Thin h5py wrapper matching the reference's Hdf5Archive surface:
    read root/group attributes as JSON or strings, list + read datasets."""

    def __init__(self, path: str):
        import h5py

        self._f = h5py.File(path, "r")

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "Hdf5Archive":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def has_attr(self, name: str, group: Optional[str] = None) -> bool:
        g = self._f[group] if group else self._f
        return name in g.attrs

    def read_attr_as_string(self, name: str, group: Optional[str] = None) -> str:
        g = self._f[group] if group else self._f
        return _to_str(g.attrs[name])

    def read_attr_as_json(self, name: str, group: Optional[str] = None) -> Any:
        return json.loads(self.read_attr_as_string(name, group))

    def read_string_list_attr(self, name: str, group: Optional[str] = None) -> List[str]:
        g = self._f[group] if group else self._f
        return [_to_str(v) for v in g.attrs[name]]

    def group(self, path: str):
        return self._f[path]

    def has_group(self, path: str) -> bool:
        return path in self._f

    def layer_weights(self, root: str, layer_name: str) -> Dict[str, np.ndarray]:
        """{short weight name: array} for one Keras layer group."""
        import h5py

        base = f"{root}/{layer_name}" if root != "/" else layer_name
        if not self.has_group(base):
            return {}
        out: Dict[str, np.ndarray] = {}

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                short = name.split("/")[-1]
                short = short.split(":")[0]  # strip ':0' tensor suffix
                out[short] = np.asarray(obj)

        self.group(base).visititems(visit)
        return out


# ---------------------------------------------------------------------------
# name translation (KerasLayerUtils / KerasActivationUtils parity)
# ---------------------------------------------------------------------------

_ACTIVATIONS = {
    "linear": "identity",
    "relu": "relu",
    "relu6": "relu6",
    "sigmoid": "sigmoid",
    "hard_sigmoid": "hardsigmoid",
    "tanh": "tanh",
    "softmax": "softmax",
    "softplus": "softplus",
    "softsign": "softsign",
    "elu": "elu",
    "selu": "selu",
    "swish": "swish",
    "silu": "swish",
    "gelu": "gelu",
    "leaky_relu": "leakyrelu",
    "mish": "mish",
}

_INITIALIZERS = {
    "glorot_uniform": "xavier_uniform",
    "glorot_normal": "xavier",
    "he_uniform": "relu_uniform",
    "he_normal": "relu",
    "lecun_uniform": "lecun_uniform",
    "lecun_normal": "lecun_normal",
    "zeros": "zero",
    "ones": "ones",
    "random_uniform": "uniform",
    "random_normal": "normal",
    "uniform": "uniform",
    "normal": "normal",
    "identity": "identity",
    "variance_scaling": "var_scaling",
}

_LOSSES = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse",
    "mse": "mse",
    "mean_absolute_error": "mae",
    "mae": "mae",
    "mean_absolute_percentage_error": "mape",
    "mean_squared_logarithmic_error": "msle",
    "squared_hinge": "squared_hinge",
    "hinge": "hinge",
    "poisson": "poisson",
    "cosine_proximity": "cosine_proximity",
    "kullback_leibler_divergence": "kl_divergence",
}


def map_activation(name: str) -> str:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise InvalidKerasConfigurationException(f"unsupported Keras activation: {name}")


def map_initializer(cfg: Any) -> Optional[str]:
    """Keras 2 initializers are {'class_name', 'config'} dicts; 1.x strings."""
    if cfg is None:
        return None
    name = cfg.get("class_name") if isinstance(cfg, dict) else cfg
    if name is None:
        return None
    # normalize CamelCase class names (GlorotUniform → glorot_uniform)
    s = "".join("_" + c.lower() if c.isupper() else c for c in str(name)).lstrip("_")
    return _INITIALIZERS.get(s)


def map_loss(name: str) -> str:
    from ..ops.losses import get_loss

    mapped = _LOSSES.get(name)
    if mapped is None:
        raise InvalidKerasConfigurationException(f"unsupported Keras loss: {name}")
    get_loss(mapped)  # raise early if our registry lacks it
    return mapped


def _check_data_format(cfg: dict, name: str) -> None:
    fmt = cfg.get("data_format", "channels_last")
    if fmt == "channels_first":
        raise InvalidKerasConfigurationException(
            f"layer {name}: data_format=channels_first is not supported "
            "(this framework is natively NHWC / channels_last)")


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _conv_mode(padding: str) -> str:
    if padding == "same":
        return "same"
    if padding == "valid":
        return "truncate"
    raise InvalidKerasConfigurationException(f"unsupported Keras padding: {padding}")


# ---------------------------------------------------------------------------
# per-layer mappers (keras/layers/* parity)
# ---------------------------------------------------------------------------

# A mapper returns (layer_or_None, input_type_or_None).  None layer means
# "structural only" (InputLayer/Flatten/Dropout-less etc. handled by caller).


def _common(layer: Layer, cfg: dict) -> Layer:
    layer.name = cfg.get("name")
    init = map_initializer(cfg.get("kernel_initializer") or cfg.get("init"))
    if init:
        layer.weight_init = init
    act = cfg.get("activation")
    if act is not None:
        layer.activation = map_activation(act)
    return layer


def _map_dense(cfg: dict) -> Layer:
    return _common(Dense(n_out=int(cfg["units"]),
                         has_bias=bool(cfg.get("use_bias", True))), cfg)


def _map_conv2d(cfg: dict) -> Layer:
    _check_data_format(cfg, cfg.get("name", "conv2d"))
    if "kernel_size" in cfg:
        kernel = _pair(cfg["kernel_size"])
    else:  # Keras 1.x: separate nb_row / nb_col
        kernel = (int(cfg.get("nb_row", 3)), int(cfg.get("nb_col", 3)))
    return _common(Convolution2D(
        n_out=int(cfg.get("filters", cfg.get("nb_filter", 0))),
        kernel=kernel,
        stride=_pair(cfg.get("strides", (1, 1))),
        dilation=_pair(cfg.get("dilation_rate", (1, 1))),
        convolution_mode=_conv_mode(cfg.get("padding", cfg.get("border_mode", "valid"))),
        has_bias=bool(cfg.get("use_bias", True)),
    ), cfg)


def _map_conv2d_transpose(cfg: dict) -> Layer:
    """Keras Conv2DTranspose / 1.x Deconvolution2D → Deconvolution2D.
    Weight conversion happens in _set_layer_params (keras stores
    [kh,kw,out,in] and tf.nn.conv2d_transpose spatially flips; our layer
    runs lax.conv_transpose over an HWIO kernel without flipping)."""
    _check_data_format(cfg, cfg.get("name", "conv2d_transpose"))
    op = cfg.get("output_padding")
    if op is not None and any(int(v) != 0 for v in
                              (op if isinstance(op, (list, tuple)) else (op,))):
        raise InvalidKerasConfigurationException(
            f"Conv2DTranspose '{cfg.get('name')}': output_padding={op} is "
            "not supported (the imported layer's output shape would "
            "silently diverge from the source model)")
    if "kernel_size" in cfg:
        kernel = _pair(cfg["kernel_size"])
    else:  # Keras 1.x
        kernel = (int(cfg.get("nb_row", 3)), int(cfg.get("nb_col", 3)))
    return _common(Deconvolution2D(
        n_out=int(cfg.get("filters", cfg.get("nb_filter", 0))),
        kernel=kernel,
        stride=_pair(cfg.get("strides", cfg.get("subsample", (1, 1)))),
        dilation=_pair(cfg.get("dilation_rate", (1, 1))),
        convolution_mode=_conv_mode(cfg.get("padding", cfg.get("border_mode", "valid"))),
        has_bias=bool(cfg.get("use_bias", True)),
    ), cfg)


def _map_zeropad1d(cfg: dict) -> Layer:
    p = cfg.get("padding", 1)
    pad = (int(p), int(p)) if isinstance(p, int) else (int(p[0]), int(p[1]))
    layer = ZeroPadding1D(padding=pad)
    layer.name = cfg.get("name")
    return layer


def _map_cropping2d(cfg: dict) -> Layer:
    _check_data_format(cfg, cfg.get("name", "cropping2d"))
    c = cfg.get("cropping", ((0, 0), (0, 0)))
    if isinstance(c, int):
        crop = (c, c, c, c)
    elif isinstance(c[0], (list, tuple)):
        crop = (int(c[0][0]), int(c[0][1]), int(c[1][0]), int(c[1][1]))
    else:  # (sym_h, sym_w)
        crop = (int(c[0]), int(c[0]), int(c[1]), int(c[1]))
    layer = Cropping2D(cropping=crop)
    layer.name = cfg.get("name")
    return layer


def _map_separable_conv2d(cfg: dict) -> Layer:
    _check_data_format(cfg, cfg.get("name", "separable_conv2d"))
    if "kernel_size" in cfg:
        kernel = _pair(cfg["kernel_size"])
    else:  # Keras 1.x: separate nb_row / nb_col
        kernel = (int(cfg.get("nb_row", 3)), int(cfg.get("nb_col", 3)))
    return _common(SeparableConvolution2D(
        n_out=int(cfg.get("filters", cfg.get("nb_filter", 0))),
        kernel=kernel,
        stride=_pair(cfg.get("strides", cfg.get("subsample", (1, 1)))),
        dilation=_pair(cfg.get("dilation_rate", (1, 1))),
        convolution_mode=_conv_mode(cfg.get("padding",
                                            cfg.get("border_mode", "valid"))),
        depth_multiplier=int(cfg.get("depth_multiplier", 1)),
        has_bias=bool(cfg.get("use_bias", True)),
    ), cfg)


def _map_conv1d(cfg: dict) -> Layer:
    _check_data_format(cfg, cfg.get("name", "conv1d"))
    return _common(Convolution1D(
        n_out=int(cfg["filters"]),
        kernel=int(cfg["kernel_size"][0] if isinstance(cfg.get("kernel_size"), (list, tuple))
                   else cfg.get("kernel_size", 3)),
        stride=int(cfg.get("strides", [1])[0] if isinstance(cfg.get("strides"), (list, tuple))
                   else cfg.get("strides", 1)),
        convolution_mode=_conv_mode(cfg.get("padding", "valid")),
        has_bias=bool(cfg.get("use_bias", True)),
    ), cfg)


def _map_pool2d(cfg: dict, kind: str) -> Layer:
    _check_data_format(cfg, cfg.get("name", "pool"))
    pool = Subsampling2D(
        pooling=kind,
        kernel=_pair(cfg.get("pool_size", (2, 2))),
        stride=_pair(cfg.get("strides") or cfg.get("pool_size", (2, 2))),
        convolution_mode=_conv_mode(cfg.get("padding", cfg.get("border_mode", "valid"))),
    )
    pool.name = cfg.get("name")
    return pool


def _map_pool1d(cfg: dict, kind: str) -> Layer:
    _check_data_format(cfg, cfg.get("name", "pool1d"))
    k = cfg.get("pool_size", 2)
    k = int(k[0]) if isinstance(k, (list, tuple)) else int(k)
    s = cfg.get("strides") or k
    s = int(s[0]) if isinstance(s, (list, tuple)) else int(s)
    pool = Subsampling1D(pooling=kind, kernel=k, stride=s,
                         convolution_mode=_conv_mode(cfg.get("padding", "valid")))
    pool.name = cfg.get("name")
    return pool


def _map_global_pool(cfg: dict, kind: str) -> Layer:
    g = GlobalPooling(pooling=kind)
    g.name = cfg.get("name")
    return g


def _map_batchnorm(cfg: dict, rank_hint: Optional[int] = None) -> Layer:
    axis = cfg.get("axis", -1)
    if isinstance(axis, (list, tuple)):
        axis = axis[0]
    # This framework normalizes the trailing axis (channels_last). A positive
    # Keras axis counts from the batch dim, so with known input rank it must
    # equal rank-1 (KerasBatchNormalization.java's axis validation).
    if axis != -1 and rank_hint is not None and axis != rank_hint - 1:
        raise InvalidKerasConfigurationException(
            f"BatchNormalization {cfg.get('name')}: axis={axis} on rank-"
            f"{rank_hint} input — only trailing-axis (channels_last) BN is "
            "supported")
    bn = BatchNormalization(
        eps=float(cfg.get("epsilon", 1e-3)),
        decay=float(cfg.get("momentum", 0.99)),
    )
    bn.name = cfg.get("name")
    return bn


def _map_layernorm(cfg: dict) -> Layer:
    ln = LayerNorm(eps=float(cfg.get("epsilon", 1e-3)))
    ln.name = cfg.get("name")
    return ln


def _map_activation(cfg: dict) -> Layer:
    a = ActivationLayer(activation=map_activation(cfg["activation"]))
    a.name = cfg.get("name")
    return a


def _map_dropout(cfg: dict) -> Layer:
    d = DropoutLayer(dropout=float(cfg.get("rate", cfg.get("p", 0.5))))
    d.name = cfg.get("name")
    return d


def _map_spatial_dropout(cfg: dict) -> Layer:
    """SpatialDropout2D drops whole channels — mapping it to element-wise
    Dropout would silently change fine-tuning noise structure (reference
    KerasSpatialDropout → dl4j SpatialDropout)."""
    from ..nn.conf.regularizers import SpatialDropout
    d = DropoutLayer(dropout=SpatialDropout(
        p=float(cfg.get("rate", cfg.get("p", 0.5)))))
    d.name = cfg.get("name")
    return d


def _map_gaussian_noise(cfg: dict) -> Layer:
    from ..nn.conf.regularizers import GaussianNoise
    # Keras 1.x used 'sigma'
    std = float(cfg.get("stddev", cfg.get("sigma", 0.1)))
    d = DropoutLayer(dropout=GaussianNoise(stddev=std))
    d.name = cfg.get("name")
    return d


def _map_gaussian_dropout(cfg: dict) -> Layer:
    from ..nn.conf.regularizers import GaussianDropout
    # Keras 1.x used 'p'
    d = DropoutLayer(dropout=GaussianDropout(
        rate=float(cfg.get("rate", cfg.get("p", 0.5)))))
    d.name = cfg.get("name")
    return d


def _map_alpha_dropout(cfg: dict) -> Layer:
    from ..nn.conf.regularizers import AlphaDropout
    d = DropoutLayer(dropout=AlphaDropout(p=float(cfg.get("rate", 0.5))))
    d.name = cfg.get("name")
    return d


def _map_lstm(cfg: dict) -> Layer:
    # return_sequences=False is handled by the import loops, which append a
    # LastTimeStep layer / LastTimeStepVertex after this one
    # (KerasLstm.java's getUnderReturnSequences handling).
    layer = LSTM(
        n_out=int(cfg["units"]),
        forget_gate_bias_init=1.0 if cfg.get("unit_forget_bias", True) else 0.0,
    )
    layer.activation = map_activation(cfg.get("activation", "tanh"))
    layer.gate_activation = map_activation(cfg.get("recurrent_activation", "sigmoid"))
    init = map_initializer(cfg.get("kernel_initializer"))
    if init:
        layer.weight_init = init
    layer.name = cfg.get("name")
    return layer


def _map_simple_rnn(cfg: dict) -> Layer:
    layer = SimpleRnn(n_out=int(cfg["units"]))
    layer.activation = map_activation(cfg.get("activation", "tanh"))
    layer.name = cfg.get("name")
    return layer


def _map_embedding(cfg: dict) -> Layer:
    e = EmbeddingSequence(n_in=int(cfg["input_dim"]), n_out=int(cfg["output_dim"]),
                          has_bias=False)
    e.name = cfg.get("name")
    return e


def _map_zeropad2d(cfg: dict) -> Layer:
    pad = cfg.get("padding", 1)
    if isinstance(pad, (list, tuple)) and len(pad) == 2 and isinstance(pad[0], (list, tuple)):
        padding = (int(pad[0][0]), int(pad[0][1]), int(pad[1][0]), int(pad[1][1]))
    else:
        ph, pw = _pair(pad)
        padding = (ph, ph, pw, pw)
    z = ZeroPadding2D(padding=padding)
    z.name = cfg.get("name")
    return z


def _map_upsampling2d(cfg: dict) -> Layer:
    u = Upsampling2D(size=_pair(cfg.get("size", (2, 2))))
    u.name = cfg.get("name")
    return u


_LAYER_MAP: Dict[str, Callable[[dict], Layer]] = {
    "Dense": _map_dense,
    "Conv2D": _map_conv2d,
    "Convolution2D": _map_conv2d,
    "Conv1D": _map_conv1d,
    "Convolution1D": _map_conv1d,
    "MaxPooling2D": lambda c: _map_pool2d(c, "max"),
    "AveragePooling2D": lambda c: _map_pool2d(c, "avg"),
    "MaxPooling1D": lambda c: _map_pool1d(c, "max"),
    "AveragePooling1D": lambda c: _map_pool1d(c, "avg"),
    "GlobalMaxPooling2D": lambda c: _map_global_pool(c, "max"),
    "GlobalAveragePooling2D": lambda c: _map_global_pool(c, "avg"),
    "GlobalMaxPooling1D": lambda c: _map_global_pool(c, "max"),
    "GlobalAveragePooling1D": lambda c: _map_global_pool(c, "avg"),
    "BatchNormalization": _map_batchnorm,
    "LayerNormalization": _map_layernorm,
    "Activation": _map_activation,
    # Keras advanced activations carry their alpha on the layer config
    # (LeakyReLU default 0.3, ELU default 1.0) — preserved via the
    # parametric "name(alpha)" activation syntax
    "LeakyReLU": lambda c: ActivationLayer(
        activation=f"leakyrelu({float(c.get('alpha', 0.3))})"),
    "ELU": lambda c: ActivationLayer(
        activation=f"elu({float(c.get('alpha', 1.0))})"),
    "Dropout": _map_dropout,
    "SpatialDropout2D": _map_spatial_dropout,
    "GaussianNoise": _map_gaussian_noise,
    "GaussianDropout": _map_gaussian_dropout,
    "AlphaDropout": _map_alpha_dropout,
    "SeparableConv2D": _map_separable_conv2d,
    "SeparableConvolution2D": _map_separable_conv2d,
    "Conv2DTranspose": _map_conv2d_transpose,
    "Deconvolution2D": _map_conv2d_transpose,
    "ZeroPadding1D": _map_zeropad1d,
    "Cropping2D": _map_cropping2d,
    "LSTM": _map_lstm,
    "SimpleRNN": _map_simple_rnn,
    "Embedding": _map_embedding,
    "ZeroPadding2D": _map_zeropad2d,
    "UpSampling2D": _map_upsampling2d,
}

# structural layers consumed by the importer itself
_STRUCTURAL = {"InputLayer", "Flatten", "Reshape"}

_RANK4 = {"Conv2D", "Convolution2D", "SeparableConv2D",
          "SeparableConvolution2D", "Conv2DTranspose", "Deconvolution2D",
          "MaxPooling2D", "AveragePooling2D",
          "ZeroPadding2D", "Cropping2D", "UpSampling2D", "SpatialDropout2D"}
_RANK3 = {"LSTM", "SimpleRNN", "Embedding", "Conv1D", "Convolution1D",
          "MaxPooling1D", "AveragePooling1D", "ZeroPadding1D"}
# Dense is rank-preserving in Keras (broadcasts over leading dims)
_RANK2 = {"GlobalMaxPooling2D", "GlobalAveragePooling2D",
          "GlobalMaxPooling1D", "GlobalAveragePooling1D"}


def _rank_after(cls: str, cur: Optional[int]) -> Optional[int]:
    """Activation rank (incl. batch) after a Keras layer, for BN axis checks."""
    if cls in _RANK4:
        return 4
    if cls in _RANK3:
        return 3
    if cls in _RANK2:
        return 2
    return cur  # rank-preserving (BN, Activation, Dropout, ...)


def _input_type_from_shape(shape) -> InputType:
    """Input shape WITHOUT the batch dim → InputType.
    (time, features) → rnn, (h, w, c) → cnn, (features,) → ff."""
    if len(shape) == 3:
        h, w, c = shape
        return InputType.convolutional(h, w, c)
    if len(shape) == 2:
        t, f = shape
        if f is None:
            raise InvalidKerasConfigurationException(
                f"cannot infer recurrent feature size from {shape}")
        return InputType.recurrent(int(f), t)
    if len(shape) == 1 and shape[0] is not None:
        return InputType.feed_forward(int(shape[0]))
    raise InvalidKerasConfigurationException(f"unsupported input shape: {shape}")


# ---------------------------------------------------------------------------
# config parsing (KerasModel / KerasSequentialModel parity)
# ---------------------------------------------------------------------------


def _parse_model_config(model_config: Any) -> Tuple[str, List[dict], dict]:
    """Returns (kind, layer_dicts, extras).  kind ∈ {sequential, functional}."""
    if isinstance(model_config, list):  # Keras 1.x Sequential: bare list
        return "sequential", model_config, {}
    class_name = model_config.get("class_name", "Sequential")
    cfg = model_config.get("config", model_config)
    if class_name == "Sequential":
        layers = cfg if isinstance(cfg, list) else cfg.get("layers", [])
        return "sequential", layers, {}
    if class_name in ("Model", "Functional"):
        extras = {
            "input_layers": cfg.get("input_layers", []),
            "output_layers": cfg.get("output_layers", []),
        }
        return "functional", cfg.get("layers", []), extras
    raise InvalidKerasConfigurationException(f"unsupported model class: {class_name}")


def _layer_class_and_cfg(ld: dict) -> Tuple[str, dict]:
    cls = ld.get("class_name")
    cfg = ld.get("config", {})
    if isinstance(cfg, dict) and "name" not in cfg and "name" in ld:
        cfg = dict(cfg, name=ld["name"])
    return cls, cfg


# ---------------------------------------------------------------------------
# weight loading + conversion
# ---------------------------------------------------------------------------


def _weights_root(archive) -> str:
    return "model_weights" if archive.has_group("model_weights") else "/"


def _convert_lstm_kernel(k: np.ndarray, units: int) -> np.ndarray:
    """Keras gate blocks [i|f|c|o] → our fused order [i|f|o|g] (g = c)."""
    i, f, c, o = (k[..., :units], k[..., units:2 * units],
                  k[..., 2 * units:3 * units], k[..., 3 * units:])
    return np.concatenate([i, f, o, c], axis=-1)


def _set_layer_params(layer: Layer, params: Dict[str, Any], state: Dict[str, Any],
                      w: Dict[str, np.ndarray], dtype: torch.dtype,
                      device: torch.device) -> None:
    """Write Keras weight arrays into our param/state dicts in place, as
    tensors of ``dtype`` on ``device``."""

    def put(dst: Dict, key: str, arr: np.ndarray):
        dst[key] = torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype, device=device)

    if isinstance(layer, (Dense, OutputLayer)):
        if "kernel" in w:
            put(params, "W", w["kernel"])          # (in, out) — same layout
        elif "W" in w:
            put(params, "W", w["W"])
        if layer.has_bias and ("bias" in w or "b" in w):
            put(params, "b", w.get("bias", w.get("b")))
    elif isinstance(layer, SeparableConvolution2D):
        # keras depthwise [kh,kw,in,dm] -> our dW [kh,kw,1,in*dm]: with
        # feature_group_count=n_in, output group i holds channel i's dm
        # multipliers — exactly the C-order flatten of keras's (in, dm)
        if "depthwise_kernel" in w:
            dk = w["depthwise_kernel"]
            kh, kw, cin, dm = dk.shape
            put(params, "dW", dk.reshape(kh, kw, 1, cin * dm))
        if "pointwise_kernel" in w:
            put(params, "pW", w["pointwise_kernel"])   # [1,1,in*dm,out] — same
        if layer.has_bias and ("bias" in w or "b" in w):
            put(params, "b", w.get("bias", w.get("b")))
    elif isinstance(layer, Deconvolution2D):
        # keras Conv2DTranspose kernel [kh,kw,out,in] with tf's implicit
        # spatial flip → our HWIO [kh,kw,in,out] for plain
        # conv_transpose: transpose the channel dims AND flip H/W
        # (verified elementwise against tf.nn.conv2d_transpose —
        # tests/test_modelimport.py::TestConv2DTranspose)
        if "kernel" in w:
            put(params, "W", w["kernel"].transpose(0, 1, 3, 2)[::-1, ::-1])
        if layer.has_bias and ("bias" in w or "b" in w):
            put(params, "b", w.get("bias", w.get("b")))
    elif isinstance(layer, (Convolution2D, Convolution1D)):
        if "kernel" in w:
            put(params, "W", w["kernel"])          # HWIO — same layout
        elif "W" in w:
            put(params, "W", w["W"])
        if layer.has_bias and ("bias" in w or "b" in w):
            put(params, "b", w.get("bias", w.get("b")))
    elif isinstance(layer, BatchNormalization):
        if "gamma" in w:
            put(params, "gamma", w["gamma"])
        if "beta" in w:
            put(params, "beta", w["beta"])
        if "moving_mean" in w:
            put(state, "mean", w["moving_mean"])
        if "moving_variance" in w:
            put(state, "var", w["moving_variance"])
    elif isinstance(layer, LayerNorm):
        if "gamma" in w:
            put(params, "gamma", w["gamma"])
        if "beta" in w:
            put(params, "beta", w["beta"])
    elif isinstance(layer, LSTM):
        n = layer.n_out
        if "kernel" in w:
            put(params, "W", _convert_lstm_kernel(w["kernel"], n))
            put(params, "RW", _convert_lstm_kernel(w["recurrent_kernel"], n))
            if "bias" in w:
                put(params, "b", _convert_lstm_kernel(w["bias"], n))
    elif isinstance(layer, SimpleRnn):
        if "kernel" in w:
            put(params, "W", w["kernel"])
            put(params, "RW", w["recurrent_kernel"])
            if "bias" in w:
                put(params, "b", w["bias"])
    elif isinstance(layer, EmbeddingSequence):
        if "embeddings" in w:
            put(params, "W", w["embeddings"])
        elif "W" in w:
            put(params, "W", w["W"])
    # pooling/activation/dropout/padding: no params


# ---------------------------------------------------------------------------
# sequential import
# ---------------------------------------------------------------------------


def _read_model_config(archive) -> Any:
    if not archive.has_attr("model_config"):
        raise InvalidKerasConfigurationException(
            "no model_config attribute — is this a save_weights-only file? "
            "Full-model files are required for architecture import")
    return archive.read_attr_as_json("model_config")


def import_keras_sequential_model_and_weights(
        path: str, enforce_training_config: bool = False,
        device: DeviceLike = None) -> MultiLayerNetwork:
    """Keras Sequential .h5 → MultiLayerNetwork with weights on ``device``
    (KerasModelImport.importKerasSequentialModelAndWeights:120-180)."""
    with Hdf5Archive(path) as archive:
        return _import_archive(archive, enforce_training_config, device,
                               sequential_only=True)


def _import_archive(archive, enforce_training_config: bool = False,
                    device: DeviceLike = None, sequential_only: bool = False):
    """The import stages after the read, over any object with
    :class:`Hdf5Archive`'s read methods: Sequential → MultiLayerNetwork,
    functional → ComputationGraph (refused with ``sequential_only``)."""
    kind, layer_dicts, extras = _parse_model_config(_read_model_config(archive))
    if kind == "sequential":
        return _import_sequential(archive, layer_dicts, enforce_training_config, device)
    if sequential_only:
        raise InvalidKerasConfigurationException(
            "functional model passed to sequential import — use "
            "import_keras_model_and_weights")
    return _import_functional(archive, layer_dicts, extras, device)


def _import_sequential(archive, layer_dicts: List[dict], enforce_training_config: bool,
                       device: DeviceLike = None) -> MultiLayerNetwork:
    training_cfg = None
    if archive.has_attr("training_config"):
        training_cfg = archive.read_attr_as_json("training_config")
    elif enforce_training_config:
        raise InvalidKerasConfigurationException(
            "enforce_training_config=True but file has no training_config")

    conf = MultiLayerConfiguration()
    input_type: Optional[InputType] = None
    our_layers: List[Layer] = []
    keras_names: List[Optional[str]] = []  # keras layer name per our layer
    cur_rank: Optional[int] = None  # rank incl. batch dim, for BN axis check

    for ld in layer_dicts:
        cls, cfg = _layer_class_and_cfg(ld)
        shape = cfg.get("batch_input_shape") or cfg.get("batch_shape")
        if input_type is None and shape is not None:
            stripped = list(shape)[1:]
            if cls == "Embedding":
                # Keras Embedding input (batch, T) carries int indices:
                # model it as a length-T sequence (size is the index col)
                input_type = InputType.recurrent(1, stripped[0])
                cur_rank = 3
            else:
                input_type = _input_type_from_shape(stripped)
                cur_rank = len(shape)
        if cls in _STRUCTURAL:
            # InputLayer → input_type only; Flatten/Reshape → rely on the
            # automatic preprocessor pass (_infer_types inserts
            # CnnToFeedForward when a Dense follows a conv stack)
            if cls in ("Flatten", "Reshape"):
                cur_rank = 2
            continue
        if cls not in _LAYER_MAP:
            raise InvalidKerasConfigurationException(f"unsupported Keras layer: {cls}")
        if cls == "BatchNormalization":
            layer = _map_batchnorm(cfg, rank_hint=cur_rank)
        else:
            layer = _LAYER_MAP[cls](cfg)
        if cls in ("LSTM", "SimpleRNN") and not cfg.get("return_sequences", False):
            wrapped = LastTimeStep(layer=layer)
            wrapped.name = layer.name
            layer = wrapped
            cur_rank = 2
        else:
            cur_rank = _rank_after(cls, cur_rank)
        our_layers.append(layer)
        keras_names.append(cfg.get("name"))

    if input_type is None:
        raise InvalidKerasConfigurationException(
            "could not determine input shape (no batch_input_shape on the "
            "first layer)")

    # loss head: translate the final Dense into an OutputLayer when a
    # training_config names a loss (KerasModel.java's enforceTrainingConfig)
    if training_cfg is not None:
        loss_name = training_cfg.get("loss")
        if isinstance(loss_name, dict):
            loss_name = next(iter(loss_name.values()))
        if isinstance(loss_name, str) and our_layers:
            mapped = map_loss(loss_name)
            last = our_layers[-1]
            if type(last) is Dense:
                out = OutputLayer(n_in=last.n_in, n_out=last.n_out,
                                  has_bias=last.has_bias, loss=mapped)
                out.activation, out.weight_init = last.activation, last.weight_init
                out.name = last.name
                our_layers[-1] = out
            else:
                # parameter-free loss head — Keras keeps the loss in the
                # optimizer, DL4J appends a LossLayer (KerasLoss.java)
                our_layers.append(LossLayer(loss=mapped, activation="identity"))
                keras_names.append(None)

    conf.layers = our_layers
    conf.input_type = input_type
    net = MultiLayerNetwork(conf, device=device)
    net.init()

    # weights
    root = _weights_root(archive)
    dtype = canonical_dtype(conf.param_dtype)
    for i, (layer, kname) in enumerate(zip(our_layers, keras_names)):
        if kname is None:
            continue
        w = archive.layer_weights(root, kname)
        if not w:
            continue
        target = layer.layer if isinstance(layer, LastTimeStep) else layer
        p = dict(net.params[i])
        s = dict(net.state[i])
        _set_layer_params(target, p, s, w, dtype, net.device)
        net.params[i] = p
        net.state[i] = s
    return net


# ---------------------------------------------------------------------------
# functional import
# ---------------------------------------------------------------------------


def _check_concatenate_axis(cfg: dict, name: str, in_rank: Optional[int]) -> None:
    """MergeVertex always concatenates the trailing axis; a Keras
    Concatenate on any other axis would import silently wrong — reject it
    loudly (mirrors the channels_first rejection)."""
    axis = cfg.get("axis", -1)
    ok = axis == -1 or (in_rank is not None and axis == in_rank - 1)
    if not ok:
        raise InvalidKerasConfigurationException(
            f"Concatenate layer '{name}' uses axis={axis}; only the "
            f"trailing feature axis (-1) is supported by MergeVertex")


def _inbound_names(ld: dict) -> List[str]:
    """Flatten Keras inbound_nodes (nested [[name, node_idx, tensor_idx, {}]])."""
    nodes = ld.get("inbound_nodes", [])
    if not nodes:
        return []
    if len(nodes) > 1:
        raise InvalidKerasConfigurationException(
            f"layer {ld.get('name') or ld.get('config', {}).get('name')} is "
            "applied at multiple call sites (shared layer) — not supported")
    first = nodes[0]
    names: List[str] = []
    if isinstance(first, dict):  # Keras 3 style {'args': [...]}
        def walk(o):
            if isinstance(o, dict):
                if o.get("class_name") == "__keras_tensor__":
                    names.append(o["config"]["keras_history"][0])
                else:
                    for v in o.values():
                        walk(v)
            elif isinstance(o, (list, tuple)):
                for v in o:
                    walk(v)
        walk(first)
    else:
        for entry in first:
            if isinstance(entry, (list, tuple)) and entry and isinstance(entry[0], str):
                names.append(entry[0])
    return names


def import_keras_model_and_weights(path: str, enforce_training_config: bool = False,
                                   device: DeviceLike = None):
    """Keras .h5 → model on ``device``. Sequential → MultiLayerNetwork;
    functional → ComputationGraph
    (KerasModelImport.importKerasModelAndWeights:41-119)."""
    with Hdf5Archive(path) as archive:
        return _import_archive(archive, enforce_training_config, device)


# Keras merge layers → ElementWiseVertex ops (KerasMerge.java mapping)
_MERGE_OPS = {
    "Add": "add",
    "Subtract": "subtract",
    "Multiply": "product",
    "Maximum": "max",
    "Average": "average",
}
_MERGE_OPS.update({k.lower(): v for k, v in _MERGE_OPS.items()})


def _import_functional(archive, layer_dicts: List[dict], extras: dict,
                       device: DeviceLike = None) -> ComputationGraph:
    builder = GraphBuilder()
    input_types: Dict[str, InputType] = {}
    keras_to_vertex: Dict[str, str] = {}
    layer_by_name: Dict[str, Layer] = {}
    vertex_rank: Dict[str, Optional[int]] = {}  # incl. batch dim, for BN

    for ld in layer_dicts:
        cls, cfg = _layer_class_and_cfg(ld)
        name = cfg.get("name") or ld.get("name")
        inputs = [keras_to_vertex[n] for n in _inbound_names(ld)]
        in_rank = vertex_rank.get(inputs[0]) if inputs else None
        if cls == "InputLayer":
            shape = cfg.get("batch_input_shape") or cfg.get("batch_shape")
            builder.add_inputs(name)
            input_types[name] = _input_type_from_shape(list(shape)[1:])
            keras_to_vertex[name] = name
            vertex_rank[name] = len(shape)
            continue
        if cls == "Flatten":
            builder.add_vertex(name, PreprocessorVertex(CnnToFeedForward()), *inputs)
            keras_to_vertex[name] = name
            vertex_rank[name] = 2
            continue
        if cls in _MERGE_OPS:
            builder.add_vertex(name, ElementWiseVertex(op=_MERGE_OPS[cls]), *inputs)
            keras_to_vertex[name] = name
            vertex_rank[name] = in_rank
            continue
        if cls in ("Concatenate", "Merge"):
            if cls == "Concatenate":
                _check_concatenate_axis(cfg, name, in_rank)
            builder.add_vertex(name, MergeVertex(), *inputs)
            keras_to_vertex[name] = name
            vertex_rank[name] = in_rank
            continue
        if cls not in _LAYER_MAP:
            raise InvalidKerasConfigurationException(f"unsupported Keras layer: {cls}")
        if cls == "BatchNormalization":
            layer = _map_batchnorm(cfg, rank_hint=in_rank)
        else:
            layer = _LAYER_MAP[cls](cfg)
        builder.add_layer(name, layer, *inputs)
        layer_by_name[name] = layer
        keras_to_vertex[name] = name
        vertex_rank[name] = _rank_after(cls, in_rank)
        if cls in ("LSTM", "SimpleRNN") and not cfg.get("return_sequences", False):
            builder.add_vertex(name + "__last", LastTimeStepVertex(), name)
            keras_to_vertex[name] = name + "__last"
            vertex_rank[name + "__last"] = 2

    outs = []
    for o in extras.get("output_layers", []):
        raw = o[0] if isinstance(o, (list, tuple)) else o
        outs.append(keras_to_vertex.get(raw, raw))
    builder.set_outputs(*outs)
    builder.set_input_types(**input_types)
    graph = ComputationGraph(builder.build(), device=device)
    graph.init()

    # weights
    root = _weights_root(archive)
    dtype = canonical_dtype(graph.conf.param_dtype)
    for name, layer in layer_by_name.items():
        w = archive.layer_weights(root, name)
        if not w:
            continue
        if name in graph.params:
            p = dict(graph.params[name])
            s = dict(graph.state.get(name, {}))
            _set_layer_params(layer, p, s, w, dtype, graph.device)
            graph.params[name] = p
            if name in graph.state:
                graph.state[name] = s
    return graph


class KerasModelImport:
    """Static entry points (KerasModelImport.java:41-269 parity)."""

    import_keras_sequential_model_and_weights = staticmethod(
        import_keras_sequential_model_and_weights)
    import_keras_model_and_weights = staticmethod(import_keras_model_and_weights)
