"""Pretrained-weight loading through a checksum-verified local cache
(mirrors ``deeplearning4j_tpu/models/pretrained.py``).

The reference downloads a zoo model's weights to a cache directory,
checks them with Adler-32 and restores them; this build has no network,
so the transport is a local file (or a cache directory filled
beforehand), and the rest is the same: the cache layout
``<cache>/<name>/<name>_<type>.zip``, the checksum, the eviction of a
corrupt cached file, and the restore through ``utils/serializer.py``
(either package's zip).  ``BUILTIN_WEIGHTS`` names the zips the JAX
package ships: the port reads them from that package's ``weights``
directory in the same checkout, as a file, without importing it.
"""

from __future__ import annotations

import os
import shutil
import zlib
from typing import Optional

from ..utils.device import DeviceLike

DEFAULT_CACHE = os.path.expanduser("~/.deeplearning4j_tpu/models")

#: the weights directory that ships beside this package in the checkout
_BUILTIN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "deeplearning4j_tpu", "models", "weights")


def checksum(path: str) -> int:
    """Adler-32 of the file (the reference's checksum)."""
    value = 1
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            value = zlib.adler32(chunk, value)
    return value & 0xFFFFFFFF


class PretrainedType:
    """The dataset a model's weights were fit on."""

    IMAGENET = "imagenet"
    MNIST = "mnist"
    CIFAR10 = "cifar10"
    VGGFACE = "vggface"
    IRIS = "iris"


#: (model name, pretrained type) → (file under the weights directory,
#: Adler-32): the Iris MLP, 4 → 16 tanh → 8 tanh → 3 softmax
BUILTIN_WEIGHTS = {
    ("iris_mlp", PretrainedType.IRIS): ("iris_mlp_iris.zip", 1686618174),
}


def cached_path(model_name: str, pretrained_type: str = PretrainedType.IMAGENET,
                cache_dir: Optional[str] = None) -> str:
    cache = cache_dir or DEFAULT_CACHE
    return os.path.join(cache, model_name, f"{model_name}_{pretrained_type}.zip")


def install_weights(model_name: str, source_path: str,
                    pretrained_type: str = PretrainedType.IMAGENET,
                    cache_dir: Optional[str] = None) -> str:
    """Copy a weights zip into the cache (the stand-in for the download).
    Returns the cached path."""
    dst = cached_path(model_name, pretrained_type, cache_dir)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copyfile(source_path, dst)
    return dst


def init_pretrained(model_name: str,
                    pretrained_type: str = PretrainedType.IMAGENET,
                    expected_checksum: Optional[int] = None,
                    cache_dir: Optional[str] = None,
                    local_file: Optional[str] = None,
                    device: DeviceLike = None):
    """A pretrained network on ``device`` (default ``cuda``).  Looks in
    ``local_file``, then the cache, then ``BUILTIN_WEIGHTS`` (whose
    checksum is always enforced).  With ``expected_checksum`` a mismatch
    raises, and a cached file that mismatches is evicted first; a
    ``local_file`` that does not exist raises rather than falling
    through to other weights."""
    from ..utils.serializer import load_model

    path = local_file or cached_path(model_name, pretrained_type, cache_dir)
    if not os.path.exists(path):
        if local_file is not None:
            raise FileNotFoundError(f"local_file not found: {local_file}")
        builtin = BUILTIN_WEIGHTS.get((model_name, pretrained_type))
        if builtin is not None:
            rel, want = builtin
            path = os.path.join(_BUILTIN_DIR, rel)
            got = checksum(path)
            if got != want:
                raise IOError(f"builtin weights {rel} corrupt: adler32 {got} != {want}")
            if expected_checksum is not None and got != expected_checksum:
                raise IOError(f"checksum mismatch for builtin {rel}: expected "
                              f"{expected_checksum}, got {got}")
            return load_model(path, device=device)
        raise FileNotFoundError(
            f"no pretrained weights for '{model_name}' ({pretrained_type}) at "
            f"{path} — place the checkpoint zip there or pass local_file=/"
            "install_weights(). (There is no download: builtins available: "
            f"{sorted(BUILTIN_WEIGHTS)})")
    if expected_checksum is not None:
        got = checksum(path)
        if got != expected_checksum:
            if local_file is None:
                os.remove(path)
            raise IOError(
                f"checksum mismatch for {path}: expected {expected_checksum}, "
                f"got {got}" + ("" if local_file else " (cached copy evicted)"))
    return load_model(path, device=device)


def init_pretrained_int8(model_name: str,
                         pretrained_type: str = PretrainedType.IMAGENET,
                         calibration_inputs=None,
                         expected_checksum: Optional[int] = None,
                         cache_dir: Optional[str] = None,
                         local_file: Optional[str] = None,
                         device: DeviceLike = None):
    """The zoo's int8 serving entry: ``init_pretrained``, the calibration
    pass and per-channel weight quantization in one step
    (``ops/quantize.py``).  ``calibration_inputs`` is an array or a list
    of arrays of representative inputs (leading batch axis); there is no
    synthetic default, since the activation scales are only as good as
    the pass.  Returns a ``QuantizedModel`` ready for ``serving.Engine``
    (load it without ``quantize=``)."""
    from ..ops.quantize import quantize_model

    if calibration_inputs is None:
        raise ValueError(
            "init_pretrained_int8 needs calibration_inputs — a batch (or "
            "list of batches) of representative per-example inputs")
    net = init_pretrained(model_name, pretrained_type,
                          expected_checksum=expected_checksum,
                          cache_dir=cache_dir, local_file=local_file, device=device)
    return quantize_model(net, calibration_inputs)
