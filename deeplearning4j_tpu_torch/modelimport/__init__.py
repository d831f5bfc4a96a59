"""Keras model import (HDF5) — parity with the reference's
deeplearning4j-modelimport module (KerasModelImport.java:41-269)."""

from .keras import (
    KerasModelImport,
    Hdf5Archive,
    import_keras_sequential_model_and_weights,
    import_keras_model_and_weights,
)

__all__ = [
    "KerasModelImport",
    "Hdf5Archive",
    "import_keras_sequential_model_and_weights",
    "import_keras_model_and_weights",
]
