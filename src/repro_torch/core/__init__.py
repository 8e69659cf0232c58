"""WAGEUBN quantized core for the port: QTensor, quantizers, QConfig, the
threefry PRNG and the quantized ops with their Alg. 2 backward (qdense /
qconv / qact / qrmsnorm / qbatchnorm)."""
from .qconfig import FP32, FULL8, PRESETS, QConfig, preset
from .qdense import qact, qconv, qdense, qprobs, qweight
from .qnorm import batchnorm, qbatchnorm, qlayernorm, qrmsnorm
from .qtensor import QTensor, QuantSpec, get_quantizer, qt_carrier

__all__ = ["FP32", "FULL8", "PRESETS", "QConfig", "preset", "qact", "qconv",
           "qdense", "qprobs", "qweight", "batchnorm", "qbatchnorm",
           "qlayernorm", "qrmsnorm", "QTensor", "QuantSpec", "get_quantizer",
           "qt_carrier"]
