"""WAGEUBN quantized core for the port: QTensor, quantizers, QConfig, the
threefry PRNG and the quantized ops with their Alg. 2 backward (qdense /
qact / qrmsnorm)."""
from .qconfig import FULL8, PRESETS, QConfig, preset
from .qdense import qact, qdense, qprobs, qweight
from .qnorm import qlayernorm, qrmsnorm
from .qtensor import QTensor, QuantSpec, get_quantizer, qt_carrier

__all__ = ["FULL8", "PRESETS", "QConfig", "preset", "qact", "qdense",
           "qprobs", "qweight", "qlayernorm", "qrmsnorm", "QTensor",
           "QuantSpec", "get_quantizer", "qt_carrier"]
