"""Model families of the port: the dense LM (and chameleon's early-fusion
VLM, whose image tokens are vocabulary ids), the MoE LM, the Mamba1 SSM
LM, the Mamba2 hybrid, the encoder-decoder and the paper's ResNet."""
from .encdec import EncDec
from .hybrid import Zamba2
from .resnet import ResNet
from .ssm_lm import SSMLM
from .transformer import LMTransformer

_FAMILIES = {"lm": LMTransformer, "vlm": LMTransformer, "moe": LMTransformer,
             "ssm": SSMLM, "hybrid": Zamba2, "encdec": EncDec,
             "resnet": ResNet}


def build_model(acfg, qcfg, device="cuda"):
    """The model for `acfg` by its family ("lm", "vlm" and "moe" ->
    LMTransformer, "ssm" -> SSMLM, "hybrid" -> Zamba2, "encdec" -> EncDec,
    "resnet" -> ResNet; the reference's models/registry.py)."""
    if acfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {acfg.family!r}")
    return _FAMILIES[acfg.family](acfg, qcfg, device=device)


__all__ = ["EncDec", "LMTransformer", "ResNet", "SSMLM", "Zamba2",
           "build_model"]
