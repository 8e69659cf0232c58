"""Model families of the port: the dense LM (and chameleon's early-fusion
VLM, whose image tokens are vocabulary ids), the MoE LM, the Mamba1 SSM
LM, the encoder-decoder and the paper's ResNet."""
from .encdec import EncDec
from .resnet import ResNet
from .ssm_lm import SSMLM
from .transformer import LMTransformer

_FAMILIES = {"lm": LMTransformer, "vlm": LMTransformer, "moe": LMTransformer,
             "ssm": SSMLM, "encdec": EncDec, "resnet": ResNet}


def build_model(acfg, qcfg, device="cuda"):
    """The model for `acfg` by its family ("lm", "vlm" and "moe" ->
    LMTransformer, "ssm" -> SSMLM, "encdec" -> EncDec, "resnet" -> ResNet;
    the reference's models/registry.py); Mamba2 and the hybrid raise."""
    if acfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {acfg.family!r} is not ported yet: Mamba2 and the "
            "hybrid are ROADMAP Queue 1 item 4")
    return _FAMILIES[acfg.family](acfg, qcfg, device=device)


__all__ = ["EncDec", "LMTransformer", "ResNet", "SSMLM", "build_model"]
