"""Model families of the port (the dense LM so far)."""
from .transformer import LMTransformer


def build_model(acfg, qcfg, device="cuda"):
    """The model for `acfg` (family "lm"; other families raise)."""
    return LMTransformer(acfg, qcfg, device=device)


__all__ = ["LMTransformer", "build_model"]
