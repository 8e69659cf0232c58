"""PyTorch + CUDA port of the WAGEUBN full-int8 system for NVIDIA Hopper.

The JAX package `repro` stays the reference.  This package mirrors it
module by module and imports nothing of it (nor JAX); every TPU kernel on
a ported path is a hand-written CUDA kernel for sm_90a (`csrc/`), with a
plain PyTorch version beside it (`kernels/ref.py`).

Ported so far, for the dense LM: the chunked-prefill + decode serving path
(`serving.make_engine`) and the single-device training step
(`launch.train.make_train_step`), on the kernels qmatmul, quantize,
dgrad/wgrad, ubn_norm, flash_attention, page_gather and paged_attention;
the paper's ResNet18/34/50 trained by the same step; Mamba1 SSM serving on
selective_scan; and checkpoints (`checkpoint.CheckpointManager`), which
restore bit for bit in either package.
"""
