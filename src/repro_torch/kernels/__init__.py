"""Kernels of the PyTorch port, written by hand for Hopper, each with its
plain PyTorch version in ``ref.py``.

- decode_attention: one-token GQA attention vs a ring KV cache (CUDA C++,
  ``csrc/decode_attention.cu``)
- flash_attention: forward prefill GQA attention, causal or not, with an
  optional sliding window (CUDA C++, ``csrc/flash_attention.cu``)
- mamba_scan: the Mamba-1 selective scan, state carried over the sequence
  (CUDA C++, ``csrc/mamba_scan.cu``)
- add_norm: a residual add and LayerNorm or RMSNorm in one launch (CUDA
  C++, ``csrc/add_norm.cu``; no TPU counterpart)
- moe_grouped: a dropless MoE layer's expert products over the held
  experts' sorted rows, two launches (CUDA C++, ``csrc/moe_grouped.cu``; no
  TPU counterpart)
- rope: rotate-half RoPE of q and k in one launch, in place (CUDA C++,
  ``csrc/rope.cu``; no TPU counterpart)
"""
from repro_torch.kernels.ops import (add_norm_op, decode_attention_op,
                                     flash_attention_op, mamba_scan_op,
                                     moe_grouped_op, rope_op)

__all__ = ["add_norm_op", "decode_attention_op", "flash_attention_op",
           "mamba_scan_op", "moe_grouped_op", "rope_op"]
