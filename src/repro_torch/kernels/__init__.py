"""Kernels of the PyTorch port, written by hand for Hopper, each with its
plain PyTorch version in ``ref.py``.

- decode_attention: one-token GQA attention vs a ring KV cache (CUDA C++,
  ``csrc/decode_attention.cu``)
- flash_attention: forward prefill GQA attention, causal or not, with an
  optional sliding window (CUDA C++, ``csrc/flash_attention.cu``)
"""
from repro_torch.kernels.ops import decode_attention_op, flash_attention_op

__all__ = ["decode_attention_op", "flash_attention_op"]
