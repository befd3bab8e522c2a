"""Kernels of the PyTorch port, written by hand for Hopper, each with its
plain PyTorch version in ``ref.py``.

- decode_attention: one-token GQA attention vs a ring KV cache (CUDA C++,
  ``csrc/decode_attention.cu``)
- flash_attention: forward prefill GQA attention, causal or not, with an
  optional sliding window (CUDA C++, ``csrc/flash_attention.cu``)
- mamba_scan: the Mamba-1 selective scan, state carried over the sequence
  (CUDA C++, ``csrc/mamba_scan.cu``)
"""
from repro_torch.kernels.ops import (decode_attention_op, flash_attention_op,
                                     mamba_scan_op)

__all__ = ["decode_attention_op", "flash_attention_op", "mamba_scan_op"]
