"""Blockwise (flash) attention (CUDA, sm_90a).

``ops.flash_attention`` is the wrapper (CPU tensors to the plain version in
``ref``, CUDA tensors to the kernel), ``flash_attention`` builds and
launches ``csrc/flash_attention.cu``.
"""
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]
