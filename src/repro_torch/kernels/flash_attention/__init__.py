"""Blockwise (flash) attention (CUDA, sm_90a).

``ops.flash_attention`` is the wrapper (CPU tensors to the plain version in
``ref``, CUDA tensors to the kernel that ``ops.route`` picks), and
``flash_attention`` builds and launches ``csrc/flash_attention_sm90.cu``
(bf16 on the tensor cores) and ``csrc/flash_attention.cu`` (f32 math).
"""
from .ops import flash_attention, route
from .ref import attention_ref

__all__ = ["flash_attention", "route", "attention_ref"]
