"""HPCG's 27-point operator (CUDA, sm_90a).

``ops.apply_27pt`` is the wrapper (CPU tensors to the plain version in
``ref``, CUDA tensors to the kernel), ``stencil27`` builds and launches
``csrc/stencil27.cu``.
"""
from .ops import apply_27pt
from .ref import apply_27pt_ref

__all__ = ["apply_27pt", "apply_27pt_ref"]
