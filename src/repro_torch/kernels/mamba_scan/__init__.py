"""Selective scan, the Mamba-1 recurrence (CUDA, sm_90a).

``ops.mamba_scan`` is the wrapper (CPU tensors to the plain version in
``ref``, CUDA tensors to the kernel), ``mamba_scan`` builds and launches
``csrc/mamba_scan.cu``.
"""
from .ops import mamba_scan
from .ref import mamba_scan_ref

__all__ = ["mamba_scan", "mamba_scan_ref"]
