"""Fused bracket-term segment sums for the scenario sweep (CUDA, sm_90a).

``ops`` holds the wrappers (the reference's contract, CPU tensors to the
plain versions in ``ref``, CUDA tensors to the kernels), ``sweep_bracket``
builds and launches ``csrc/sweep_bracket.cu``.
"""
from .ops import (BRACKET_NAMES, CsrGroup, csr_group, fused_bracket_segsum,
                  segment_sum)
from .ref import bracket_segsum_ref, segment_sum_ref

__all__ = ["BRACKET_NAMES", "CsrGroup", "csr_group", "fused_bracket_segsum",
           "segment_sum", "bracket_segsum_ref", "segment_sum_ref"]
