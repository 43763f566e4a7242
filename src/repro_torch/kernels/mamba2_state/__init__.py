"""One Mamba-2 decode step's state update and readout (CUDA, sm_90a).

``ops.mamba2_state_update`` is the wrapper (CPU tensors to the plain
version in ``ref``, CUDA tensors to the kernel), ``mamba2_state`` builds
and launches ``csrc/mamba2_state.cu``.
"""
from .ops import mamba2_state_update
from .ref import mamba2_state_update_ref

__all__ = ["mamba2_state_update", "mamba2_state_update_ref"]
