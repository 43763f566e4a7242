"""Build, load and launch the CUDA kernel of ``csrc/mamba_scan.cu``.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use and loaded
with ``ctypes`` by ``kernels._build``.  Nothing is built or loaded when this
module is imported: machines without ``nvcc`` import it freely and run the
plain version in ``ref`` on CPU tensors.

The launcher takes raw, already-validated device tensors;
``ops.mamba_scan`` owns the checks and the output allocation.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"

#: The most states per channel the kernel holds (four lanes of four).
MAX_STATES = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, dt, Bt, Ct, A, D, h0 (or null), y, h, B, L, d, N, stream
    "mamba_scan": ([_P] * 9 + [_I] * 4 + [_P], (torch.float32,)),
}


def build() -> _build.Library:
    """Compile (if needed) and load the kernel's library; idempotent."""
    return _build.build(SOURCE, _SIGNATURES)


def launch(x, dt, Bt, Ct, A, D, y, h, h0=None) -> None:
    """Enqueue the kernel on the current stream: contiguous float32 inputs
    and the preallocated ``y (B, L, d)`` and ``h (B, d, N)``; ``h0 (B, d,
    N)``, the state before step 0 (zero when ``None``)."""
    Bsz, L, d = x.shape
    rc = build().fn("mamba_scan", torch.float32)(
        *(_build.ptr(t) for t in (x, dt, Bt, Ct, A, D, h0, y, h)), Bsz, L, d,
        A.shape[-1], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "mamba_scan")
