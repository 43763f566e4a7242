"""Build, load and launch the CUDA kernel of ``csrc/flash_attention.cu``.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use and loaded
with ``ctypes`` by ``kernels._build``.  Nothing is built or loaded when this
module is imported: machines without ``nvcc`` import it freely and run the
plain version in ``ref`` on CPU tensors.

The launcher takes raw, already-validated device tensors;
``ops.flash_attention`` owns the checks and the output allocation.
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" \
    / "flash_attention.cu"

#: Head widths the kernel is instantiated for.
HEAD_DIMS = (16, 32, 64, 128, 256)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, B, S, T, Hq, Hkv, D, causal, scale, stream
    "flash_attention": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
                        (torch.float32, torch.bfloat16)),
}


def build() -> _build.Library:
    """Compile (if needed) and load the kernel's library; idempotent."""
    return _build.build(SOURCE, _SIGNATURES)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool) -> None:
    """Enqueue the kernel on the current stream: contiguous ``q (B, S, Hq,
    D)``, ``k``/``v (B, T, Hkv, D)`` and ``out`` like ``q``, one dtype."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rc = build().fn("flash_attention", q.dtype)(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), B, S,
        T, Hq, Hkv, D, int(causal), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
