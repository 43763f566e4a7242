"""Build, load and launch the CUDA kernels of ``csrc/``.

Two sources, one library each:

  ``flash_attention_sm90.cu``  ``attn_sm90_kernel``: bf16 on the tensor
                               cores (wgmma, TMA, a two-stage kv ring), at
                               head widths 64, 128 and 256;
  ``flash_attention.cu``       ``attn_kernel``: f32 math on the CUDA cores,
                               float32 and bfloat16, head widths 16 to 256.

``ops.route`` decides which one a call takes.  The sources are compiled
with ``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes`` by
``kernels._build``.  Nothing is built or loaded when this module is
imported: machines without ``nvcc`` import it freely and run the plain
version in ``ref`` on CPU tensors.

The launcher takes raw, already-validated device tensors;
``ops.flash_attention`` owns the checks, the route and the output
allocation.
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from .. import _build

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: The source of each route.
SOURCES = {"sm90": CSRC / "flash_attention_sm90.cu",
           "simt": CSRC / "flash_attention.cu"}
#: The kernel each route launches (its name in a profiler trace).
KERNELS = {"sm90": "attn_sm90_kernel", "simt": "attn_kernel"}
#: (dtypes, head widths) each route's kernel is instantiated for.
TAKES = {"sm90": ((torch.bfloat16,), (64, 128, 256)),
         "simt": ((torch.float32, torch.bfloat16), (16, 32, 64, 128, 256))}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, out, B, S, T, Hq, Hkv, D, causal, q_offset, scale, stream
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
ENTRY = {"sm90": "flash_attention_sm90", "simt": "flash_attention"}


def build(route: str) -> _build.Library:
    """Compile (if needed) and load one route's library; idempotent.  Its
    entries: the launcher, ``<entry>_plan`` (B, S, T, Hq, Hkv, D, out: the
    launch geometry) and ``<entry>_attrs`` (D, smem, out: the kernel's
    attributes)."""
    dtypes = TAKES[route][0]
    return _build.build(SOURCES[route], {
        ENTRY[route]: (_ARGS, dtypes),
        ENTRY[route] + "_plan": ([_I] * 6 + [_P], dtypes),
        ENTRY[route] + "_attrs": ([_I, _I, _P], dtypes)})


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, route: str,
           q_offset: int = 0) -> None:
    """Enqueue ``route``'s kernel on the current stream: contiguous ``q (B,
    S, Hq, D)``, ``k``/``v (B, T, Hkv, D)`` and ``out`` like ``q``, one
    dtype; q's row ``s`` is key position ``s + q_offset``."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rc = build(route).fn(ENTRY[route], q.dtype)(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), B, S,
        T, Hq, Hkv, D, int(causal), int(q_offset), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, KERNELS[route])
