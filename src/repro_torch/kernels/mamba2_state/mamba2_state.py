"""Build, load and launch the CUDA kernel of ``csrc/mamba2_state.cu``.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use and loaded
with ``ctypes`` by ``kernels._build``.  Nothing is built or loaded when this
module is imported: machines without ``nvcc`` import it freely and run the
plain version in ``ref`` on CPU tensors.

The launcher takes raw, already-validated device tensors;
``ops.mamba2_state_update`` owns the checks and the output allocation.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "mamba2_state.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # ssm, x, dt, Bt, Ct, A_log, D, out, y, strides (14 int64); b, H, P, N,
    # G; stream
    "mamba2_state": ([_P] * 10 + [_I] * 5 + [_P], (torch.float32,)),
    # b, H, P, N, out: the launch geometry (``_plan.c_plan``)
    "mamba2_state_plan": ([_I] * 4 + [_P], (torch.float32,)),
    # variant, smem, out: the kernel's attributes (``_plan.c_attrs``)
    "mamba2_state_attrs": ([_I, _I, _P], (torch.float32,)),
}


def build() -> _build.Library:
    """Compile (if needed) and load the kernel's library; idempotent."""
    return _build.build(SOURCE, _SIGNATURES)


def launch(ssm, x, dt, Bt, Ct, A_log, D, out, y) -> None:
    """Enqueue one launch on the current stream: float32 ``ssm (b, H, P,
    N)`` with ``n`` packed and its rows on 16-byte boundaries; ``x (b, H,
    P)``, ``dt (b, H)``, ``Bt`` / ``Ct (b, G, N)`` of any strides;
    contiguous ``A_log``, ``D (H,)`` and the outputs ``out (b, H, P, N)``
    and ``y (b, H, P)``."""
    b, H, P, N = ssm.shape
    strides = (ctypes.c_longlong * 14)(*ssm.stride()[:3], *x.stride(),
                                       *dt.stride(), *Bt.stride(),
                                       *Ct.stride())
    rc = build().fn("mamba2_state", torch.float32)(
        *(_build.ptr(t) for t in (ssm, x, dt, Bt, Ct, A_log, D, out, y)),
        strides, b, H, P, N, Bt.shape[1],
        torch.cuda.current_stream(ssm.device).cuda_stream)
    _build.check(rc, "mamba2_state")
