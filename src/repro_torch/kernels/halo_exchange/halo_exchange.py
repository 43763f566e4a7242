"""Build, load and launch the CUDA kernel of ``csrc/halo_exchange.cu``.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use and loaded
with ``ctypes`` by ``kernels._build``.  Nothing is built or loaded when this
module is imported: machines without ``nvcc`` import it freely and run the
plain version in ``ref`` on CPU tensors.

The launcher takes raw, already-validated device tensors;
``ops.ring_halo_exchange`` owns the checks, the output allocation, the
route, the unit width, the chunking and the handshake flags.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "halo_exchange.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FLOATS = (torch.float64, torch.float32)
#: The handshake routes, as the source numbers them.
ROUTES = {"cluster": 0, "flags": 1}
_SIGNATURES = {
    # strip_lo, strip_hi, stride_lo, stride_hi, P, n, chunks, route, vec,
    # recv_lo, recv_hi, flags, epoch, stream
    "halo_exchange": ([_P, _P, _L, _L, _L, _I, _I, _I, _I, _P, _P, _P, _L,
                       _P], _FLOATS),
    # vec, out: the flags route's CTAs that can be resident at once
    "halo_max_ctas": ([_I, _P], _FLOATS),
    # n, P, chunks, route, vec, out: the launch geometry (``_plan.c_plan``)
    "halo_exchange_plan": ([_I, _L, _I, _I, _I, _P], _FLOATS),
    # 2 x route + vec, smem, out: a kernel's attributes (``_plan.c_attrs``)
    "halo_exchange_attrs": ([_I, _I, _P], _FLOATS),
}


def build() -> _build.Library:
    """Compile (if needed) and load the kernel's library; idempotent."""
    return _build.build(SOURCE, _SIGNATURES)


def max_ctas(dtype: torch.dtype, vec: bool) -> int:
    """CTAs of the flags route's kernel (16-byte units if ``vec``) that the
    current device holds resident at once (0 when it cannot launch
    cooperatively)."""
    out = ctypes.c_int(0)
    rc = build().fn("halo_max_ctas", dtype)(int(vec), ctypes.byref(out))
    _build.check(rc, "halo_max_ctas")
    return out.value


def launch(strip_lo: torch.Tensor, strip_hi: torch.Tensor,
           recv_lo: torch.Tensor, recv_hi: torch.Tensor, route: str,
           vec: bool, chunks: int, flags: torch.Tensor | None,
           epoch: int) -> None:
    """Enqueue one launch of ``n x chunks`` CTAs on the current stream.
    ``strip_*`` are ``(n, ...)`` with each rank's strip contiguous (any rank
    stride); ``recv_*`` contiguous ``(n, ...)`` outputs; ``vec`` moves
    16-byte units (the caller has checked sizes, strides and addresses);
    on the ``"flags"`` route ``flags`` holds the int64 handshake flags and
    ``epoch`` is this launch's number on them (1, 2, ...)."""
    n = strip_lo.shape[0]
    rc = build().fn("halo_exchange", strip_lo.dtype)(
        _build.ptr(strip_lo), _build.ptr(strip_hi), strip_lo.stride(0),
        strip_hi.stride(0), recv_lo[0].numel(), n, chunks, ROUTES[route],
        int(vec), _build.ptr(recv_lo), _build.ptr(recv_hi),
        _build.ptr(flags), epoch,
        torch.cuda.current_stream(strip_lo.device).cuda_stream)
    _build.check(rc, "halo_exchange")
