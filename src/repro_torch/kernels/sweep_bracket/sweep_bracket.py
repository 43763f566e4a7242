"""Build, load and launch the CUDA kernels of ``csrc/sweep_bracket.cu``.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use and loaded
with ``ctypes`` by ``kernels._build``.  Nothing is built or loaded when this
module is imported: machines without ``nvcc`` import it freely and run the
plain versions in ``ref`` on CPU tensors.

The launchers here take raw, already-validated device tensors;
``ops.fused_bracket_segsum`` and ``ops.segment_sum`` own the checks, the
CSR preparation and the output allocation.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "sweep_bracket.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
_FLOATS = (torch.float64, torch.float32)
_SIGNATURES = {
    # (pairs, offsets, bounds, n) x 3, delta, cxl, S, n_seg, resident,
    # 4 outputs, stream
    "sweep_bracket": ([_P, _P, _P, _I] * 3 + [_P, _P, _I, _I, _I]
                      + [_P] * 5, _FLOATS),
    # x, rows, n, offsets, perm, n_seg, out, stream
    "segsum": ([_P, _I, _I, _P, _P, _I, _P, _P], _FLOATS),
}


def build() -> _build.Library:
    """Compile (if needed) and load the kernels' library; idempotent."""
    return _build.build(SOURCE, _SIGNATURES)


def launch_bracket(groups, delta: torch.Tensor, cxl: torch.Tensor,
                   n_seg: int, resident: bool, outs) -> None:
    """Enqueue the fused bracket kernel on the current stream.  ``groups``
    are three ``(pairs, offsets, bounds)`` tuples: ``(n, 2)`` (lat, w)
    pairs in site order, 16-byte aligned, n even; ``(n_seg + 1,)`` int32
    CSR offsets; ``(n_seg, 2)`` (min, max) lat per site.  ``resident``
    keeps the pairs whole in shared memory (else the tiled path); ``outs``
    four preallocated ``(S, n_seg)`` tensors."""
    lib = build()
    args = []
    for pairs, offsets, bounds in groups:
        args += [_build.ptr(pairs), _build.ptr(offsets), _build.ptr(bounds),
                 pairs.shape[0]]
    stream = torch.cuda.current_stream(delta.device).cuda_stream
    rc = lib.fn("sweep_bracket", delta.dtype)(
        *args, _build.ptr(delta), _build.ptr(cxl), delta.shape[0], n_seg,
        int(resident), *(_build.ptr(o) for o in outs), stream)
    _build.check(rc, "sweep_bracket")


def launch_segsum(x: torch.Tensor, offsets: torch.Tensor,
                  perm: torch.Tensor | None, n_seg: int,
                  out: torch.Tensor) -> None:
    """Enqueue the CSR segment-sum kernel: ``x (rows, n)`` -> ``out (rows,
    n_seg)``."""
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fn("segsum", x.dtype)(
        _build.ptr(x), x.shape[0], x.shape[1], _build.ptr(offsets),
        _build.ptr(perm), n_seg, _build.ptr(out), stream)
    _build.check(rc, "segsum")
