"""Build, load and launch the CUDA kernel of ``csrc/stencil27.cu``.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use and loaded
with ``ctypes`` by ``kernels._build``.  Nothing is built or loaded when this
module is imported: machines without ``nvcc`` import it freely and run the
plain version in ``ref`` on CPU tensors.

The launcher takes raw, already-validated device tensors;
``ops.apply_27pt`` owns the checks and the output allocation.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "stencil27.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
_FLOATS = (torch.float64, torch.float32)
_SIGNATURES = {
    # x, below, above, y, n, nz, ny, nx, stream
    "stencil27": ([_P] * 4 + [_I] * 4 + [_P], _FLOATS),
    # n, nz, ny, nx, out: the launch geometry (``_plan.c_plan``)
    "stencil27_plan": ([_I] * 4 + [_P], _FLOATS),
    # variant, smem, out: the kernel's attributes (``_plan.c_attrs``)
    "stencil27_attrs": ([_I, _I, _P], _FLOATS),
}


def build() -> _build.Library:
    """Compile (if needed) and load the kernel's library; idempotent."""
    return _build.build(SOURCE, _SIGNATURES)


def launch(blocks: torch.Tensor, below: torch.Tensor, above: torch.Tensor,
           y: torch.Tensor) -> None:
    """Enqueue one launch on the current stream: contiguous ``blocks`` and
    ``y`` of ``(n, nz, ny, nx)``, contiguous ghost planes ``below`` /
    ``above`` of ``(n, 1, ny, nx)``, one float type."""
    n, nz, ny, nx = blocks.shape
    rc = build().fn("stencil27", blocks.dtype)(
        _build.ptr(blocks), _build.ptr(below), _build.ptr(above),
        _build.ptr(y), n, nz, ny, nx,
        torch.cuda.current_stream(blocks.device).cuda_stream)
    _build.check(rc, "stencil27")
