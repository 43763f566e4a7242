"""Wrapper of HPCG's 27-point operator, and its launch plan.

``apply_27pt(blocks, below, above)`` is ``y = A x`` over stacked z-slab
ranks, with the ghost planes the exchange returned.  For CPU tensors it is
the plain version in ``ref`` (the port's path before the kernel); for CUDA
tensors it is the CUDA kernel of ``csrc/stencil27.cu``, which reads each
slab where it lies and the two ghost planes, applies the Dirichlet zeros at
the y and x edges itself and writes ``y`` once.  There is no fallback: a
CUDA tensor launches the kernel or raises.  The two agree bit for bit.

``apply_27pt.launches`` counts the kernel's launches (a plain integer;
callers may reset it).  Under a capture (fake tensors, or any dispatch
mode) the checked call is the custom op ``repro_torch::apply_27pt``, so a
captured step holds the kernel as one node; outside one the op's body runs
as a plain call, as the bracket kernel's does.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode

from .. import _plan
from . import stencil27 as _cuda
from .ref import apply_27pt_ref

_FLOATS = (torch.float32, torch.float64)
#: ``stencil27_kernel``'s shape (``csrc/stencil27.cu``): a tile of
#: ``TX x TY`` points of the (y, x) plane a CTA, threads ``(TX, WARPS)``
#: each owning ``TY / WARPS`` rows, a ring of ``STAGES`` staged planes of
#: ``(TY + 2) x (TX + 2)``; z split into runs of at least ``MIN_RUN``
#: planes up to about ``TARGET_CTAS`` CTAs.
TX, TY, WARPS, STAGES = 32, 32, 8, 4
TARGET_CTAS, MIN_RUN = 4096, 8


def geometry(n: int, nz: int, ny: int, nx: int) -> tuple:
    """``(tiles_x, tiles_y, run, runs)``: the tiles of the (y, x) plane, and
    z cut into ``runs`` non-empty runs of ``run`` planes, as many as bring
    the grid to about :data:`TARGET_CTAS` CTAs with runs of at least
    :data:`MIN_RUN` planes (or one run of the whole slab)."""
    tiles_x, tiles_y = -(-nx // TX), -(-ny // TY)
    want = min(-(-TARGET_CTAS // (n * tiles_x * tiles_y)),
               max(1, nz // MIN_RUN))
    run = -(-nz // want)
    return tiles_x, tiles_y, run, -(-nz // run)


def plan(n: int, nz: int, ny: int, nx: int,
         itemsize: int = 8) -> _plan.LaunchPlan:
    """The launch ``stencil27_plan_*`` computes for ``n`` ranks of
    ``(nz, ny, nx)``: CTAs ``(tiles, z-runs, ranks)`` of ``(TX, WARPS)``
    threads, the ring in static shared memory."""
    tiles_x, tiles_y, _, runs = geometry(n, nz, ny, nx)
    ring = STAGES * (TY + 2) * (TX + 2) * itemsize
    return _plan.LaunchPlan(
        "stencil27_kernel", _plan.dim3(tiles_x * tiles_y, runs, n),
        _plan.dim3(TX, WARPS), static_smem=ring,
        buffers=(("plane ring", ring, "static"),))


def case_plan(case: dict) -> _plan.LaunchPlan:
    """The plan of an analysis case (``analysis.kernelcheck``): ``n``
    ranks of a ``slab`` ``(nz, ny, nx)`` in ``dtype``."""
    return plan(case["n"], *case["slab"],
                8 if case["dtype"] == "float64" else 4)


def _case_outputs(case: dict) -> dict:
    return {"y": (case["n"], *case["slab"])}


def _case_tiles(case: dict, p: _plan.LaunchPlan, cta) -> dict:
    """CTA ``(t, z, r)`` writes rank ``r``'s tile ``t`` (``t = ty x
    tiles_x + tx``) of every plane of run ``z``, clipped to the slab."""
    nz, ny, nx = case["slab"]
    tiles_x, _, run, _ = geometry(case["n"], nz, ny, nx)
    ty, tx = divmod(cta[0], tiles_x)
    z, r = cta[1] * run, cta[2]
    return {"y": [((r, r + 1), (z, min(z + run, nz)),
                   (ty * TY, min(ty * TY + TY, ny)),
                   (tx * TX, min(tx * TX + TX, nx)))]}


def _make_dataflow():
    from ...analysis.dataflow import DataflowContract
    return DataflowContract(("parallel",) * 3, case_plan, _case_outputs,
                            _case_tiles)


DATAFLOW = _make_dataflow()


def _check(blocks: torch.Tensor, below: torch.Tensor,
           above: torch.Tensor) -> None:
    if blocks.ndim != 4:
        raise ValueError(f"want blocks (n, nz, ny, nx); got "
                         f"{tuple(blocks.shape)}")
    n, _, ny, nx = blocks.shape
    for name, t in (("below", below), ("above", above)):
        if t.shape != (n, 1, ny, nx):
            raise ValueError(f"want {name} (n, 1, ny, nx) = "
                             f"{(n, 1, ny, nx)}; got {tuple(t.shape)}")
        if t.dtype != blocks.dtype or t.device != blocks.device:
            raise ValueError(f"{name} must share blocks' dtype and device; "
                             f"got {t.dtype} on {t.device} and "
                             f"{blocks.dtype} on {blocks.device}")
    if blocks.dtype not in _FLOATS:
        raise ValueError(f"apply_27pt takes float32/float64, got "
                         f"{blocks.dtype}")
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {blocks.device}")
    for name, t in (("blocks", blocks), ("below", below), ("above", above)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def apply_27pt(blocks: torch.Tensor, below: torch.Tensor,
               above: torch.Tensor) -> torch.Tensor:
    """HPCG's 27-point operator over stacked z-slab ranks.

    ``blocks``: contiguous ``(n, nz, ny, nx)`` float32/float64 slabs;
    ``below`` / ``above``: contiguous ``(n, 1, ny, nx)``, each rank's plane
    ``z = -1`` and ``z = nz`` (the exchange's, with its Dirichlet zeros at
    the ring's ends).  Returns ``y (n, nz, ny, nx)``: ``27 x`` minus the
    27 values around each point (the centre included), zeros outside
    ``[0, ny) x [0, nx)``, in the plain version's order.
    """
    _check(blocks, below, above)
    traced = isinstance(blocks, FakeTensor) \
        or _get_current_dispatch_mode() is not None
    return (apply_27pt_op if traced else _apply_27pt_body)(blocks, below,
                                                           above)


def _apply_27pt_body(blocks: torch.Tensor, below: torch.Tensor,
                     above: torch.Tensor) -> torch.Tensor:
    """The checked call: the plain version on the CPU, the kernel on the
    card.  As the op ``repro_torch::apply_27pt`` a capture records it as
    one node (its fake version gives the shape only, and launches and
    counts nothing)."""
    if blocks.device.type == "cpu":
        return apply_27pt_ref(blocks, below, above)
    y = torch.empty_like(blocks)
    if blocks.numel() == 0:
        return y
    _plan.refuse_grid("stencil27", plan(*blocks.shape).grid)
    with torch.cuda.device(blocks.device):
        _cuda.launch(blocks, below, above, y)
    apply_27pt.launches += 1
    return y


apply_27pt_op = torch.library.custom_op(
    "repro_torch::apply_27pt", mutates_args=())(_apply_27pt_body)


@apply_27pt_op.register_fake
def _(blocks, below, above):
    return torch.empty_like(blocks)


apply_27pt.launches = 0
