"""Wrapper of one Mamba-2 decode step's state update and readout, and its
launch plan.

``mamba2_state_update(ssm, x, dt, Bt, Ct, A_log, D)`` is the body of
``models.mamba2.mamba2_decode``'s span ``lm.mamba2.state``: per row and
head, the float32 state times its decay ``exp(dt A)``, plus ``dt x (x)
B``, read out against ``C``, plus ``D x``.  For CPU tensors it is the
plain version in ``ref`` (the port's path before the kernel); for CUDA
tensors it is the CUDA kernel of ``csrc/mamba2_state.cu``, which reads the
state once and writes the new one once.  There is no fallback: a CUDA
tensor launches the kernel or raises.  The given state is never written.

The inputs may be views, and no copy is made: ``x``, ``Bt`` and ``Ct``
are ``split``\\ s of the conv's output, whose layout the einsum before it
chooses (batch-innermost, on the CPU and on the card), so the kernel takes
their strides, and ``dt``'s, as they are.  The state is read 16 bytes at
a time: its last dimension must be packed and each of its ``(b, h, p)``
rows must start on a 16-byte boundary, whatever the strides between them
(a state straight from the chunked prefill is strided across ``b`` and
``h``).  The CPU path holds its inputs to the same contract.  Nothing is
captured: no capture runs a Mamba-2 decode, and a fake tensor raises.

``mamba2_state_update.launches`` counts the kernel's launches (a plain
integer; callers may reset it).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from .. import _plan
from . import mamba2_state as _cuda
from .ref import mamba2_state_update_ref

#: ``mamba2_state_kernel``'s shape (``csrc/mamba2_state.cu``): a thread
#: holds ``ROWS`` rows of a ``(b, h)`` tile at once, a CTA has at most
#: ``WARPS`` warps.
ROWS, WARPS = 8, 8
#: its static shared memory: B and C of a tile's group, up to 128 each.
STATIC_SMEM = 2 * 128 * 4


def geometry(P: int, N: int) -> tuple:
    """``(lanes, warps, passes)``: ``N / 4`` lanes a row (four states a
    lane), warps enough that a thread has at most :data:`ROWS` of the
    tile's ``P`` rows (up to :data:`WARPS`; past that a thread takes its
    rows :data:`ROWS` at a time), and the rows a thread has.  Raises
    ``ValueError`` on an ``N`` the kernel does not take."""
    lanes = N // 4
    if N % 4 or not 1 <= lanes <= 32 or lanes & (lanes - 1):
        raise ValueError(f"mamba2_state takes N = 4 x a power of two up to "
                         f"128; got N {N}")
    slots = -(-P // (32 // lanes))
    warps = min(WARPS, -(-slots // ROWS))
    return lanes, warps, -(-slots // warps)


def plan(b: int, H: int, P: int, N: int) -> _plan.LaunchPlan:
    """The launch ``mamba2_state_plan_f32`` computes: CTAs ``(H, b)``, one
    a ``(b, h)`` tile, of ``32 x warps`` threads; B and C of the tile's
    group in static shared memory."""
    _, warps, _ = geometry(P, N)
    return _plan.LaunchPlan("mamba2_state_kernel", _plan.dim3(H, b),
                            _plan.dim3(32 * warps), static_smem=STATIC_SMEM,
                            buffers=(("B and C", STATIC_SMEM, "static"),))


def case_plan(case: dict) -> _plan.LaunchPlan:
    """The plan of an analysis case (``analysis.kernelcheck``): ``b`` rows
    of ``H`` heads of ``(P, N)``."""
    return plan(case["b"], case["H"], case["P"], case["N"])


def _case_outputs(case: dict) -> dict:
    b, H, P, N = (case[k] for k in ("b", "H", "P", "N"))
    return {"out": (b, H, P, N), "y": (b, H, P)}


def _case_tiles(case: dict, p: _plan.LaunchPlan, cta) -> dict:
    """CTA ``(h, b)`` writes row ``b``'s head ``h``: its whole ``(P, N)``
    tile of the new state and its ``P`` outputs."""
    h, b = cta[0], cta[1]
    P, N = case["P"], case["N"]
    return {"out": [((b, b + 1), (h, h + 1), (0, P), (0, N))],
            "y": [((b, b + 1), (h, h + 1), (0, P))]}


def _make_dataflow():
    from ...analysis.dataflow import DataflowContract
    return DataflowContract(("parallel",) * 3, case_plan, _case_outputs,
                            _case_tiles)


DATAFLOW = _make_dataflow()


def _rows_aligned(t: torch.Tensor) -> bool:
    """``t``'s last dimension is packed and its rows lie 16 bytes apart:
    every other stride a multiple of 4 floats (sizes of 1 aside)."""
    return (t.shape[-1] == 1 or t.stride(-1) == 1) \
        and all(size == 1 or stride % 4 == 0
                for size, stride in zip(t.shape[:-1], t.stride()[:-1]))


def _check(ssm, x, dt, Bt, Ct, A_log, D) -> None:
    if ssm.ndim != 4 or Bt.ndim != 3:
        raise ValueError(f"want ssm (b, H, P, N) and Bt (b, G, N); got "
                         f"{tuple(ssm.shape)} and {tuple(Bt.shape)}")
    b, H, P, N = ssm.shape
    G = Bt.shape[1]
    given = {"ssm": (ssm, (b, H, P, N)), "x": (x, (b, H, P)),
             "dt": (dt, (b, H)), "Bt": (Bt, (b, G, N)), "Ct": (Ct, (b, G, N)),
             "A_log": (A_log, (H,)), "D": (D, (H,))}
    for name, (t, want) in given.items():
        if tuple(t.shape) != want:
            raise ValueError(f"want {name} {want}; got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"mamba2_state takes float32; {name} is "
                             f"{t.dtype}")
        if t.device != ssm.device:
            raise ValueError(f"{name} is on {t.device}, ssm on "
                             f"{ssm.device}")
    if ssm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {ssm.device}")
    if not _rows_aligned(ssm):
        raise ValueError("ssm's last dimension must be packed and its rows "
                         "on 16-byte boundaries")
    if not (A_log.is_contiguous() and D.is_contiguous()):
        raise ValueError("A_log and D must be contiguous")
    if not G or H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")


def mamba2_state_update(ssm: torch.Tensor, x: torch.Tensor,
                        dt: torch.Tensor, Bt: torch.Tensor, Ct: torch.Tensor,
                        A_log: torch.Tensor, D: torch.Tensor) -> tuple:
    """One decode step's state update and readout.

    ``ssm (b, H, P, N)``: the state, ``n`` packed and each row on a
    16-byte boundary; ``x (b, H, P)``; ``dt (b, H)``, after the softplus;
    ``Bt`` / ``Ct (b, G, N)``, head ``h`` reading group ``h // (H / G)``;
    contiguous ``A_log`` / ``D (H,)``; all float32.  Returns ``y (b, H,
    P)`` and the new state ``(b, H, P, N)``, both contiguous; ``ssm`` is
    not written.
    """
    _check(ssm, x, dt, Bt, Ct, A_log, D)
    if ssm.device.type == "cpu":
        return mamba2_state_update_ref(ssm, x, dt, Bt, Ct, A_log, D)
    if isinstance(ssm, FakeTensor):
        raise ValueError("mamba2_state has no fake version: nothing "
                         "captures a Mamba-2 decode")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (ssm, x, dt, Bt, Ct, A_log, D)):
        raise RuntimeError("mamba2_state is forward-only: it has no "
                           "backward kernel; call it under torch.no_grad() "
                           "or torch.inference_mode()")
    if ssm.data_ptr() % 16:
        raise ValueError("ssm's rows must start on 16-byte boundaries")
    b, H, P, N = ssm.shape
    out = torch.empty((b, H, P, N), dtype=torch.float32, device=ssm.device)
    y = torch.empty((b, H, P), dtype=torch.float32, device=ssm.device)
    if ssm.numel() == 0:
        return y, out
    _plan.refuse_grid("mamba2_state", plan(b, H, P, N).grid)
    with torch.cuda.device(ssm.device):
        _cuda.launch(ssm, x, dt, Bt, Ct, A_log, D, out, y)
    mamba2_state_update.launches += 1
    return y, out


mamba2_state_update.launches = 0
