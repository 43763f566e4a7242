"""The public wrapper of the selective-scan kernel.

``mamba_scan`` keeps the reference's contract (``repro.kernels.mamba_scan
.ops``): the same signature, x cast to float32, and ``d_block`` / ``chunk``
that must divide d and L, so the same calls fail.  The CUDA kernel picks
its own tiles (32 channels, 32-step chunks), so those two only shape the
checks.  It takes d a multiple of 4 and N = 16 (its TMA loads need rows of
16-byte multiples): other shapes are padded with zeros here and the
results cut back.  For CPU tensors it runs the plain version in ``ref``;
for CUDA tensors it launches the kernel or raises — it never falls back.
The kernel is forward-only, as in the JAX package: an input that requires
grad raises.

``mamba_scan.launches`` counts the kernel's launches (a plain integer;
callers may reset it).  The checked call is the custom op
``repro_torch::mamba_scan``, so a captured step (``core.graph.capture``)
holds the kernel as one node; a captured call launches and counts
nothing.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _plan
from . import mamba_scan as _cuda
from .ref import mamba_scan_ref

#: ``scan_kernel``'s tiles (``csrc/mamba_scan.cu``): channels per CTA,
#: threads per CTA, time steps per TMA load.
CHANNELS, THREADS, CHUNK = 32, 128, 32
#: its static shared memory: a two-chunk ring of (x, dt) 32 x 32 and
#: (Bt, Ct) 32 x 16 float tiles, the partial y of a chunk, two mbarriers
STATIC_SMEM = (("ring", 2 * (2 * CHUNK * CHANNELS + 2 * CHUNK * 16) * 4),
               ("partial y", CHUNK * THREADS * 4), ("mbarriers", 16))


def grid(B: int, d: int) -> tuple:
    """The launch's grid (``plan``'s and the wrapper's guard's): 32-channel
    blocks of ``d`` (padded to a multiple of 4), the batch on y."""
    return _plan.dim3(-(-d // CHANNELS), B)


def plan(B: int, L: int, d: int, N: int = 16) -> _plan.LaunchPlan:
    """The launch ``mamba_scan_plan_f32`` computes for the kernel's shapes:
    ``d`` channels (padded to a multiple of 4 by the wrapper), ``N`` 16
    states; its four TMA maps over x, dt (rows of ``d`` floats) and Bt, Ct
    (rows of 16)."""
    maps = tuple(_plan.TmaMap(name, (w, L, B), (w * 4, L * w * 4), (box, CHUNK,
                                                                  1), 4)
                 for name, w, box in (("x", d, CHANNELS), ("dt", d, CHANNELS),
                                      ("Bt", N, N), ("Ct", N, N)))
    return _plan.LaunchPlan(
        "scan_kernel", grid(B, d), _plan.dim3(THREADS),
        static_smem=sum(b for _, b in STATIC_SMEM),
        buffers=tuple((n, b, "static") for n, b in STATIC_SMEM), tma=maps)


def case_plan(case: dict) -> _plan.LaunchPlan:
    """The plan of an analysis case (``analysis.kernelcheck``): ``B``,
    ``L``, ``d`` (padded to a multiple of 4 as the wrapper pads it)."""
    return plan(case["B"], case["L"], case["d"] + -case["d"] % 4,
                _cuda.MAX_STATES)


def _case_outputs(case: dict) -> dict:
    B, L, d = case["B"], case["L"], case["d"] + -case["d"] % 4
    return {"y": (B, L, d), "h": (B, d, _cuda.MAX_STATES)}


def _case_tiles(case: dict, p: _plan.LaunchPlan, cta) -> dict:
    """CTA ``(x, b)`` walks channels ``32 x .. 32 x + 31`` of batch row
    ``b`` over every step, and writes their y and final state."""
    B, L, d = _case_outputs(case)["y"]
    ch0, b = cta[0] * CHANNELS, cta[1]
    ch = (ch0, min(ch0 + CHANNELS, d))
    return {"y": [((b, b + 1), (0, L), ch)],
            "h": [((b, b + 1), ch, (0, _cuda.MAX_STATES))]}


def _make_dataflow():
    from ...analysis.dataflow import DataflowContract
    return DataflowContract(("parallel",) * 3, case_plan, _case_outputs,
                            _case_tiles)


DATAFLOW = _make_dataflow()


def _check(x, dt, Bt, Ct, A, D, d_block: int, chunk: int, h0=None) -> None:
    if x.ndim != 3 or dt.shape != x.shape:
        raise ValueError(f"want x and dt (B, L, d); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}")
    Bsz, L, d = x.shape
    if A.ndim != 2 or A.shape[0] != d or D.shape != (d,):
        raise ValueError(f"want A (d, N) and D (d,) with d={d}; got "
                         f"{tuple(A.shape)}, {tuple(D.shape)}")
    N = A.shape[1]
    if Bt.shape != (Bsz, L, N) or Ct.shape != (Bsz, L, N):
        raise ValueError(f"want Bt and Ct {(Bsz, L, N)}; got "
                         f"{tuple(Bt.shape)}, {tuple(Ct.shape)}")
    ts = (x, dt, Bt, Ct, A, D)
    if h0 is not None:
        if h0.shape != (Bsz, d, N):
            raise ValueError(f"want h0 {(Bsz, d, N)}; got {tuple(h0.shape)}")
        ts += (h0,)
    if any(t.device != x.device for t in ts):
        raise ValueError("all inputs must lie on one device")
    db, lc = min(d_block, d), min(chunk, L)
    if db < 1 or lc < 1 or d % db or L % lc:
        raise ValueError(f"d_block and chunk must divide d and L: d={d}, "
                         f"L={L}, d_block={db}, chunk={lc}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("mamba_scan is forward-only: it has no backward "
                           "kernel; call it under torch.no_grad() or "
                           "torch.inference_mode()")


def mamba_scan(x, dt, Bt, Ct, A, D, d_block: int = 256, chunk: int = 256,
               h0=None):
    """Selective scan.  x/dt: (B, L, d); Bt/Ct: (B, L, N); A: (d, N);
    D: (d,); ``h0`` (B, d, N): the state before the first step (zero when
    ``None``: a later block of a sequence starts from the state the earlier
    blocks leave).  Returns (y (B, L, d), h_final (B, d, N)), float32."""
    _check(x, dt, Bt, Ct, A, D, d_block, chunk, h0)
    x = x.float()
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if dev.type == "cuda":
        if any(t.dtype != torch.float32 for t in (dt, Bt, Ct, A, D)) or (
                h0 is not None and h0.dtype != torch.float32):
            raise ValueError("mamba_scan takes float32 dt, Bt, Ct, A, D and "
                             "h0")
        if A.shape[1] > _cuda.MAX_STATES:
            raise ValueError(f"the kernel holds at most {_cuda.MAX_STATES} "
                             f"states per channel, got N={A.shape[1]}")
        Bsz, _, d = x.shape
        if x.numel():
            _plan.refuse_grid("scan_kernel", grid(Bsz, d + -d % 4))
    return mamba_scan_op(x, dt, Bt, Ct, A, D, h0)


@torch.library.custom_op("repro_torch::mamba_scan", mutates_args=())
def mamba_scan_op(x: torch.Tensor, dt: torch.Tensor, Bt: torch.Tensor,
                  Ct: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The checked call as one op (x already float32): the plain version
    on the CPU, the kernel on the card.  A capture records it as one node
    (its fake version gives the shapes only, and launches and counts
    nothing)."""
    dev = x.device
    if dev.type == "cpu":
        return mamba_scan_ref(x, dt, Bt, Ct, A, D, h0)
    N = A.shape[1]
    Bsz, L, d = x.shape
    if Bsz * L * d == 0:
        h = torch.zeros((Bsz, d, N), dtype=torch.float32, device=dev) \
            if h0 is None else h0.clone()
        return (torch.empty((Bsz, L, d), dtype=torch.float32, device=dev),
                h)
    pd, pn = -d % 4, _cuda.MAX_STATES - N
    if pd:
        x, dt = F.pad(x, (0, pd)), F.pad(dt, (0, pd))
        A, D = F.pad(A, (0, 0, 0, pd)), F.pad(D, (0, pd))
    if pn:
        Bt, Ct, A = F.pad(Bt, (0, pn)), F.pad(Ct, (0, pn)), F.pad(A, (0, pn))
    if h0 is not None and (pd or pn):
        h0 = F.pad(h0, (0, pn, 0, pd))
    ins = [_aligned(t) for t in (x, dt, Bt, Ct, A, D)]
    h0 = None if h0 is None else _aligned(h0)
    y = torch.empty((Bsz, L, d + pd), dtype=torch.float32, device=dev)
    h = torch.empty((Bsz, d + pd, _cuda.MAX_STATES), dtype=torch.float32,
                    device=dev)
    with torch.cuda.device(dev):
        _cuda.launch(*ins, y, h, h0)
    mamba_scan.launches += 1
    if pd or pn:
        y, h = y[..., :d].contiguous(), h[:, :d, :N].contiguous()
    return y, h


@mamba_scan_op.register_fake
def _(x, dt, Bt, Ct, A, D, h0=None):
    Bsz, L, d = x.shape
    return (x.new_empty((Bsz, L, d), dtype=torch.float32),
            x.new_empty((Bsz, d, A.shape[1]), dtype=torch.float32))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary (TMA's rule)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


mamba_scan.launches = 0
