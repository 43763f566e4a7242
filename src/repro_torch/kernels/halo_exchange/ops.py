"""Wrappers of the message-free halo exchange, and its dispatcher.

``exchange_planes_1d`` is HPCG's message-free exchange.  For CPU tensors it
is exactly ``comm.message_free.exchange_planes_1d`` (the shared-window
emulation, what the JAX package runs on every backend but its own chip).
For CUDA tensors it is the CUDA kernel of ``csrc/halo_exchange.cu``, which
writes each rank's boundary planes straight into its neighbours' receive
windows under a flag handshake (what the JAX dispatcher does on the TPU).
The exchanged planes are copies either way, so the two give bit-identical
results.  There is no fallback: a CUDA tensor launches the kernel or
raises.

``ring_halo_exchange.launches`` counts the kernel's launches (a plain
integer; callers may reset it).
"""
from __future__ import annotations

import math

import torch

from ...comm import message_free
from . import halo_exchange as _cuda
from .ref import ring_exchange_collective, ring_halo_exchange_ref

_FLOATS = (torch.float32, torch.float64)
#: Elements of one strip that one CTA moves at least (4 KiB in f32), so that
#: the handshake is paid over enough bytes.
MIN_CHUNK = 1024

#: Co-resident CTA limit per (device index, dtype); handshake flags per
#: (device index, stream, n, chunks) as ``[flags, epoch]``.  Launches on one
#: stream run in order, so one flag buffer per stream is never shared by two
#: launches at once.
_MAX_CTAS: dict = {}
_FLAGS: dict = {}


def _rank_strip_contiguous(t: torch.Tensor) -> bool:
    return t[0].is_contiguous() if t.shape[0] else True


def _chunks(n: int, p: int, dev: torch.device, dtype) -> int:
    key = (dev.index, dtype)
    if key not in _MAX_CTAS:
        _MAX_CTAS[key] = _cuda.max_ctas(dtype)
    limit = _MAX_CTAS[key]
    if limit < n:
        raise RuntimeError(f"ring_halo_exchange: {n} ranks need {n} CTAs "
                           f"resident at once; {dev} holds {limit}")
    return max(1, min(math.ceil(p / MIN_CHUNK), limit // n))


def ring_halo_exchange(strip_lo: torch.Tensor, strip_hi: torch.Tensor):
    """Message-free ring exchange over stacked ranks.

    ``strip_lo`` / ``strip_hi``: ``(n, ...)`` float32/float64, each rank's
    low and high boundary strip (a rank's strip contiguous, any stride
    between ranks, so ``blocks[:, 0]`` is read in place).  Returns
    (from_prev, from_next), contiguous ``(n, ...)``: ``from_prev[r] =
    strip_hi[r - 1]``, ``from_next[r] = strip_lo[r + 1]`` on a ring.
    """
    if strip_lo.shape != strip_hi.shape or strip_lo.dtype != strip_hi.dtype \
            or strip_lo.device != strip_hi.device:
        raise ValueError("strip_lo and strip_hi must share shape, dtype and "
                         f"device; got {tuple(strip_lo.shape)} "
                         f"{strip_lo.dtype} {strip_lo.device} and "
                         f"{tuple(strip_hi.shape)} {strip_hi.dtype} "
                         f"{strip_hi.device}")
    if strip_lo.ndim < 1:
        raise ValueError("strips need a leading rank axis")
    dev = strip_lo.device
    if dev.type == "cpu":
        return ring_halo_exchange_ref(strip_lo, strip_hi)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if strip_lo.dtype not in _FLOATS:
        raise ValueError(f"ring_halo_exchange takes float32/float64, got "
                         f"{strip_lo.dtype}")
    if not (_rank_strip_contiguous(strip_lo)
            and _rank_strip_contiguous(strip_hi)):
        raise ValueError("each rank's strip must be contiguous")
    n = strip_lo.shape[0]
    recv_lo = torch.empty(strip_lo.shape, dtype=strip_lo.dtype, device=dev)
    recv_hi = torch.empty_like(recv_lo)
    p = recv_lo[0].numel() if n else 0
    if n == 0 or p == 0:
        return recv_lo, recv_hi
    with torch.cuda.device(dev):
        chunks = _chunks(n, p, dev, strip_lo.dtype)
        stream = torch.cuda.current_stream(dev).cuda_stream
        key = (dev.index, stream, n, chunks)
        if key not in _FLAGS:
            _FLAGS[key] = [torch.zeros(2 * n * chunks, dtype=torch.int64,
                                       device=dev), 0]
        state = _FLAGS[key]
        state[1] += 1
        _cuda.launch(strip_lo, strip_hi, recv_lo, recv_hi, state[0], chunks,
                     state[1])
    ring_halo_exchange.launches += 1
    return recv_lo, recv_hi


ring_halo_exchange.launches = 0


def exchange_planes_1d(blocks: torch.Tensor):
    """(below, above) boundary planes from the ring neighbours, each
    ``(n, 1, ...)`` for ``blocks`` of ``(n, nz, ...)``: the drop-in
    message-free counterpart of ``comm.message_based.exchange_planes_1d``.
    """
    if blocks.device.type == "cpu":
        return message_free.exchange_planes_1d(blocks)
    from_prev, from_next = ring_halo_exchange(blocks[:, 0], blocks[:, -1])
    return from_prev[:, None], from_next[:, None]


def exchange_planes_1d_oracle(blocks: torch.Tensor):
    """ppermute-style reference with the same signature (for validation)."""
    lo, hi = blocks[:, :1], blocks[:, -1:]
    from_prev, from_next = ring_exchange_collective((hi, lo))
    # from_prev carries the left neighbour's hi plane; from_next the right
    # neighbour's lo plane.
    return from_prev[0], from_next[1]
