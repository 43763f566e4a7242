"""Plain versions of the message-free ring exchange.

The kernel's contract, written with plain tensor operations over the
stacked ranks: each rank receives its ring neighbours' boundary strips.
They hold the CUDA kernel (on the card) and the shared-window emulation
(anywhere) to account; nothing on the card's path runs them.
"""
from __future__ import annotations

import torch

from ...comm.message_based import ppermute
from ...comm.topology import shift_perm


def ring_exchange_ref(strips: torch.Tensor) -> tuple:
    """Single-program oracle over the stacked per-rank strips.

    ``strips``: ``(n_ranks, ...)``, each rank's published boundary value.
    Returns (from_prev, from_next), each of the same shape: what rank i
    receives from rank i-1 / i+1 on a ring.
    """
    return torch.roll(strips, 1, 0), torch.roll(strips, -1, 0)


def ring_halo_exchange_ref(strip_lo: torch.Tensor,
                           strip_hi: torch.Tensor) -> tuple:
    """The kernel's plain version: (from_prev, from_next) with
    ``from_prev[r] = strip_hi[r - 1]`` and ``from_next[r] =
    strip_lo[r + 1]`` (ring indices), gathered by rank index."""
    ranks = torch.arange(strip_lo.shape[0], device=strip_lo.device)
    n = max(strip_lo.shape[0], 1)
    return (strip_hi.index_select(0, (ranks - 1) % n),
            strip_lo.index_select(0, (ranks + 1) % n))


def ring_exchange_collective(strips) -> tuple:
    """ppermute-style reference (the message-based analog) on stacked
    ranks: ``strips`` is a tensor or a tuple of tensors with the rank axis
    leading; returns (from_prev, from_next) of the same structure."""
    if isinstance(strips, tuple):
        pairs = [ring_exchange_collective(s) for s in strips]
        return tuple(p for p, _ in pairs), tuple(q for _, q in pairs)
    n = strips.shape[0]
    return (ppermute(strips, 0, shift_perm(n, +1)),
            ppermute(strips, 0, shift_perm(n, -1)))
