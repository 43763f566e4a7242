"""Message-based (MPI-analog) halo exchange on stacked ranks.

The JAX package sends each strip with ``jax.lax.ppermute`` (a
collective-permute, the MPI send/recv pair).  Here the ranks are leading
tensor axes of one tensor, and a ppermute becomes a copy of every sender's
strip into a separate receive buffer, at the position of its receiver.
"""
from __future__ import annotations

import functools

import torch

from . import collectives, counters
from .topology import shift_perm


@functools.lru_cache(maxsize=64)
def _sources(perm: tuple, n: int) -> tuple:
    """The source rank of every destination."""
    src = [0] * n
    for i, j in perm:
        src[j] = i
    return tuple(src)


def ppermute(x: torch.Tensor, dim: int, perm,
             rank_axes: int | None = None) -> torch.Tensor:
    """Copy ``x``'s rank slices along ``dim`` into a new buffer by the
    (source, destination) pairs of ``perm``; every destination gets one.

    ``rank_axes`` is the number of leading axes of ``x`` that are ranks
    (``dim + 1`` by default): a capture divides the tensor's bytes by
    their product to give one rank's strip.  One ``repro_torch::ppermute``
    op (``comm.collectives``)."""
    return collectives.ppermute(
        x, dim, _sources(tuple(map(tuple, perm)), x.shape[dim]),
        dim + 1 if rank_axes is None else rank_axes)


def exchange_halos_2d(tiles: torch.Tensor):
    """Exchange N/S/W/E boundary strips with grid neighbours.

    ``tiles`` is ``(px, py, h, w)``: every rank's tile.  Returns (north,
    south, west, east), ``(px, py, 1, w)`` and ``(px, py, h, 1)``, the
    strips each rank received, cyclic at the grid edge (callers mask the
    edges).  Four transfers per step, the four MPI send/recv call-sites of
    the paper's heat-transfer code (Sec. V-C).
    """
    nx, ny = tiles.shape[:2]
    top, bottom = tiles[:, :, :1, :], tiles[:, :, -1:, :]
    left, right = tiles[..., :1], tiles[..., -1:]
    # north: receive the southern row of the northern neighbour, etc.
    north = ppermute(bottom, 0, shift_perm(nx, +1), rank_axes=2)
    south = ppermute(top, 0, shift_perm(nx, -1), rank_axes=2)
    west = ppermute(right, 1, shift_perm(ny, +1), rank_axes=2)
    east = ppermute(left, 1, shift_perm(ny, -1), rank_axes=2)
    counters.count("halos_2d", "message_based", (north, south, west, east))
    return north, south, west, east


def exchange_planes_1d(blocks: torch.Tensor):
    """Exchange the +/-1 boundary planes along a 1D slab decomposition.

    ``blocks`` is ``(n, nz, ...)``; returns (below, above), each
    ``(n, 1, ...)``: rank i's neighbour planes from ranks i-1 and i+1 (HPCG's
    z-slabs)."""
    n = blocks.shape[0]
    below = ppermute(blocks[:, -1:], 0, shift_perm(n, +1))
    above = ppermute(blocks[:, :1], 0, shift_perm(n, -1))
    counters.count("planes_1d", "message_based", (below, above))
    return below, above
