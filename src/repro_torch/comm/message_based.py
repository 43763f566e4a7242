"""Message-based (MPI-analog) halo exchange on stacked ranks.

The JAX package sends each strip with ``jax.lax.ppermute`` (a
collective-permute, the MPI send/recv pair).  Here the ranks are leading
tensor axes of one tensor, and a ppermute becomes a copy of every sender's
strip into a separate receive buffer, at the position of its receiver.
"""
from __future__ import annotations

import functools

import torch

from .topology import shift_perm


@functools.lru_cache(maxsize=64)
def _sources(perm: tuple, n: int, device: torch.device) -> torch.Tensor:
    """The source rank of every destination, on ``device``.  Cached, so a
    step copies no index from the host (a copy from pageable host memory
    would wait for the card to drain its queue)."""
    src = [0] * n
    for i, j in perm:
        src[j] = i
    return torch.tensor(src, device=device)


def ppermute(x: torch.Tensor, dim: int, perm) -> torch.Tensor:
    """Copy ``x``'s rank slices along ``dim`` into a new buffer by the
    (source, destination) pairs of ``perm``; every destination gets one."""
    perm = tuple(map(tuple, perm))
    return x.index_select(dim, _sources(perm, x.shape[dim], x.device))


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
    north = ppermute(bottom, 0, shift_perm(nx, +1))
    south = ppermute(top, 0, shift_perm(nx, -1))
    west = ppermute(right, 1, shift_perm(ny, +1))
    east = ppermute(left, 1, shift_perm(ny, -1))
    return north, south, west, east


def exchange_planes_1d(blocks: torch.Tensor):
    """Exchange the +/-1 boundary planes along a 1D slab decomposition.

    ``blocks`` is ``(n, nz, ...)``; returns (below, above), each
    ``(n, 1, ...)``: rank i's neighbour planes from ranks i-1 and i+1 (HPCG's
    z-slabs)."""
    n = blocks.shape[0]
    below = ppermute(blocks[:, -1:], 0, shift_perm(n, +1))
    above = ppermute(blocks[:, :1], 0, shift_perm(n, -1))
    return below, above
