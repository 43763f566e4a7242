"""Message-free (CXL.mem-analog) halo exchange through a shared boundary
window, on stacked ranks.

Every rank *publishes* its boundary strips into a window that all ranks can
address, then each rank *reads* the entries it needs directly: no
per-message matching, only a producer/consumer handshake.  In the JAX
package the window is an ``all_gather`` of the strips; with the ranks
stacked on one device it is the stacked strips themselves, and a read is an
index into them.

The chip-native form, in which each rank writes its strips straight into
its neighbours' receive windows under a flag handshake (the paper's
2 x CXL_ATOMIC_LAT of Eq. 2), is the CUDA kernel of
``repro_torch.kernels.halo_exchange``; HPCG's message-free exchange takes it
on the card.
"""
from __future__ import annotations

import torch

from . import counters


def _shifted(n: int, delta: int, device) -> torch.Tensor:
    """``(i + delta) % n`` for every rank i."""
    return (torch.arange(n, device=device) + delta) % n


def publish_boundaries_2d(tiles: torch.Tensor):
    """Publish every rank's 4 boundary strips; returns the global window.

    ``tiles`` is ``(px, py, h, w)``.  The row window is ``(px, py, 2, w)``
    (top and bottom rows), the column window ``(px, py, 2, h)`` (left and
    right columns).
    """
    rows = torch.stack([tiles[:, :, 0, :], tiles[:, :, -1, :]], dim=2)
    cols = torch.stack([tiles[..., 0], tiles[..., -1]], dim=2)
    return rows, cols


def read_halos_2d(row_window: torch.Tensor, col_window: torch.Tensor):
    """Each rank reads its neighbours' strips straight out of the window:
    (north, south, west, east), ``(px, py, 1, w)`` and ``(px, py, h, 1)``."""
    nx, ny = row_window.shape[:2]
    dev = row_window.device
    north = row_window[_shifted(nx, -1, dev), :, 1, :]   # bottom row of ix-1
    south = row_window[_shifted(nx, +1, dev), :, 0, :]   # top row of ix+1
    west = col_window[:, _shifted(ny, -1, dev), 1, :]    # right col of iy-1
    east = col_window[:, _shifted(ny, +1, dev), 0, :]    # left col of iy+1
    return (north[:, :, None, :], south[:, :, None, :],
            west[..., None], east[..., None])


def exchange_halos_2d(tiles: torch.Tensor):
    """publish + read: the full message-free exchange."""
    halos = read_halos_2d(*publish_boundaries_2d(tiles))
    counters.count("halos_2d", "message_free", halos)
    return halos


def exchange_planes_1d(blocks: torch.Tensor):
    """1D slab variant: publish both boundary planes, read the neighbours'.

    ``blocks`` is ``(n, nz, ...)``; returns (below, above), each
    ``(n, 1, ...)``."""
    n = blocks.shape[0]
    window = torch.stack([blocks[:, 0], blocks[:, -1]], dim=1)  # (n, 2, ...)
    below = window[_shifted(n, -1, blocks.device), 1]
    above = window[_shifted(n, +1, blocks.device), 0]
    planes = below[:, None], above[:, None]
    counters.count("planes_1d", "message_free", planes)
    return planes
