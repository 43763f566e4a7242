"""2D heat-transfer stencil in PyTorch with selectable communication backend.

The paper's first use case (Sec. V-C): a 5-point Jacobi update over an
``(H, W)`` plane split on a ``px`` x ``py`` grid of ranks, halos exchanged
either message-based (ppermute-style copies, the MPI analog) or message-free
(a shared boundary window, the CXL.mem analog).  The counterpart of
``repro.apps.stencil.jax_impl``: the ranks are the leading axes of one
``(px, py, h, w)`` tensor of tiles on the grid's device instead of the
shards of a ``shard_map``.  Both backends give bit-identical physics; only
the exchange differs.  The JAX package has no kernel for this exchange, so
``"message_free"`` runs ``comm.message_free`` on every device.
"""
from __future__ import annotations

from typing import Literal

import torch
import torch.nn.functional as F

from ... import spans
from ...comm import message_based, message_free
from ...comm.topology import RankGrid

Backend = Literal["message_based", "message_free"]


def to_tiles(plane, grid: RankGrid) -> torch.Tensor:
    """Global ``(H, W)`` plane (array or tensor) -> ``(px, py, H/px, W/py)``
    tiles on the grid's device, as ``P(px, py)`` splits it."""
    plane = torch.as_tensor(plane, device=grid.device)
    H, W = plane.shape
    if H % grid.px or W % grid.py:
        raise ValueError(f"plane {H}x{W} does not split over a "
                         f"{grid.px}x{grid.py} grid")
    h, w = H // grid.px, W // grid.py
    return plane.reshape(grid.px, h, grid.py, w).permute(0, 2, 1, 3) \
        .contiguous()


def from_tiles(tiles: torch.Tensor) -> torch.Tensor:
    """``(px, py, h, w)`` tiles -> the global ``(px*h, py*w)`` plane."""
    px, py, h, w = tiles.shape
    return tiles.permute(0, 2, 1, 3).reshape(px * h, py * w)


@spans.spanned("heat.update")
def _step_local(tiles, halos):
    """One Jacobi update of every rank's tile given its received halos.

    Halos arriving across the periodic seam at the true domain edge are
    replaced by the insulating boundary (a copy of the tile's own edge),
    reproducing the non-periodic physics of the paper's miniapp.  The halo
    tensors are the exchange's own fresh buffers and are edited in place.
    """
    north, south, west, east = halos
    north[0] = tiles[0, :, :1, :]          # ix == 0
    south[-1] = tiles[-1, :, -1:, :]       # ix == nx - 1
    west[:, 0] = tiles[:, 0, :, :1]        # iy == 0
    east[:, -1] = tiles[:, -1, :, -1:]     # iy == ny - 1

    padded = F.pad(tiles, (1, 1, 1, 1))
    padded[:, :, 0, 1:-1] = north[:, :, 0]
    padded[:, :, -1, 1:-1] = south[:, :, 0]
    padded[:, :, 1:-1, 0] = west[..., 0]
    padded[:, :, 1:-1, -1] = east[..., 0]
    return 0.25 * (padded[:, :, :-2, 1:-1] + padded[:, :, 2:, 1:-1]
                   + padded[:, :, 1:-1, :-2] + padded[:, :, 1:-1, 2:])


def make_step(grid: RankGrid, backend: Backend = "message_based"):
    """A step over stacked tiles: ``(px, py, h, w)`` -> the next tiles."""
    if backend not in ("message_based", "message_free"):
        raise ValueError(f"unknown backend {backend!r}")
    comm = message_based if backend == "message_based" else message_free

    @spans.spanned("heat.step")
    def step(tiles: torch.Tensor) -> torch.Tensor:
        if tiles.shape[:2] != (grid.px, grid.py):
            raise ValueError(f"tiles {tuple(tiles.shape)} are not on a "
                             f"{grid.px}x{grid.py} grid")
        # the span wraps the call, not the module's function, which a
        # caller may swap
        with spans.span("heat.exchange"):
            halos = comm.exchange_halos_2d(tiles)
        return _step_local(tiles, halos)

    return step


def make_runner(grid: RankGrid, backend: Backend = "message_based"):
    """``(plane, n_steps)`` -> the global plane after ``n_steps``; the ranks
    stay stacked between steps."""
    step = make_step(grid, backend)

    def run(plane, n_steps: int) -> torch.Tensor:
        tiles = to_tiles(plane, grid)
        for _ in range(n_steps):
            tiles = step(tiles)
        return from_tiles(tiles)

    return run


def reference_step(plane: torch.Tensor) -> torch.Tensor:
    """Single-program oracle: the same update on the whole plane, with the
    plane's edge repeated as its boundary."""
    H, W = plane.shape
    padded = plane.new_zeros((H + 2, W + 2))
    padded[1:-1, 1:-1] = plane
    padded[0, 1:-1] = plane[0]
    padded[-1, 1:-1] = plane[-1]
    padded[1:-1, 0] = plane[:, 0]
    padded[1:-1, -1] = plane[:, -1]
    return 0.25 * (padded[:-2, 1:-1] + padded[2:, 1:-1]
                   + padded[1:-1, :-2] + padded[1:-1, 2:])


def init_plane(h: int, w: int, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """Hot stripe in the middle, cold elsewhere."""
    plane = torch.zeros((h, w), dtype=dtype, device=device)
    plane[h // 4: h // 2, w // 4: w // 2] = 1.0
    return plane
