"""The rank grid of the port: ranks as leading tensor axes on one device.

The JAX package runs each app under ``shard_map`` over a mesh of devices.
The port keeps the ranks on one device instead, stacked on leading tensor
axes (the stencil's tiles are ``(px, py, h, w)``, HPCG's z-slabs
``(n, nz, ny, nx)``), and :class:`RankGrid` is the counterpart of the mesh:
it carries the grid's shape and the device the ranks live on.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RankGrid:
    """A ``px`` x ``py`` grid of ranks, stacked on one device."""

    px: int
    py: int
    device: torch.device

    @property
    def size(self) -> int:
        return self.px * self.py


def grid_mesh(px: int, py: int = 1, device="cuda") -> RankGrid:
    """A 2D grid of ``px`` x ``py`` ranks on ``device``.

    The default device is the card; it raises when no CUDA device is
    present rather than moving to the CPU (pass ``device="cpu"`` to run
    there).  A 1D ring, as HPCG's z-slabs use, is ``grid_mesh(n)``.
    """
    if px < 1 or py < 1:
        raise ValueError(f"grid {px}x{py} has no ranks")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"grid {px}x{py} on {dev}: no CUDA device is "
                           "present (pass device='cpu' to run on the CPU)")
    return RankGrid(px, py, dev)


def shift_perm(n: int, delta: int):
    """Cyclic permutation pairs (source, destination) along one rank axis."""
    return [(i, (i + delta) % n) for i in range(n)]
