"""Plain PyTorch reference of the heat cell: the 2D heat-transfer update on
the whole, unsplit plane, and the same on sampled patches of it.

The update is the paper's 5-point Jacobi step: every point becomes the
mean of its four neighbours.  The plane's edges are insulating: a
neighbour beyond the edge is the edge point itself.  Imports nothing but
torch.

A point after ``n`` steps depends only on the points within ``n`` of it,
so a ``p x p`` patch of the result needs only the ``(p + 2n)^2`` region
around it, each step shrinking the region by one point a side.  An
insulating edge is a mirror: the update with the edge point as its own
neighbour is the update on the plane reflected about the edge, continued
evenly (point ``-1 - i`` is point ``i``).  So a region that crosses an
edge is read with reflected indices and stepped like any other.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def step(plane: torch.Tensor) -> torch.Tensor:
    """One update of the whole ``(H, W)`` plane."""
    p = F.pad(plane[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return 0.25 * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])


def reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the plane continued evenly about its edges: ``-1 - i``
    reads ``i``, ``n + i`` reads ``n - 1 - i``."""
    i = i % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def region_indices(corners: torch.Tensor, size: int, steps: int,
                   shape: tuple) -> tuple:
    """Row and column indices ``(B, size + 2 steps)`` of the regions
    that ``B`` patches of ``size x size``, at top-left ``corners`` ``(B,
    2)``, need after ``steps`` updates, reflected into the plane."""
    span = torch.arange(-steps, size + steps, device=corners.device)
    rows = reflect(corners[:, :1] + span, shape[0])
    cols = reflect(corners[:, 1:] + span, shape[1])
    return rows, cols


def patches(regions: torch.Tensor, steps: int) -> torch.Tensor:
    """Step ``(B, p + 2 steps, p + 2 steps)`` regions ``steps`` times, each
    time keeping only the points whose neighbours are all in the region:
    the ``(B, p, p)`` patches at their centres."""
    r = regions
    for _ in range(steps):
        r = 0.25 * (r[:, :-2, 1:-1] + r[:, 2:, 1:-1]
                    + r[:, 1:-1, :-2] + r[:, 1:-1, 2:])
    return r
