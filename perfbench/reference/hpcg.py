"""Plain PyTorch reference of the HPCG cell: multigrid-preconditioned CG on
the whole, unsplit lattice.

The lattice is the global ``(Z, ny, nx)`` one that the z-slab ranks split:
``ranks`` slabs of ``(Z / ranks, ny, nx)`` each.  With Dirichlet zeros
around the lattice and every slab's ghost planes taken from its neighbours,
a z-slab solve is this solve on the whole lattice; only the multigrid's
depth reads the slab's own shape (it coarsens while a slab stays at least
4 points on every side, to at most ``levels`` levels).

The operator is HPCG's 27-point stencil: 26 on the diagonal, -1 to each of
the 26 neighbours, written here as 27 x minus the 3 x 3 x 3 box sum, the
box sum taken axis by axis.  The preconditioner is one V-cycle: one
weighted-Jacobi sweep (weight 2/3) before and after each coarse
correction, full-weighting restriction (the mean of 2 x 2 x 2 children)
and nearest-neighbour prolongation.  Imports nothing but torch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

JACOBI_WEIGHT = 2.0 / 3.0
DIAG = 26.0


def apply_a(x: torch.Tensor) -> torch.Tensor:
    """``A x`` on the whole ``(Z, Y, X)`` lattice, zero outside it."""
    s = F.pad(x, (1, 1, 1, 1, 1, 1))
    s = s[:-2] + s[1:-1] + s[2:]
    s = s[:, :-2] + s[:, 1:-1] + s[:, 2:]
    s = s[:, :, :-2] + s[:, :, 1:-1] + s[:, :, 2:]
    return 27.0 * x - s


def _smooth(x, rhs):
    return x + (JACOBI_WEIGHT / DIAG) * (rhs - apply_a(x))


def _restrict(r):
    Z, Y, X = r.shape
    return r.reshape(Z // 2, 2, Y // 2, 2, X // 2, 2).mean(dim=(1, 3, 5))


def _prolong(c):
    return c.repeat_interleave(2, 0).repeat_interleave(2, 1) \
        .repeat_interleave(2, 2)


def v_cycle(rhs: torch.Tensor, ranks: int, levels: int,
            level: int = 0) -> torch.Tensor:
    """One V-cycle from ``x = 0``; ``ranks`` z-slabs set the coarsening."""
    slab = (rhs.shape[0] // ranks, *rhs.shape[1:])
    x = _smooth(torch.zeros_like(rhs), rhs)
    if level < levels - 1 and min(slab) >= 4:
        if any(s % 2 for s in slab):
            raise ValueError(f"slab {slab} does not halve at level {level}")
        r = rhs - apply_a(x)
        x = x + _prolong(v_cycle(_restrict(r), ranks, levels, level + 1))
        x = _smooth(x, rhs)
    return x


def pcg(b: torch.Tensor, ranks: int, levels: int, iterations: int):
    """``iterations`` steps of V-cycle-preconditioned CG from ``x = 0``,
    in ``b``'s dtype.  Returns ``(x, norm of the updated residual)``."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = v_cycle(r, ranks, levels)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iterations):
        ap = apply_a(p)
        alpha = rz / torch.sum(p * ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = v_cycle(r, ranks, levels)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, torch.sqrt(torch.sum(r * r))
