"""Plain version of HPCG's 27-point operator over stacked z-slab ranks.

Exactly the port's path before the kernel: the ghost planes stacked onto
the slabs, a zero pad in y and x, and :func:`apply_a_padded`'s sum in the
reference's order.  CPU tensors run it; the CUDA kernel is held to it bit
for bit.  ``apps.hpcg.torch_impl``'s single-program oracle sums with
:func:`apply_a_padded` too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def apply_a_padded(p: torch.Tensor) -> torch.Tensor:
    """27-point operator on ``(..., nz+2, ny+2, nx+2)`` zero/halo-padded
    blocks (the sum runs in the reference's order, in place)."""
    Z, Y, X = p.shape[-3:]
    acc = 27.0 * p[..., 1:-1, 1:-1, 1:-1]
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc.sub_(p[..., 1 + dz: Z - 1 + dz, 1 + dy: Y - 1 + dy,
                           1 + dx: X - 1 + dx])
    return acc  # diag 26 = 27 - own contribution


def apply_27pt_ref(blocks: torch.Tensor, below: torch.Tensor,
                   above: torch.Tensor) -> torch.Tensor:
    """``y = A x`` for ``blocks (n, nz, ny, nx)`` with the ghost planes
    ``below`` / ``above`` ``(n, 1, ny, nx)`` and zeros outside the plane."""
    z_padded = torch.cat([below, blocks, above], dim=1)
    return apply_a_padded(F.pad(z_padded, (1, 1, 1, 1)))
