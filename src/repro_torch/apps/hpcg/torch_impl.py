"""HPCG in PyTorch: preconditioned CG on the 27-point stencil, z-slab
distributed over stacked ranks, with selectable message-based /
message-free halo exchange.

The counterpart of ``repro.apps.hpcg.jax_impl`` (paper Sec. V-D): CG with a
4-level multigrid V-cycle, the 27-point operator (diagonal 26,
off-diagonals -1), weighted-Jacobi smoothing in place of SymGS and
full-weighting restriction, as there.  The ranks are the leading axis of
one ``(n, nz, ny, nx)`` tensor of z-slabs on the grid's device instead of
the shards of a ``shard_map``; every function below acts on all ranks at
once, and the multigrid's shape tests act on the per-rank local shape.

The ``"message_free"`` exchange goes through
``kernels.halo_exchange.ops.exchange_planes_1d``: on the card that is the
CUDA kernel in which each rank's CTAs write its boundary planes straight
into its neighbours' receive windows under a flag handshake; on the CPU it
is the shared-window emulation of ``comm.message_free``.  The exchanged
planes are copies either way, so both backends give bit-identical results.

The operator itself goes through ``kernels.stencil27.ops.apply_27pt``: on
the card one CUDA kernel reads each slab and its two ghost planes and
writes ``y`` once; on the CPU it is the plain ``cat``, pad and
``apply_a_padded`` of ``kernels.stencil27.ref``, which the kernel equals
bit for bit.
"""
from __future__ import annotations

from typing import Literal

import torch
import torch.nn.functional as F

from ... import spans
from ...comm import collectives, message_based
from ...comm.topology import RankGrid
from ...kernels.halo_exchange import ops as halo_ops
from ...kernels.stencil27 import ops as stencil_ops
from ...kernels.stencil27.ref import apply_a_padded

Backend = Literal["message_based", "message_free"]
N_LEVELS = 4
JACOBI_WEIGHT = 2.0 / 3.0
PRE_SMOOTH = 1
POST_SMOOTH = 1

_EXCHANGE = {"message_based": message_based.exchange_planes_1d,
             "message_free": halo_ops.exchange_planes_1d}


def to_slabs(lattice, n: int, device=None) -> torch.Tensor:
    """Global ``(Z, ny, nx)`` lattice (array or tensor) -> ``(n, Z/n, ny,
    nx)`` z-slabs, as ``P(axis)`` splits it."""
    lattice = torch.as_tensor(lattice, device=device)
    if lattice.shape[0] % n:
        raise ValueError(f"{lattice.shape[0]} z-planes do not split over "
                         f"{n} ranks")
    return lattice.reshape(n, lattice.shape[0] // n, *lattice.shape[1:])


def from_slabs(blocks: torch.Tensor) -> torch.Tensor:
    """``(n, nz, ny, nx)`` z-slabs -> the global ``(n*nz, ny, nx)``
    lattice."""
    return blocks.reshape(-1, *blocks.shape[2:])


@spans.spanned("hpcg.exchange")
def _exchange(blocks, backend: Backend):
    below, above = _EXCHANGE[backend](blocks)
    below[0] = 0.0                         # Dirichlet: rank 0 has no below
    above[-1] = 0.0                        # ... and rank n-1 no above
    return below, above


@spans.spanned("hpcg.apply_a")
def apply_a(blocks, backend: Backend):
    """y = A x with one ghost-plane exchange along the distributed z axis.

    This is the call-site the paper's model scores (one receive per
    neighbour per sweep)."""
    below, above = _exchange(blocks, backend)
    return stencil_ops.apply_27pt(blocks, below, above)


def smooth(blocks, rhs, backend: Backend, n_iter: int):
    """Weighted-Jacobi smoothing: x += w D^-1 (b - A x)."""
    x = blocks
    for _ in range(n_iter):
        r = rhs - apply_a(x, backend)
        x = x + (JACOBI_WEIGHT / 26.0) * r
    return x


def restrict(blocks):
    """Full-weighting restriction (mean over 2x2x2 children) of every
    rank's block — the adjoint of nearest-neighbour prolongation."""
    n = blocks.shape[0]
    z, y, x = (s // 2 * 2 for s in blocks.shape[1:])
    b = blocks[:, :z, :y, :x].reshape(n, z // 2, 2, y // 2, 2, x // 2, 2)
    return b.mean(dim=(2, 4, 6))


def prolong(coarse, fine_shape):
    """Nearest-neighbour prolongation back to the fine per-rank shape."""
    z = coarse.repeat_interleave(2, dim=1)[:, : fine_shape[0]]
    y = z.repeat_interleave(2, dim=2)[:, :, : fine_shape[1]]
    return y.repeat_interleave(2, dim=3)[:, :, :, : fine_shape[2]]


def v_cycle(rhs, backend: Backend, level: int = 0):
    """Multigrid V-cycle preconditioner M^-1 applied to ``rhs``."""
    with spans.span(f"hpcg.v_cycle.L{level}"):
        local = rhs.shape[1:]
        x = smooth(torch.zeros_like(rhs), rhs, backend, PRE_SMOOTH)
        if level < N_LEVELS - 1 and min(local) >= 4:
            r = rhs - apply_a(x, backend)
            xc = v_cycle(restrict(r), backend, level + 1)
            x = x + prolong(xc, local)
            x = smooth(x, rhs, backend, POST_SMOOTH)
        return x


@spans.spanned("hpcg.pdot")
def _pdot(a, b):
    """Global dot product: each rank's ``vdot``, then the sum over ranks
    in rank order (the ``psum``)."""
    n = a.shape[0]
    part = torch.linalg.vecdot(a.reshape(n, -1), b.reshape(n, -1))
    return collectives.rank_sum(part)


def make_cg(grid: RankGrid, backend: Backend = "message_based",
            n_iter: int = 25):
    """The distributed PCG solve: ``(b, x0)`` global ``(Z, ny, nx)`` ->
    ``(x, res_norm)``, ``x`` global and ``res_norm`` a 0-d tensor on the
    grid's device.  The grid's ``px * py`` ranks form the z ring.  (The
    reference's ``precondition=False``, which no caller sets, is left
    out: the V-cycle always preconditions.)"""
    if backend not in _EXCHANGE:
        raise ValueError(f"unknown backend {backend!r}")
    n = grid.size

    @spans.spanned("hpcg.solve")
    def solve(b, x0):
        b = to_slabs(b, n, grid.device)
        x = to_slabs(x0, n, grid.device)
        r = b - apply_a(x, backend)
        z = v_cycle(r, backend)
        p = z
        rz = _pdot(r, z)
        for _ in range(n_iter):
            ap = apply_a(p, backend)
            alpha = rz / _pdot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            z = v_cycle(r, backend)
            rz_new = _pdot(r, z)
            beta = rz_new / rz
            p = z + beta * p
            rz = rz_new
        return from_slabs(x), torch.sqrt(_pdot(r, r))

    return solve


def reference_apply_a(x: torch.Tensor) -> torch.Tensor:
    """Single-program oracle for A (Dirichlet zero padding)."""
    return apply_a_padded(F.pad(x, (1, 1, 1, 1, 1, 1)))


def make_problem(shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """HPCG-style RHS: b = A @ ones (so the exact solution is ones)."""
    return reference_apply_a(torch.ones(shape, dtype=dtype, device=device))
