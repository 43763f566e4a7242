"""The yardstick's frozen numbers: the H100's published peaks, and the bytes
and operations that bound each measured piece of work.

Every count is of what the work needs, not of what the program does: each
input byte read once, each output byte written once, whatever the program
reads again.  A share of a roofline is the least time (the larger of bytes
over bandwidth and operations over the peak rate) over the measured time,
so it cannot pass 100% unless the count is too high or the time leaves out
part of the work.
"""
from __future__ import annotations

import math

#: HBM3 bandwidth of one H100 SXM, bytes/s (NVIDIA data sheet, at the full
#: 700 W power limit).
HBM_BYTES_S = 3.35e12
#: float32 operations/s of one H100 SXM outside the tensor cores (NVIDIA
#: data sheet; the apps run no matrix products).
FP32_OPS_S = 67e12
#: float64 operations/s of one H100 SXM outside the tensor cores (NVIDIA
#: data sheet).
FP64_OPS_S = 34e12
#: The peak operation rate by the configuration's dtype.
OPS_S = {"float32": FP32_OPS_S, "float64": FP64_OPS_S}
#: Card memory, bytes (the data sheet's 80 GB).
HBM_BYTES = 80e9

#: Operations of one application of HPCG's 27-point operator at a point:
#: ``26 x`` minus 26 neighbours is 26 subtractions and one multiplication.
APPLY_A_OPS = 27
#: Operations of one heat update at a point: three additions and one
#: multiplication by 1/4.
HEAT_OPS = 4


def least_s(nbytes: float, ops: float, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of ``nbytes`` over
    :data:`HBM_BYTES_S` and ``ops`` over the peak rate of ``dtype``
    (:data:`OPS_S`)."""
    return max(nbytes / HBM_BYTES_S, ops / OPS_S[dtype])


def hpcg_slabs(slab: tuple, levels: int) -> list:
    """A rank's slab ``(nz, ny, nx)`` at each multigrid level.  The V-cycle
    goes one level down while it has levels left and the slab is at least
    4 points on every side, halving every side."""
    out = [tuple(slab)]
    while len(out) < levels and min(out[-1]) >= 4:
        out.append(tuple(s // 2 for s in out[-1]))
    return out


def hpcg_applies_per_set(iterations: int, n_levels: int) -> list:
    """Applications of the operator (each with its one ghost-plane
    exchange) at each level in one set of ``iterations`` PCG iterations
    from ``x0``.

    One V-cycle applies the operator 3 times on every level but the
    coarsest (the pre-smoothing sweep, the residual, the post-smoothing
    sweep) and once on the coarsest (its one sweep).  A set applies it
    once for the first residual and runs one V-cycle, and each iteration
    applies it once (``A p``) and runs one V-cycle.  With 4 levels that is
    11 an iteration; 50 iterations make 561 a set (204, 153, 153, 51)."""
    cycle = [3] * (n_levels - 1) + [1]
    per_set = [(iterations + 1) * c for c in cycle]
    per_set[0] += iterations + 1
    return per_set


def hpcg_step_bytes(points: int, itemsize: int) -> int:
    """Bytes a PCG iteration must move at least: its state, x, r and p,
    read once and written once (z and A p are born and die inside the
    iteration).  At 8 ranks x 256^3 f64: 6 x 1,073,741,824 = 6,442,450,944,
    or 1.923 ms."""
    return 6 * points * itemsize


def hpcg_step_ops(slab: tuple, ranks: int, levels: int) -> int:
    """Operations of a PCG iteration, counting only its 11 applications of
    the operator (:data:`APPLY_A_OPS` a point at each level's size).  The
    vector updates, dots and transfers between levels are left out, so this
    is a lower count; at 8 x 256^3 f64 it bounds the iteration at 0.47 ms
    against the bytes' 1.92 ms."""
    slabs = hpcg_slabs(slab, levels)
    per_iter = [3] * (len(slabs) - 1) + [1]
    per_iter[0] += 1
    return sum(c * APPLY_A_OPS * ranks * math.prod(s)
               for c, s in zip(per_iter, slabs))


def apply_a_bytes(ranks: int, slab: tuple, itemsize: int) -> int:
    """Bytes one ``apply_a`` on ``ranks`` slabs must move: x read once with
    the two ghost planes each rank receives, and y written once.  At 8 x
    256^3 f64: 8 x (2 x 134,217,728 + 2 x 524,288) = 2,155,872,256, or
    0.6435 ms."""
    nz, ny, nx = slab
    return itemsize * ranks * (2 * nz * ny * nx + 2 * ny * nx)


def apply_a_ops(ranks: int, slab: tuple) -> int:
    """Operations of one ``apply_a``: :data:`APPLY_A_OPS` a point."""
    return APPLY_A_OPS * ranks * math.prod(slab)


def halo_bytes(ranks: int, plane: int, itemsize: int) -> int:
    """Bytes one ring exchange of ``plane`` points a strip must move: each
    rank's two boundary strips read once, and the two it receives written
    once."""
    return 4 * ranks * plane * itemsize


def heat_step_bytes(points: int, itemsize: int) -> int:
    """Bytes a heat step must move at least: the plane read once and
    written once (the halos are part of it).  At 8 x 8 x 4096^2 f32:
    2 x 4,294,967,296 = 8,589,934,592, or 2.564 ms."""
    return 2 * points * itemsize


def heat_step_ops(points: int) -> int:
    """Operations of a heat step: :data:`HEAT_OPS` a point."""
    return HEAT_OPS * points
