"""Access-stream specification for the HPCG benchmark (paper Sec. V-D).

HPCG runs preconditioned CG on a 27-point stencil over an nx^3 local lattice:
per iteration one SpMV + one MG V-cycle (SymGS smoothers at 4 levels, each
fwd+bwd sweep) + dot products / WAXPBY vector updates.  Boundary (ghost)
values are exchanged with the neighbours before every sweep; HPCG handles all
neighbours in one loop, so there is a single call-site per level.

Implementation details that matter to the model (Sec. V-D):
  * MPI receives land directly in the tail of the Vector — no unpack.
  * The shared-window (CXL) version cannot allocate part of a Vector in the
    pool, so it must *unpack* (stream-copy pool -> DDR); we mark the halo
    buffers ``unpack=True`` and the model prices Sec. IV-C's unpack mode.

A copy of ``repro.apps.hpcg.spec`` over the port's ``memsim``.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...memsim.stream import AccessPhase, AppSpec, BufferSpec, CommEvent

ELEM = 8          # f64 values
IDX = 4           # int32 column indices
NNZ_ROW = 27      # 27-point stencil
LEVELS = 4        # MG hierarchy depth
HALO_CALL = "halo_l{level}"


@dataclass(frozen=True)
class HpcgConfig:
    nx: int                        # local lattice edge (16..256)
    iterations: int = 50
    ranks_per_socket: int = 8      # single-socket run, on-NUMA MPI
    elem_bytes: int = ELEM

    @property
    def bw_share(self) -> float:
        return 1.0 / self.ranks_per_socket

    def n(self, level: int) -> int:
        return (self.nx >> level) ** 3

    def face(self, level: int) -> int:
        return (self.nx >> level) ** 2

    def halo_elems(self, level: int) -> int:
        return 6 * self.face(level)        # six faces dominate the 26 neighbours

    def halo_bytes(self, level: int) -> int:
        return self.halo_elems(level) * self.elem_bytes


# Matrix sweeps per level per CG iteration: 1 SpMV + 2 SymGS x (fwd+bwd) = 5
SWEEPS = 5
# Halo exchanges per level per iteration: before SpMV + before each SymGS
EXCHANGES = 3
# Each ghost element is read by ~9 boundary stencil rows per sweep
GHOST_REUSE_PER_SWEEP = 9


def build_spec(cfg: HpcgConfig) -> AppSpec:
    spec = AppSpec(name=f"hpcg_{cfg.nx}^3", iterations=cfg.iterations)

    flops = 0.0
    stores = 0.0
    for level in range(LEVELS):
        n = cfg.n(level)
        if n == 0:
            continue
        cid = HALO_CALL.format(level=level)
        halo_bytes = cfg.halo_bytes(level)
        spec.add_buffer(BufferSpec(f"ghost_l{level}", halo_bytes,
                                   call_id=cid, unpack=True))
        mtx_bytes = n * NNZ_ROW * (ELEM + IDX)
        spec.add_buffer(BufferSpec(f"matrix_l{level}", mtx_bytes))
        spec.add_buffer(BufferSpec(f"x_l{level}", n * ELEM))

        # --- matrix streaming: values + indices, never cache-resident -----
        spec.phases.append(AccessPhase(
            buffer=f"matrix_l{level}", n_loads=SWEEPS * n * NNZ_ROW,
            stride_bytes=ELEM + IDX, gap_loads=1.0, gap_flops=2.0,
            reuse_distance_bytes=float(mtx_bytes)))
        # --- x gathers: 3D-window locality, mostly cache -------------------
        spec.phases.append(AccessPhase(
            buffer=f"x_l{level}", n_loads=SWEEPS * n * NNZ_ROW,
            stride_bytes=ELEM, gap_loads=1.0, gap_flops=2.0,
            reuse_distance_bytes=float(NNZ_ROW * cfg.face(level) * ELEM)))
        # --- ghost first touches: contiguous window read amid matrix rows --
        spec.phases.append(AccessPhase(
            buffer=f"ghost_l{level}", n_loads=SWEEPS * cfg.halo_elems(level),
            stride_bytes=ELEM, gap_loads=2.0 * NNZ_ROW, gap_flops=2.0 * NNZ_ROW,
            first_touch=True))
        # --- ghost reuses by adjacent boundary rows ------------------------
        spec.phases.append(AccessPhase(
            buffer=f"ghost_l{level}",
            n_loads=SWEEPS * cfg.halo_elems(level) * (GHOST_REUSE_PER_SWEEP - 1),
            stride_bytes=ELEM, gap_loads=2.0 * NNZ_ROW, gap_flops=2.0 * NNZ_ROW,
            reuse_distance_bytes=float(NNZ_ROW * cfg.face(level) * (ELEM + IDX))))

        flops += SWEEPS * 2.0 * n * NNZ_ROW
        stores += SWEEPS * n * ELEM
        for _ in range(EXCHANGES):
            spec.comms.append(CommEvent(call_id=cid, nbytes=halo_bytes))

    # vector ops at the finest level: 2 dots + 3 WAXPBY ≈ 8n loads, 3n stores
    n0 = cfg.n(0)
    spec.add_buffer(BufferSpec("vectors", 5 * n0 * ELEM))
    spec.phases.append(AccessPhase(
        buffer="vectors", n_loads=8 * n0, stride_bytes=ELEM, gap_flops=1.0,
        reuse_distance_bytes=float(2 * n0 * ELEM)))
    flops += 10.0 * n0
    stores += 3.0 * n0 * ELEM

    spec.flops_per_iter = flops
    spec.store_bytes_per_iter = stores
    spec.store_resident = cfg.nx <= 24
    return spec


def halo_calls():
    return tuple(HALO_CALL.format(level=l) for l in range(LEVELS))
