"""Access-stream specification for the 2D heat-transfer stencil (Sec. V-C).

The plane is split into ``grid`` tiles, one MPI rank per tile; each time step
exchanges four halos (N, S, W, E) with the neighbours and applies a 5-point
update.  Halos are received into contiguous buffers and *not* unpacked
(footnote 22).  We model the interior-rank loop (4 live neighbours), the
common case on the 4x4 grid.

The crucial distinction the spec encodes (paper Fig. 6):
  * N/S (horizontal) halos are consumed in one tight batch interleaved only
    with the first/last row's stencil loads — small ``gap_loads``.
  * W/E (vertical) halos are consumed one element per row — ``gap_loads``
    of a whole row of computation between touches, giving the prefetcher
    ample time (but using each cache line across 8 rows).
"""
from __future__ import annotations

from dataclasses import dataclass

from ...memsim.stream import AccessPhase, AppSpec, BufferSpec, CommEvent

ELEM = 8  # f64

HALO_CALLS = ("halo_N", "halo_S", "halo_W", "halo_E")
NS_CALLS = ("halo_N", "halo_S")
WE_CALLS = ("halo_W", "halo_E")


@dataclass(frozen=True)
class StencilConfig:
    tile: int                      # T x T cells per rank
    grid: tuple = (4, 4)           # rank grid
    iterations: int = 500
    ranks_per_socket: int = 8      # 16 ranks over 2 sockets
    elem_bytes: int = ELEM

    @property
    def bw_share(self) -> float:
        return 1.0 / self.ranks_per_socket

    @property
    def halo_bytes(self) -> int:
        return self.tile * self.elem_bytes


def build_spec(cfg: StencilConfig) -> AppSpec:
    T = cfg.tile
    spec = AppSpec(name=f"stencil2d_{T}x{T}", iterations=cfg.iterations)

    tile_bytes = T * T * cfg.elem_bytes
    spec.add_buffer(BufferSpec("tile_old", tile_bytes))
    spec.add_buffer(BufferSpec("tile_new", tile_bytes))
    for cid in HALO_CALLS:
        spec.add_buffer(BufferSpec(cid, cfg.halo_bytes, call_id=cid))

    # --- interior sweep --------------------------------------------------
    # Fresh first-touch of each tile_old line once per sweep; the line is
    # re-touched next iteration after a full sweep of both arrays.
    resweep_rd = 2.0 * tile_bytes
    spec.phases.append(AccessPhase(
        buffer="tile_old", n_loads=T * T, stride_bytes=cfg.elem_bytes,
        gap_loads=4.0, gap_flops=5.0,
        reuse_distance_bytes=resweep_rd))
    # The 4 neighbour re-reads of each cell hit lines touched <= 2 rows ago.
    spec.phases.append(AccessPhase(
        buffer="tile_old", n_loads=4 * T * T, stride_bytes=cfg.elem_bytes,
        gap_loads=1.0, gap_flops=1.25,
        reuse_distance_bytes=4.0 * T * cfg.elem_bytes))

    # --- halo reads -------------------------------------------------------
    # N/S: one tight batch; ~4 tile loads + 5 flops between halo elements.
    for cid in NS_CALLS:
        spec.phases.append(AccessPhase(
            buffer=cid, n_loads=T, stride_bytes=cfg.elem_bytes,
            gap_loads=4.0, gap_flops=5.0, first_touch=True))
    # W/E: one element per row; a whole row (5T loads, 5T flops) between.
    for cid in WE_CALLS:
        spec.phases.append(AccessPhase(
            buffer=cid, n_loads=T, stride_bytes=cfg.elem_bytes,
            gap_loads=5.0 * T, gap_flops=5.0 * T, first_touch=True))

    # --- stores and flops --------------------------------------------------
    spec.store_bytes_per_iter = tile_bytes
    # tile_new fits the private caches only for small tiles
    spec.store_resident = 2 * tile_bytes <= 1024 * 1024
    spec.flops_per_iter = 5.0 * T * T

    # --- communication ------------------------------------------------------
    for cid in HALO_CALLS:
        spec.comms.append(CommEvent(call_id=cid, nbytes=cfg.halo_bytes))
    return spec


#: Paper's five measurement scenarios (Sec. V-C1).
SCENARIOS = {
    "baseline": (),
    "ns_optane": NS_CALLS,
    "we_optane": WE_CALLS,
    "ns_ddr": NS_CALLS,
    "we_ddr": WE_CALLS,
}
