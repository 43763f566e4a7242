"""PAPI counter analog (paper Sec. III-E).

Accumulates PAPI_LD_INS / PAPI_L1_LDM / PAPI_L3_LDM / PAPI_TOT_CYC and the
uncore IMC read counter from the engine's phase behaviors.
"""
from __future__ import annotations

from ..core.traces import CounterSet
from .engine import RunResult
from .machine import MachineParams


def collect_counters(result: RunResult, iterations: int,
                     m: MachineParams, ranks_per_socket: int = 1) -> CounterSet:
    """Core counters are per-rank; the IMC (uncore) counter is per-socket in
    the paper (Sec. III-E: one leader per socket sums the IMCs), so it scales
    with the co-running ranks."""
    ld_ins = sum(b.n_loads for b in result.behaviors) * iterations
    l1_ldm = sum(b.fill_lines for b in result.behaviors) * iterations
    l3_ldm = sum(b.mem_lines for b in result.behaviors) * iterations
    wall = result.iter_time_ns * iterations
    # IMC read CAS: demand + prefetch line reads, socket-wide.
    imc_reads = l3_ldm * ranks_per_socket
    return CounterSet(
        ld_ins=ld_ins,
        l1_ldm=l1_ldm,
        l3_ldm=l3_ldm,
        tot_cyc=wall / m.cycle_ns,
        imc_reads=imc_reads,
        wall_time_ns=wall,
    )
