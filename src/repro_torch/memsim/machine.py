"""Machine model for the sampling-toolchain simulator.

PEBS sampling has no accelerator analogue, so — like the paper
mimicking CXL with Optane — we collect the model's inputs from a controlled
stand-in: a cache-hierarchy simulator parameterized to the paper's testbed
(2x Intel Xeon Gold 6240R, Cascade Lake; Sec. V-A).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class MemoryClass:
    """One physical memory the simulator can place buffers in."""

    name: str
    lat_ns: float           # load-to-use latency
    bw_Bpns: float          # sustained read bandwidth (B/ns == GB/s)
    atomic_lat_ns: float    # atomic RMW latency (message-free handshake)


# Calibrated to the paper's measurements (Sec. V-B):
DDR_LOCAL = MemoryClass("ddr", lat_ns=86.0, bw_Bpns=73.0, atomic_lat_ns=191.0)
DDR_REMOTE = MemoryClass("ddr_remote", lat_ns=154.0, bw_Bpns=40.0,
                         atomic_lat_ns=210.0)
OPTANE = MemoryClass("optane", lat_ns=417.0, bw_Bpns=13.0, atomic_lat_ns=653.0)
# Future CXL.mem pool (Sec. V-C3: 350 ns avg of [9]'s 300-400 ns):
CXL_POOL = MemoryClass("cxl", lat_ns=350.0, bw_Bpns=40.0, atomic_lat_ns=430.0)
CXL_POOL_FAST = MemoryClass("cxl_fast", lat_ns=300.0, bw_Bpns=40.0,
                            atomic_lat_ns=350.0)

MEMORIES = {m.name: m for m in
            (DDR_LOCAL, DDR_REMOTE, OPTANE, CXL_POOL, CXL_POOL_FAST)}


@dataclass(frozen=True)
class MachineParams:
    """Core + cache hierarchy (Cascade Lake-ish) used by the simulator."""

    line_bytes: int = 64
    l1_bytes: int = 32 * 1024
    l2_bytes: int = 1024 * 1024
    l3_bytes: int = 36 * 1024 * 1024
    l3_share: float = 0.10          # effective per-rank share of shared L3
    l1_lat_ns: float = 1.7          # ~4 cyc @ 2.4 GHz
    l2_lat_ns: float = 5.8          # ~14 cyc
    l3_lat_ns: float = 20.0         # ~48 cyc
    l2_bw_Bpns: float = 52.0        # likwid-bench (paper Sec. V-B)
    l3_bw_Bpns: float = 30.0
    cycle_ns: float = 1.0 / 2.4
    issue_ns_per_load: float = 0.1  # 2 load ports, AVX-vectorized f64 streams
    flop_ns: float = 0.05           # effective per-flop cost (vectorized)
    prefetch_depth: int = 10        # stream prefetcher: lines ahead
    prefetch_min_lines: int = 3     # lines before the stream engages
    load_queue: int = 48            # max outstanding loads (MLP bound)
    mlp_lines: int = 10             # typical outstanding line fills (L2 MSHRs)

    def level_lat(self, level: str) -> float:
        return {"L1": self.l1_lat_ns, "L2": self.l2_lat_ns,
                "L3": self.l3_lat_ns}[level]


DEFAULT_MACHINE = MachineParams()


@dataclass(frozen=True)
class NetworkParams:
    """The message-based network of the simulated system (OSU-calibrated)."""

    lat_ns: float = 320.0
    bw_Bpns: float = 9.444

    @staticmethod
    def on_numa() -> "NetworkParams":
        return NetworkParams(320.0, 9.444)

    @staticmethod
    def cross_numa() -> "NetworkParams":
        return NetworkParams(650.0, 4.090)

    @staticmethod
    def multinode() -> "NetworkParams":
        return NetworkParams(1480.0, 24.715)
