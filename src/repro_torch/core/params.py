"""Model parameters for the MPI-vs-message-free (CXL.mem) performance model.

Units convention (canonical throughout ``repro.core``):
  * time      — nanoseconds (ns)
  * size      — bytes (B)
  * bandwidth — bytes per nanosecond (B/ns), numerically equal to GB/s.

All named constants below are taken from the paper (Sec. V-B "Setting Model
Parameters") unless noted otherwise.  The ``tpu_v5e_ici`` preset adapts the
same model to the ICI / pooled-HBM setting; it is model data, carried over
from ``repro.core.params`` unchanged.

The PyTorch port keeps its own copy of this module (it imports nothing of
the JAX package); the dataclasses and presets are identical.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


GBPS = 1.0          # 1 GB/s == 1 B/ns in our unit system
US = 1000.0         # 1 microsecond in ns
CACHE_LINE_BYTES = 64


@dataclass(frozen=True)
class Thresholds:
    """Lower/upper threshold pair for one workload-characterization metric.

    The weight ramps quadratically from 0 at ``lower`` to 1 at ``upper``
    (paper Eq. 3).
    """

    lower: float
    upper: float

    def __post_init__(self) -> None:
        if not (self.upper > self.lower):
            raise ValueError(f"upper ({self.upper}) must exceed lower ({self.lower})")


@dataclass(frozen=True)
class ModelParams:
    """All tunable parameters of the combined transfer + access model.

    Defaults reproduce the paper's single-node on-NUMA-DDR test setup
    (Cascade Lake, Sec. V-A/V-B).  Use the preset constructors below for the
    other calibrated scenarios.
    """

    # --- Transfer model (Hockney), Eq. 1 ------------------------------------
    mpi_lat_ns: float = 320.0            # osu_latency, on-NUMA
    mpi_bw_Bpns: float = 9.444           # osu_bw, on-NUMA (GB/s == B/ns)

    # --- Message-free transfer model, Eq. 2 ---------------------------------
    cxl_atomic_lat_ns: float = 191.0     # atomic CAS on on-NUMA DDR stand-in

    # --- Memory latencies used by the access model (Eq. 6-10) ---------------
    mem_lat_ns: float = 86.0             # measured DDR latency (p-chase)
    cxl_lat_ns: float = 86.0             # stand-in latency (on-NUMA DDR mimic)

    # --- Machine characterization inputs ------------------------------------
    peak_mem_bw_Bpns: float = 73.0       # likwid-bench main memory BW
    l1_bw_Bpns: float = 210.0            # L1 load BW (heuristic; not benchmarked
                                         # in the paper, which measured L2 only)
    l2_bw_Bpns: float = 52.0             # likwid-bench L2 BW
    cpu_freq_ghz: float = 2.40           # Xeon Gold 6240R
    avg_load_bytes: float = 8.0          # f64 loads dominate both use cases

    # --- Characterization thresholds (Sec. V-B, "lower-upper") --------------
    thr_mbw: Thresholds = field(default_factory=lambda: Thresholds(0.03, 0.33))
    thr_mlat: Thresholds = field(default_factory=lambda: Thresholds(0.01, 0.20))
    thr_cbw: Thresholds = field(default_factory=lambda: Thresholds(0.10, 0.75))
    thr_clat: Thresholds = field(default_factory=lambda: Thresholds(0.05, 0.50))

    # --- Load-parallelism factors & compute cap ------------------------------
    lpf_lat: float = 1.5
    lpf_bw: float = 3.0
    compute_max_weight: float = 0.5

    def replace(self, **kw) -> "ModelParams":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ paper
    # presets (Sec. V-B / V-C3); each returns a fully calibrated ModelParams.

    @staticmethod
    def on_numa_ddr() -> "ModelParams":
        """CXL mimicked by on-NUMA DDR (same 86 ns latency)."""
        return ModelParams()

    @staticmethod
    def cross_numa_ddr() -> "ModelParams":
        """CXL mimicked by the remote socket's DDR."""
        return ModelParams(
            mpi_lat_ns=650.0, mpi_bw_Bpns=4.090,
            cxl_lat_ns=154.0, cxl_atomic_lat_ns=210.0)

    @staticmethod
    def optane() -> "ModelParams":
        """CXL mimicked by Optane persistent memory (cross-NUMA MPI base)."""
        return ModelParams(
            mpi_lat_ns=650.0, mpi_bw_Bpns=4.090,
            cxl_lat_ns=417.0, cxl_atomic_lat_ns=653.0)

    @staticmethod
    def optane_on_numa_mpi() -> "ModelParams":
        """Optane stand-in with on-NUMA MPI baseline (HPCG single-socket runs)."""
        return ModelParams(cxl_lat_ns=417.0, cxl_atomic_lat_ns=653.0)

    @staticmethod
    def multinode(cxl_lat_ns: float = 350.0,
                  cxl_atomic_lat_ns: float = 430.0) -> "ModelParams":
        """Sec. V-C3 four-node Skylake setup; CXL params from [9]'s 300-400 ns.

        The optimistic variant in the paper uses ``cxl_lat_ns=300`` and
        ``cxl_atomic_lat_ns=350`` (quoted 1.59x overall speedup).
        """
        return ModelParams(
            mpi_lat_ns=1.48 * US, mpi_bw_Bpns=24.715,
            cxl_lat_ns=cxl_lat_ns, cxl_atomic_lat_ns=cxl_atomic_lat_ns,
            cpu_freq_ghz=3.10)

    # ------------------------------------------------------------- TPU preset
    @staticmethod
    def tpu_v5e_ici(hops: int = 1) -> "ModelParams":
        """Beyond-paper adaptation: ICI collectives vs pooled-HBM direct access.

        message-based := XLA collective over ICI links (Hockney with per-hop
        latency); message-free := semaphore-signalled remote DMA into pooled /
        remote HBM (DESIGN.md Sec. 2).  Constants: v5e ~50 GB/s/link ICI,
        819 GB/s HBM; ~1 us collective software latency per hop; remote-HBM
        load latency ~ 1.5x local; semaphore signal ~ ICI round trip.
        """
        return ModelParams(
            mpi_lat_ns=1.0 * US * hops, mpi_bw_Bpns=50.0,
            cxl_atomic_lat_ns=500.0 * hops,
            mem_lat_ns=390.0,            # local HBM latency class
            cxl_lat_ns=600.0 * hops,     # remote/pooled HBM latency class
            peak_mem_bw_Bpns=819.0,
            l1_bw_Bpns=2000.0, l2_bw_Bpns=1300.0,   # VMEM bandwidth classes
            cpu_freq_ghz=0.94,
            avg_load_bytes=512.0,        # DMA granule, not scalar loads
            # load-parallelism on TPU = outstanding DMA transactions, far
            # deeper than a CPU load queue: 32 in-flight 512 B transfers at
            # 600 ns latency sustain ~27 GB/s remote -> lpf_bw = 32.
            lpf_lat=4.0, lpf_bw=32.0)


PAPER_PRESETS = {
    "on_numa_ddr": ModelParams.on_numa_ddr,
    "cross_numa_ddr": ModelParams.cross_numa_ddr,
    "optane": ModelParams.optane,
    "optane_on_numa_mpi": ModelParams.optane_on_numa_mpi,
    "multinode": ModelParams.multinode,
    "tpu_v5e_ici": ModelParams.tpu_v5e_ici,
}


# --- Roofline specs of one chip: the advisor's step-time terms ---------------
@dataclass(frozen=True)
class TpuSpec:
    """Peak rates of one chip for the roofline terms (``hlo.RooflineTerms``).

    The default is TPU v5e, the reference's target and the advisor's
    default spec, so an unconfigured ``CommAdvisor`` prices as the JAX
    package's does.  ``ici_link_bw`` is the bandwidth of one chip-to-chip
    link."""

    name: str = "tpu_v5e"
    peak_bf16_flops: float = 197e12      # FLOP/s per chip
    hbm_bw: float = 819e9                # B/s per chip
    ici_link_bw: float = 50e9            # B/s per link
    ici_links: int = 4                   # 2D torus: 4 links/chip
    hbm_bytes: float = 16e9              # capacity per chip
    vmem_bytes: float = 128 * 2 ** 20

    def peak_flops(self, dtype: str) -> float:
        """Dense matmul FLOP/s for operands of ``dtype`` (a torch dtype's
        name): the bf16 peak, which the HLO's roofline takes for every
        flop."""
        return self.peak_bf16_flops


TPU_V5E = TpuSpec()


@dataclass(frozen=True)
class H100Spec(TpuSpec):
    """NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU datasheet:
    989 TFLOP/s dense bf16, 67 TFLOP/s float32 outside the tensor cores
    and float64 on them, 3.35 TB/s HBM3, 80 GB, NVLink 4 at 900 GB/s total
    over 18 links (50 GB/s a link).  ``vmem_bytes`` holds the
    largest shared memory of one SM (227 KB).  The roofline spec of a step
    captured on the card; not the advisor's default."""

    name: str = "h100_sxm5"
    peak_bf16_flops: float = 989e12
    hbm_bw: float = 3.35e12
    ici_link_bw: float = 900e9 / 18
    ici_links: int = 18
    hbm_bytes: float = 80e9
    vmem_bytes: float = 227 * 2 ** 10

    def peak_flops(self, dtype: str) -> float:
        # float32 outside the tensor cores (PyTorch's matmul keeps TF32
        # off) and float64 on them: 67 TFLOP/s each
        return 67e12 if dtype in ("float32", "float64") \
            else self.peak_bf16_flops


H100 = H100Spec()
