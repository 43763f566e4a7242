"""Trace record types shared by the collection toolchain and the model.

These mirror the outputs of the paper's extended Mitos ("mitoshooks"):
  * ``LoadSample``  — one PEBS-style load sample (Sec. III-B).
  * ``CommRecord``  — one traced MPI receive (Sec. III-D).
  * ``CounterSet``  — PAPI core+uncore counters for one run (Sec. III-E).
  * ``CallSite``    — the per-MPI-call aggregation unit (Sec. IV).
  * ``TraceBundle`` — everything mitoshooks writes for one application run.

The PyTorch port's copy of ``repro.core.traces``: the record types and the
on-disk format (``samples.csv``, ``comms.csv``, ``counters.json``,
``meta.json``) are identical, so either package reads what the other saved.
"""
from __future__ import annotations

import csv
import enum
import io
import json
from dataclasses import dataclass, field, asdict


class DataSource(enum.Enum):
    """PEBS data-source classes the model distinguishes (Fig. 3)."""

    L1 = "L1"
    L2 = "L2"
    L3 = "L3"
    LFB = "LFB"          # line-fill buffer: in-flight line, origin unknown
    DRAM = "DRAM"        # main memory (the element replaced by CXL)

    @property
    def is_cache_hit(self) -> bool:
        return self in (DataSource.L1, DataSource.L2, DataSource.L3)

    @property
    def is_miss(self) -> bool:
        return self is DataSource.DRAM


@dataclass(frozen=True)
class LoadSample:
    """One sampled load (PEBS analog).

    ``lat_ns`` is the load-to-use latency converted to nanoseconds (PEBS
    reports cycles; mitoshooks converts using the core clock).  ``weight``
    supports fractional samples (downscaled simulations).
    """

    call_id: str                 # owning call-site (buffer) — "" if unattributed
    lat_ns: float
    source: DataSource
    address: int = 0
    timestamp_ns: float = 0.0
    rank: int = 0
    weight: float = 1.0


@dataclass(frozen=True)
class CommRecord:
    """One traced receive operation (MPI trace analog)."""

    call_id: str                 # call-site identifier (IP analog)
    bytes: int                   # buffer size of this transfer
    src_rank: int = -1
    dst_rank: int = 0
    tag: int = 0
    t_start_ns: float = 0.0
    t_end_ns: float = 0.0
    count: int = 1               # identical repeats folded together


@dataclass
class CounterSet:
    """PAPI core + uncore counters for a whole run (Sec. III-E)."""

    ld_ins: float = 0.0          # PAPI_LD_INS
    l1_ldm: float = 0.0          # PAPI_L1_LDM
    l3_ldm: float = 0.0          # PAPI_L3_LDM
    tot_cyc: float = 0.0         # PAPI_TOT_CYC
    imc_reads: float = 0.0       # UNC_M_CAS_COUNT:RD summed over IMCs (lines)
    wall_time_ns: float = 0.0

    def merge(self, other: "CounterSet") -> "CounterSet":
        return CounterSet(
            ld_ins=self.ld_ins + other.ld_ins,
            l1_ldm=self.l1_ldm + other.l1_ldm,
            l3_ldm=self.l3_ldm + other.l3_ldm,
            tot_cyc=max(self.tot_cyc, other.tot_cyc),
            imc_reads=self.imc_reads + other.imc_reads,
            wall_time_ns=max(self.wall_time_ns, other.wall_time_ns),
        )


@dataclass
class CallSite:
    """Per-MPI-call aggregation unit: one receive call in the source code.

    ``accesses_per_element`` is the average number of loads each received
    element sees (the ``n`` of Sec. IV-B2's 1/n first-load split);
    ``loads_per_line`` drives the demand/prefetch hit split (footnote 20);
    ``unpack`` enables the unpack-from-CXL mode (Sec. IV-C / HPCG).
    """

    call_id: str
    comms: list = field(default_factory=list)      # list[CommRecord]
    samples: list = field(default_factory=list)    # list[LoadSample]
    accesses_per_element: float = 1.0
    loads_per_line: float = 8.0
    unpack: bool = False

    @property
    def total_transfer_bytes(self) -> int:
        return sum(c.bytes * c.count for c in self.comms)

    @property
    def n_transfers(self) -> int:
        return sum(c.count for c in self.comms)


@dataclass
class TraceBundle:
    """Everything mitoshooks produces for one application run."""

    call_sites: dict = field(default_factory=dict)   # call_id -> CallSite
    counters: CounterSet = field(default_factory=CounterSet)
    sampling_period: float = 1000.0     # 1 sample represents `period` loads
    meta: dict = field(default_factory=dict)

    def call(self, call_id: str) -> CallSite:
        if call_id not in self.call_sites:
            self.call_sites[call_id] = CallSite(call_id=call_id)
        return self.call_sites[call_id]

    def add_sample(self, s: LoadSample) -> None:
        self.call(s.call_id).samples.append(s)

    def add_comm(self, c: CommRecord) -> None:
        self.call(c.call_id).comms.append(c)

    # ------------------------------------------------------------- CSV/JSON io
    # (Mitos has a predefined output structure: samples CSV + metadata.)

    def samples_csv(self) -> str:
        out = io.StringIO()
        w = csv.writer(out)
        w.writerow(["call_id", "lat_ns", "source", "address",
                    "timestamp_ns", "rank", "weight"])
        for cs in self.call_sites.values():
            for s in cs.samples:
                w.writerow([s.call_id, s.lat_ns, s.source.value, s.address,
                            s.timestamp_ns, s.rank, s.weight])
        return out.getvalue()

    def comms_csv(self) -> str:
        out = io.StringIO()
        w = csv.writer(out)
        w.writerow(["call_id", "bytes", "src_rank", "dst_rank", "tag",
                    "t_start_ns", "t_end_ns", "count"])
        for cs in self.call_sites.values():
            for c in cs.comms:
                w.writerow([c.call_id, c.bytes, c.src_rank, c.dst_rank, c.tag,
                            c.t_start_ns, c.t_end_ns, c.count])
        return out.getvalue()

    def counters_json(self) -> str:
        return json.dumps(asdict(self.counters), indent=2)

    def save(self, directory) -> None:
        """Write the Mitos-style output structure to ``directory``."""
        import pathlib

        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        (d / "samples.csv").write_text(self.samples_csv())
        (d / "comms.csv").write_text(self.comms_csv())
        (d / "counters.json").write_text(self.counters_json())
        meta = dict(self.meta)
        meta["sampling_period"] = self.sampling_period
        meta["call_sites"] = {
            k: {"accesses_per_element": v.accesses_per_element,
                "loads_per_line": v.loads_per_line,
                "unpack": v.unpack}
            for k, v in self.call_sites.items()
        }
        (d / "meta.json").write_text(json.dumps(meta, indent=2))

    @staticmethod
    def load(directory) -> "TraceBundle":
        import pathlib

        d = pathlib.Path(directory)
        meta = json.loads((d / "meta.json").read_text())
        bundle = TraceBundle(sampling_period=meta.pop("sampling_period"))
        site_meta = meta.pop("call_sites", {})
        bundle.meta = meta
        counters = json.loads((d / "counters.json").read_text())
        bundle.counters = CounterSet(**counters)
        with (d / "samples.csv").open() as f:
            for row in csv.DictReader(f):
                bundle.add_sample(LoadSample(
                    call_id=row["call_id"], lat_ns=float(row["lat_ns"]),
                    source=DataSource(row["source"]), address=int(row["address"]),
                    timestamp_ns=float(row["timestamp_ns"]), rank=int(row["rank"]),
                    weight=float(row["weight"])))
        with (d / "comms.csv").open() as f:
            for row in csv.DictReader(f):
                bundle.add_comm(CommRecord(
                    call_id=row["call_id"], bytes=int(row["bytes"]),
                    src_rank=int(row["src_rank"]), dst_rank=int(row["dst_rank"]),
                    tag=int(row["tag"]), t_start_ns=float(row["t_start_ns"]),
                    t_end_ns=float(row["t_end_ns"]), count=int(row["count"])))
        for cid, m in site_meta.items():
            cs = bundle.call(cid)
            cs.accesses_per_element = m["accesses_per_element"]
            cs.loads_per_line = m["loads_per_line"]
            cs.unpack = m["unpack"]
        return bundle
