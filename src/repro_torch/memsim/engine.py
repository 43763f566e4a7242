"""Analytic cache-hierarchy engine.

Classifies each :class:`AccessPhase` on the machine model and produces
 (a) the PEBS-style sample mix (source + observed latency per class),
 (b) the *exposed* performance time of the phase (what a wall clock sees).

The two are deliberately different quantities — PEBS records load-to-use
latency even when out-of-order execution hides it — which is exactly why the
paper needs LPF factors in the model.  Keeping both honest makes the
model-vs-reference validation meaningful.

Prefetch-timeliness mechanics reproduce the paper's central observation
(Sec. V-C1): tightly consumed streams (horizontal halos) outrun the stream
prefetcher and degrade to LFB/miss on slow memory, while streams consumed
with long gaps (vertical halos) stay cache-hits — until capacity evicts them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from .machine import MachineParams, MemoryClass, DDR_LOCAL
from .stream import AccessPhase, AppSpec, BufferSpec


@dataclass(frozen=True)
class SampleClass:
    """A group of identically-behaving loads within one phase."""

    source: str          # "L1" | "L2" | "L3" | "LFB" | "DRAM"
    lat_ns: float        # observed (PEBS) latency
    n_loads: float
    prefetch_hit: bool = False


@dataclass(frozen=True)
class PhaseBehavior:
    phase: AccessPhase
    classes: tuple       # tuple[SampleClass, ...]
    time_ns: float       # exposed wall time of the phase (per iteration)
    mem_lines: float     # lines fetched from backing memory
    fill_lines: float    # lines filled into L1 (beyond-L1 traffic)

    @property
    def n_loads(self) -> float:
        return self.phase.n_loads


def classify_phase(phase: AccessPhase, mem: MemoryClass, m: MachineParams,
                   bw_share: float = 1.0) -> PhaseBehavior:
    """Price one access phase against the hierarchy.

    ``bw_share``: fraction of the backing memory's bandwidth available to
    this rank (co-running ranks contend).
    """
    line = m.line_bytes
    stride = max(1, phase.stride_bytes)
    lpl = max(1.0, line / stride) if stride < line else 1.0
    lines = phase.n_loads / lpl
    if lines <= 0 or phase.n_loads <= 0:
        return PhaseBehavior(phase, (), 0.0, 0.0, 0.0)

    issue = m.issue_ns_per_load
    gap_ns = phase.gap_loads * issue + phase.gap_flops * m.flop_ns
    # time between successive first-touches of lines of this stream:
    t_line_consume = lpl * (issue + gap_ns)

    # --- residency decision ---------------------------------------------------
    rd = phase.reuse_distance_bytes
    if phase.first_touch:
        level = "MEM"
    elif rd <= m.l1_bytes:
        level = "L1"
    elif rd <= m.l2_bytes:
        level = "L2"
    elif rd <= m.l3_bytes * m.l3_share:
        level = "L3"
    else:
        level = "MEM"

    base_issue_time = phase.n_loads * issue

    if level != "MEM":
        lat = m.level_lat(level)
        level_bw = {"L1": float("inf"), "L2": m.l2_bw_Bpns,
                    "L3": m.l3_bw_Bpns}[level]
        bw_time = lines * line / level_bw if level_bw != float("inf") else 0.0
        # OoO hides cache latency unless the pattern is dependent/strided with
        # small gaps; expose what the gap cannot cover, overlapped across MSHRs.
        hidden = gap_ns + issue * m.load_queue  # window of independent work
        exposed = max(0.0, lat - hidden) / m.mlp_lines * lines
        time = max(base_issue_time, bw_time) + exposed
        classes = (SampleClass(level, lat, lines),)
        if lpl > 1.0:
            classes += (SampleClass("L1", m.l1_lat_ns, phase.n_loads - lines),)
        fill = lines if level != "L1" else 0.0
        return PhaseBehavior(phase, classes, time, 0.0, fill)

    # --- backing-memory stream -------------------------------------------------
    eff_bw = mem.bw_Bpns * bw_share
    service = line / eff_bw                       # per-line BW service time
    engaged = stride <= line and lines >= m.prefetch_min_lines

    rest_hits = phase.n_loads - lines             # same-line follow-up loads
    rest = (SampleClass("L1", m.l1_lat_ns, rest_hits),) if rest_hits > 0 else ()

    if engaged:
        headroom = m.prefetch_depth * max(t_line_consume, service)
        if headroom >= mem.lat_ns and t_line_consume >= service:
            # timely prefetch: first-touches land in L2 ahead of use
            time = max(base_issue_time, lines * service)
            classes = (SampleClass("L2", m.l2_lat_ns, lines, prefetch_hit=True),) + rest
            return PhaseBehavior(phase, classes, time, lines, lines)
        # late prefetch: line is in flight when demanded -> LFB
        wait = max(mem.lat_ns - headroom, service - t_line_consume)
        wait = max(wait, 0.0)
        observed = m.l2_lat_ns + wait
        time = max(base_issue_time, lines * service) + lines * wait
        classes = (SampleClass("LFB", observed, lines),) + rest
        return PhaseBehavior(phase, classes, time, lines, lines)

    # not engaged: demand misses at full memory latency
    queue_extra = max(0.0, lines * service - lines * t_line_consume) / max(lines, 1.0)
    observed = mem.lat_ns + queue_extra
    hidden = gap_ns
    exposed_per_line = max(observed / m.mlp_lines, observed - hidden)
    time = max(base_issue_time, lines * service) + lines * max(0.0, exposed_per_line)
    classes = (SampleClass("DRAM", observed, lines),) + rest
    return PhaseBehavior(phase, classes, time, lines, lines)


@dataclass
class RunResult:
    """Per-iteration pricing of a whole AppSpec under one placement."""

    behaviors: list = field(default_factory=list)    # list[PhaseBehavior]
    comm_time_ns: float = 0.0
    flops_time_ns: float = 0.0
    store_time_ns: float = 0.0

    @property
    def phase_time_ns(self) -> float:
        return sum(b.time_ns for b in self.behaviors)

    @property
    def iter_time_ns(self) -> float:
        # loads/compute overlap imperfectly; comm is exposed (blocking recv)
        return max(self.phase_time_ns, self.flops_time_ns) \
            + self.store_time_ns + self.comm_time_ns


def price_phases(spec: AppSpec, placement: dict, m: MachineParams,
                 bw_share: float = 1.0) -> RunResult:
    """Price all phases of one iteration.  ``placement``: buffer name ->
    MemoryClass (default DDR_LOCAL)."""
    res = RunResult()
    for phase in spec.phases:
        mem = placement.get(phase.buffer, DDR_LOCAL)
        res.behaviors.append(classify_phase(phase, mem, m, bw_share))
    res.flops_time_ns = spec.flops_per_iter * m.flop_ns
    store_bw = m.l2_bw_Bpns if spec.store_resident \
        else DDR_LOCAL.bw_Bpns * bw_share
    res.store_time_ns = spec.store_bytes_per_iter / store_bw
    return res
