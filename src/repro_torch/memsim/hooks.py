"""mitoshooks analog: run an AppSpec through the simulator and produce the
Mitos-style output bundle, plus price *reference* scenario runs.

Mirrors the paper's Fig. 1 workflow:
  collect()          — the measurement run (MPI baseline, everything in DDR)
                       -> TraceBundle (samples + comm traces + counters),
                       the only input the model sees.
  reference_time()   — the reference implementation runs: selected call-sites
                       switched to a shared-memory window placed in a chosen
                       MemoryClass (DDR / Optane / CXL), everything priced by
                       the *engine*, not the model.  Validation ground truth.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.traces import CommRecord, TraceBundle
from .counters import collect_counters
from .engine import classify_phase, price_phases, RunResult
from .machine import (DDR_LOCAL, MachineParams, MemoryClass, NetworkParams,
                      DEFAULT_MACHINE)
from .sampler import sample_phase
from .stream import AccessPhase, AppSpec


def _call_id_of(spec: AppSpec, buffer_name: str):
    b = spec.buffers.get(buffer_name)
    return b.call_id if b is not None else None


def collect(spec: AppSpec, machine: MachineParams = DEFAULT_MACHINE,
            network: NetworkParams = NetworkParams.on_numa(),
            sampling_period: float = 1000.0, seed: int = 0,
            bw_share: float = 1.0, ranks_per_socket: int = 1) -> TraceBundle:
    """The Mitos measurement run (baseline MPI, all buffers in DDR)."""
    rng = np.random.default_rng(seed)
    result = price_phases(spec, {}, machine, bw_share)

    # actual (simulated) communication time of the baseline run
    comm_ns = sum(c.count * (network.lat_ns + c.nbytes / network.bw_Bpns)
                  for c in spec.comms)
    result.comm_time_ns = comm_ns

    bundle = TraceBundle(sampling_period=sampling_period,
                         meta={"app": spec.name,
                               "iterations": spec.iterations})
    bundle.counters = collect_counters(result, spec.iterations, machine,
                                       ranks_per_socket)

    for behavior in result.behaviors:
        cid = _call_id_of(spec, behavior.phase.buffer)
        if not cid:
            continue        # non-communication buffers: counters only —
                            # the model scores MPI-buffer call-sites
        for s in sample_phase(behavior, cid, spec.iterations,
                              sampling_period, rng):
            bundle.add_sample(s)

    for c in spec.comms:
        bundle.add_comm(CommRecord(call_id=c.call_id, bytes=c.nbytes,
                                   count=c.count * spec.iterations))

    # per-call-site metadata the model needs (Sec. IV-B2 / footnotes 19-20)
    for name, buf in spec.buffers.items():
        if buf.call_id is None:
            continue
        site = bundle.call(buf.call_id)
        phases = spec.phases_of(name)
        loads = sum(p.n_loads for p in phases)
        elements = max(1, buf.nbytes // buf.elem_bytes)
        site.accesses_per_element = max(1.0, loads / elements)
        strides = [p.stride_bytes for p in phases] or [buf.elem_bytes]
        site.loads_per_line = max(1.0, machine.line_bytes / min(strides))
        site.unpack = bool(getattr(buf, "unpack", False))
    return bundle


@dataclass(frozen=True)
class Scenario:
    """Which call-sites go message-free, and into which memory."""

    name: str
    pool: MemoryClass                   # shared-window memory class
    message_free_calls: tuple = ()      # call_ids switched; () = pure MPI

    def is_free(self, call_id: str) -> bool:
        return call_id in self.message_free_calls


def reference_time(spec: AppSpec, scenario: Scenario,
                   machine: MachineParams = DEFAULT_MACHINE,
                   network: NetworkParams = NetworkParams.on_numa(),
                   bw_share: float = 1.0) -> float:
    """Engine-priced wall time (ns) of one scenario — the validation truth.

    Message-free call-sites: their buffers live in ``scenario.pool``; each
    former receive becomes a 2-sided atomic handshake.  Buffers flagged
    ``unpack`` additionally pay a streaming copy pool->DDR and then keep
    their original DDR access pattern (the HPCG case, Sec. V-D).
    """
    placement = {}
    unpack_phases = []
    for name, buf in spec.buffers.items():
        if buf.call_id and scenario.is_free(buf.call_id):
            if getattr(buf, "unpack", False):
                # unpack copy: tight streaming read of the pool window
                unpack_phases.append(AccessPhase(
                    buffer=name + "__unpack", n_loads=buf.nbytes // buf.elem_bytes,
                    stride_bytes=buf.elem_bytes, gap_loads=1.0,  # store per load
                    first_touch=True))
                placement[name + "__unpack"] = scenario.pool
                # original phases keep hitting DDR (placement default)
            else:
                placement[name] = scenario.pool

    result = price_phases(spec, placement, machine, bw_share)
    for ph in unpack_phases:
        result.behaviors.append(
            classify_phase(ph, placement[ph.buffer], machine, bw_share))
        # unpack also writes the DDR destination
        result.store_time_ns += ph.n_loads * 8 / DDR_LOCAL.bw_Bpns

    comm_ns = 0.0
    for c in spec.comms:
        if scenario.is_free(c.call_id):
            comm_ns += c.count * 2.0 * scenario.pool.atomic_lat_ns
            # producer writes straight into the shared window
            comm_ns += c.count * c.nbytes / scenario.pool.bw_Bpns
        else:
            comm_ns += c.count * (network.lat_ns + c.nbytes / network.bw_Bpns)
    result.comm_time_ns = comm_ns
    return result.iter_time_ns * spec.iterations


def baseline_time(spec: AppSpec, machine: MachineParams = DEFAULT_MACHINE,
                  network: NetworkParams = NetworkParams.on_numa(),
                  bw_share: float = 1.0) -> float:
    """Pure-MPI reference wall time (ns)."""
    return reference_time(spec, Scenario("mpi", DDR_LOCAL, ()), machine,
                          network, bw_share)
