"""Abstract access-stream description an application hands to the simulator.

An application run is a sequence of iterations; each iteration executes the
same list of :class:`AccessPhase` objects (load phases over named buffers)
plus communication events.  This is the contract between ``repro.apps.*``
(which know their loop structure analytically) and ``repro.memsim`` (which
prices it on the machine model).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class BufferSpec:
    """A named allocation.  ``call_id`` non-None marks it as a communication
    buffer owned by that call-site (the unit the model scores)."""

    name: str
    nbytes: int
    elem_bytes: int = 8
    call_id: Optional[str] = None
    unpack: bool = False       # message-free needs an unpack copy (HPCG case)


@dataclass(frozen=True)
class AccessPhase:
    """One homogeneous load phase over a buffer within an iteration.

    ``reuse_distance_bytes``: bytes of *other* traffic between consecutive
    touches of the same line of this buffer (drives the residency level).
    ``gap_loads``: loads to other buffers between consecutive loads of this
    phase (drives prefetch timeliness — the N+S vs W+E halo distinction).
    ``stride_bytes``: distance between consecutive loads of this phase.
    """

    buffer: str
    n_loads: int
    stride_bytes: int = 8
    gap_loads: float = 0.0
    gap_flops: float = 0.0
    reuse_distance_bytes: float = 0.0
    first_touch: bool = False        # data newly written by a remote producer


@dataclass(frozen=True)
class CommEvent:
    """One receive per iteration at a call-site (message-based scenario),
    which the message-free scenario replaces with a handshake + direct loads."""

    call_id: str
    nbytes: int
    count: int = 1


@dataclass
class AppSpec:
    """Complete per-rank description of an application run."""

    name: str
    buffers: dict = field(default_factory=dict)      # name -> BufferSpec
    phases: list = field(default_factory=list)       # list[AccessPhase]
    comms: list = field(default_factory=list)        # list[CommEvent]
    store_bytes_per_iter: float = 0.0                # write-back traffic
    store_resident: bool = False                     # stores stay in-cache
    flops_per_iter: float = 0.0
    iterations: int = 1

    def buffer(self, name: str) -> BufferSpec:
        return self.buffers[name]

    def add_buffer(self, spec: BufferSpec) -> None:
        self.buffers[spec.name] = spec

    @property
    def loads_per_iter(self) -> float:
        return sum(p.n_loads for p in self.phases)

    def phases_of(self, buffer_name: str):
        return [p for p in self.phases if p.buffer == buffer_name]

    def comm_call_ids(self):
        return sorted({c.call_id for c in self.comms})
