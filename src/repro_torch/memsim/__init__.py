"""repro_torch.memsim — the collection toolchain (Mitos/PEBS + PAPI analog).

PEBS has no accelerator analogue, so the model's inputs come from a
controlled cache-hierarchy simulator — the same stand-in role DDR/Optane play
for CXL in the paper itself.

Host NumPy, a copy of ``repro.memsim``: ``collect`` draws from one
``np.random.default_rng(seed)`` in the same order, so both packages write
identical bundles for the same spec and seed.
"""
from .machine import (MachineParams, MemoryClass, NetworkParams,
                      DDR_LOCAL, DDR_REMOTE, OPTANE, CXL_POOL, CXL_POOL_FAST,
                      MEMORIES, DEFAULT_MACHINE)
from .stream import AccessPhase, AppSpec, BufferSpec, CommEvent
from .engine import classify_phase, price_phases, PhaseBehavior, SampleClass, RunResult
from .sampler import sample_phase
from .counters import collect_counters
from .hooks import collect, reference_time, baseline_time, Scenario

__all__ = [
    "MachineParams", "MemoryClass", "NetworkParams",
    "DDR_LOCAL", "DDR_REMOTE", "OPTANE", "CXL_POOL", "CXL_POOL_FAST",
    "MEMORIES", "DEFAULT_MACHINE",
    "AccessPhase", "AppSpec", "BufferSpec", "CommEvent",
    "classify_phase", "price_phases", "PhaseBehavior", "SampleClass",
    "RunResult", "sample_phase", "collect_counters",
    "collect", "reference_time", "baseline_time", "Scenario",
]
