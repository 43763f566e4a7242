"""PEBS-style sampler over engine results (the Mitos analog).

Every ``sampling_period``-th load produces a sample; we emit the expected
sample mix deterministically (fractional ``weight``) with seeded latency
jitter, so runs are reproducible and the model sees realistic scatter.
"""
from __future__ import annotations

import numpy as np

from ..core.traces import DataSource, LoadSample
from .engine import PhaseBehavior

_SOURCE_MAP = {
    "L1": DataSource.L1,
    "L2": DataSource.L2,
    "L3": DataSource.L3,
    "LFB": DataSource.LFB,
    "DRAM": DataSource.DRAM,
}


def sample_phase(behavior: PhaseBehavior, call_id: str, iterations: int,
                 sampling_period: float, rng: np.random.Generator,
                 max_samples_per_class: int = 32, rank: int = 0):
    """Emit LoadSamples for ``iterations`` repeats of one phase.

    Total represented loads = n_loads x iterations; each emitted sample
    carries ``weight`` such that sum(weight) * sampling_period == loads.
    """
    out = []
    for cls in behavior.classes:
        total_loads = cls.n_loads * iterations
        n_samples_f = total_loads / sampling_period
        if n_samples_f <= 0:
            continue
        k = int(min(max_samples_per_class, max(1, round(n_samples_f))))
        weight = n_samples_f / k
        # ~12% multiplicative jitter, clipped to stay positive
        jitter = rng.normal(1.0, 0.12, size=k).clip(0.5, 1.8)
        for j in range(k):
            out.append(LoadSample(
                call_id=call_id,
                lat_ns=float(cls.lat_ns * jitter[j]),
                source=_SOURCE_MAP[cls.source],
                rank=rank,
                weight=float(weight)))
    return out
