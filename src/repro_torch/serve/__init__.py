"""Serving substrate: batched prefill/decode with KV + SSM caches.

The JAX package's ``serve/``.  Three engines: the static-batch
``ServeEngine`` (one prefill, one decode loop, batch ends together), the
continuous-batching ``ContinuousEngine`` (fixed decode slots, bucketed
prefill admission, eos/length retirement, request queue + occupancy
telemetry), and the ``PagedContinuousEngine`` (block/paged KV from a shared
pool via a block table, chunked prefill admission, block free/reuse on
retirement — KV bytes scale with actual sequence lengths, not ``n_slots *
max_len``).  ``loadgen`` generates deterministic Poisson / trace-replay
workloads and reduces runs into p50/p99 latency, TTFT, and SLO-attainment
reports.  The engines run the model on its own device; prefill takes the
CUDA kernels when the model has ``use_kernel``.
"""
from .engine import ServeEngine, sample_logits
from .loadgen import (LengthDist, LoadReport, Workload, poisson_workload,
                      replay_workload, run_workload)
from .paged import BlockPool, PagedContinuousEngine, PoolExhausted
from .scheduler import ContinuousEngine, Request, ServeStats

__all__ = ["ServeEngine", "sample_logits", "ContinuousEngine", "Request",
           "ServeStats", "PagedContinuousEngine", "BlockPool",
           "PoolExhausted", "LengthDist", "LoadReport", "Workload",
           "poisson_workload", "replay_workload", "run_workload"]
