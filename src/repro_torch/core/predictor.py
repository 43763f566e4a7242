"""Per-call MPI-vs-message-free verdicts (paper Sec. IV, V).

Combines the transfer model (Sec. IV-A) and the access model (Sec. IV-C) per
call-site and answers the paper's three user questions:
  1. which calls benefit from CXL and which should stay MPI,
  2. where to invest refactoring time first (largest absolute gain),
  3. which buffers to prioritize under limited CXL capacity
     (gain per byte of pooled memory).

The PyTorch port's scalar per-call path, a counterpart of
``repro.core.predictor``: one ``ModelParams`` at a time, answers as Python
floats (the physics underneath runs on 0-d float64 host tensors).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from . import access
from .characterization import Characterization
from .params import ModelParams
from .traces import CallSite, TraceBundle
from .transfer import HockneyTransfer, MessageFreeTransfer


@dataclass(frozen=True)
class CallPrediction:
    call_id: str
    t_transfer_mpi_ns: float
    t_transfer_cxl_ns: float
    t_access_mpi_ns: float
    t_access_cxl_ns: float
    transfer_bytes: int
    buffer_bytes: int

    @property
    def t_mpi_ns(self) -> float:
        return self.t_transfer_mpi_ns + self.t_access_mpi_ns

    @property
    def t_cxl_ns(self) -> float:
        return self.t_transfer_cxl_ns + self.t_access_cxl_ns

    @property
    def gain_ns(self) -> float:
        """Positive = switching this call to message-free saves time."""
        return self.t_mpi_ns - self.t_cxl_ns

    @property
    def speedup(self) -> float:
        return self.t_mpi_ns / self.t_cxl_ns if self.t_cxl_ns > 0 else float("inf")

    @property
    def gain_per_byte(self) -> float:
        return self.gain_ns / max(1, self.buffer_bytes)


@dataclass
class RunPrediction:
    calls: dict = field(default_factory=dict)       # call_id -> CallPrediction
    characterization: Characterization = None
    baseline_runtime_ns: float = 0.0                # whole-app wall time

    # -- question 1: per-call verdicts ---------------------------------------
    def beneficial_calls(self):
        return {k: v for k, v in self.calls.items() if v.gain_ns > 0}

    # -- question 2: where to invest first -----------------------------------
    def ranked_by_gain(self):
        return sorted(self.calls.values(), key=lambda c: c.gain_ns, reverse=True)

    # -- question 3: limited CXL capacity ------------------------------------
    def prioritize_for_capacity(self, capacity_bytes: int):
        """Greedy gain-per-byte knapsack over positive-gain buffers."""
        chosen, used = [], 0
        for c in sorted(self.beneficial_calls().values(),
                        key=lambda c: c.gain_per_byte, reverse=True):
            if used + c.buffer_bytes <= capacity_bytes:
                chosen.append(c)
                used += c.buffer_bytes
        return chosen, used

    # -- application-level projection -----------------------------------------
    def predicted_runtime_ns(self, replaced=None) -> float:
        """Baseline wall time with the selected calls swapped to message-free.

        ``replaced=None`` replaces every call (the paper's per-scenario plots
        replace a fixed subset, e.g. only N+S halos).
        """
        t = self.baseline_runtime_ns
        for cid, c in self.calls.items():
            if replaced is None or cid in replaced:
                t -= c.gain_ns
        return t

    def predicted_speedup(self, replaced=None) -> float:
        return self.baseline_runtime_ns / self.predicted_runtime_ns(replaced)


def predict_call(site: CallSite, ch: Characterization, p: ModelParams,
                 sampling_period: float, mpi_transfer=None,
                 free_transfer=None) -> CallPrediction:
    """Score one call-site.  ``mpi_transfer``/``free_transfer`` default to
    the paper's Hockney / two-atomic models but accept any ``TransferModel``
    (e.g. ``LogGPTransfer``, Sec. VI)."""
    mpi_transfer = mpi_transfer or HockneyTransfer.from_params(p)
    free_transfer = free_transfer or MessageFreeTransfer.from_params(p)
    t_acc_mpi = access.scale_by_rate(access.access_mpi_ns(site, ch, p),
                                     sampling_period)
    t_acc_cxl = access.scale_by_rate(access.access_cxl_ns(site, ch, p),
                                     sampling_period)
    buffer_bytes = max((c.bytes for c in site.comms), default=0)
    return CallPrediction(
        call_id=site.call_id,
        t_transfer_mpi_ns=mpi_transfer.transfer_ns(site),
        t_transfer_cxl_ns=free_transfer.transfer_ns(site),
        t_access_mpi_ns=t_acc_mpi,
        t_access_cxl_ns=t_acc_cxl,
        transfer_bytes=site.total_transfer_bytes,
        buffer_bytes=buffer_bytes,
    )


def predict_run(bundle: TraceBundle, p: ModelParams, mpi_transfer=None,
                free_transfer=None) -> RunPrediction:
    """Full post-processing step: characterize once, then score every call."""
    ch = Characterization.from_counters(bundle.counters, p)
    run = RunPrediction(characterization=ch,
                        baseline_runtime_ns=bundle.counters.wall_time_ns)
    for cid, site in bundle.call_sites.items():
        run.calls[cid] = predict_call(site, ch, p, bundle.sampling_period,
                                      mpi_transfer=mpi_transfer,
                                      free_transfer=free_transfer)
    return run
