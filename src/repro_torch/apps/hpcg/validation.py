"""Model-vs-reference validation for HPCG (paper Fig. 9 / 10).

Three options (Sec. V-D): baseline MPI, all-neighbour halos through an
Optane-backed shared window, or through a DDR-backed shared window.  The
shared-window variants pay the unpack copy (Sec. IV-C unpack mode).
HPCG runs single-socket, so the MPI baseline uses on-NUMA parameters.

Host-side, over the port's ``memsim`` and ``core``; a copy of
``repro.apps.hpcg.validation``: the same rows for the same arguments.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...core.params import ModelParams
from ...core.predictor import predict_run
from ...memsim.hooks import Scenario, baseline_time, collect, reference_time
from ...memsim.machine import (DDR_LOCAL, DEFAULT_MACHINE, OPTANE,
                               NetworkParams)
from .spec import HpcgConfig, build_spec, halo_calls

NETWORK = NetworkParams.on_numa()

_SCENARIOS = {
    "optane": (OPTANE, ModelParams.optane_on_numa_mpi),
    "ddr": (DDR_LOCAL, ModelParams.on_numa_ddr),
}


@dataclass(frozen=True)
class HpcgRow:
    nx: int
    scenario: str
    reference_norm: float
    predicted_norm: float
    reference_ms: float
    predicted_ms: float


def run_validation(sizes=(16, 32, 64, 104, 128, 192, 256),
                   machine=DEFAULT_MACHINE, seed: int = 0):
    rows = []
    calls = set(halo_calls())
    for nx in sizes:
        cfg = HpcgConfig(nx=nx)
        spec = build_spec(cfg)
        t_base = baseline_time(spec, machine, NETWORK, cfg.bw_share)
        bundle = collect(spec, machine, NETWORK, seed=seed,
                         bw_share=cfg.bw_share,
                         ranks_per_socket=cfg.ranks_per_socket)
        for name, (pool, params_fn) in _SCENARIOS.items():
            t_ref = reference_time(spec, Scenario(name, pool, tuple(calls)),
                                   machine, NETWORK, cfg.bw_share)
            run = predict_run(bundle, params_fn())
            t_pred = run.predicted_runtime_ns(replaced=calls)
            rows.append(HpcgRow(
                nx=nx, scenario=name,
                reference_norm=t_ref / t_base,
                predicted_norm=t_pred / run.baseline_runtime_ns,
                reference_ms=t_ref / 1e6,
                predicted_ms=t_pred / 1e6))
    return rows


def overhead_breakdown(sizes=(16, 64, 128, 256), machine=DEFAULT_MACHINE,
                       seed: int = 0):
    """Paper Fig. 10: transfer vs load shares, MPI vs CXL(Optane)."""
    out = []
    calls = halo_calls()
    for nx in sizes:
        cfg = HpcgConfig(nx=nx)
        spec = build_spec(cfg)
        bundle = collect(spec, machine, NETWORK, seed=seed,
                         bw_share=cfg.bw_share,
                         ranks_per_socket=cfg.ranks_per_socket)
        run = predict_run(bundle, ModelParams.optane_on_numa_mpi())
        for mode in ("mpi", "cxl"):
            if mode == "mpi":
                transfer = sum(run.calls[c].t_transfer_mpi_ns for c in calls)
                access = sum(run.calls[c].t_access_mpi_ns for c in calls)
            else:
                transfer = sum(run.calls[c].t_transfer_cxl_ns for c in calls)
                access = sum(run.calls[c].t_access_cxl_ns for c in calls)
            out.append({"nx": nx, "mode": mode,
                        "transfer_ns": transfer, "access_ns": access,
                        "transfer_frac": transfer / max(transfer + access, 1e-9)})
    return out
