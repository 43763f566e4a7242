"""Model-vs-reference validation for the 2D stencil (paper Fig. 5 / 7 / 8).

``run_validation`` reproduces the Fig. 5 experiment: for each tile size and
each of the paper's five scenarios, it reports the *reference* normalized
time (engine-priced, the stand-in for the measured shared-memory
implementation) and the *model-predicted* normalized time (from the
MPI-baseline trace bundle only — the model never sees the reference run).

Host-side, over the port's ``memsim`` and ``core``; a copy of
``repro.apps.stencil.validation``: the same rows for the same arguments.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...core.params import ModelParams
from ...core.predictor import predict_run
from ...memsim.hooks import Scenario, baseline_time, collect, reference_time
from ...memsim.machine import (DDR_REMOTE, DEFAULT_MACHINE, OPTANE,
                               NetworkParams)
from .spec import NS_CALLS, WE_CALLS, HALO_CALLS, StencilConfig, build_spec

# scenario name -> (pool memory, replaced calls, model params factory)
_SCENARIOS = {
    "ns_optane": (OPTANE, NS_CALLS, ModelParams.optane),
    "we_optane": (OPTANE, WE_CALLS, ModelParams.optane),
    "ns_ddr": (DDR_REMOTE, NS_CALLS, ModelParams.cross_numa_ddr),
    "we_ddr": (DDR_REMOTE, WE_CALLS, ModelParams.cross_numa_ddr),
}

#: The stencil runs with the chessboard placement (Sec. V-C1), so the MPI
#: baseline crosses NUMA domains.
NETWORK = NetworkParams.cross_numa()


@dataclass(frozen=True)
class ValidationRow:
    tile: int
    scenario: str
    reference_norm: float     # T_scenario / T_baseline (engine)
    predicted_norm: float     # T_scenario / T_baseline (model)

    @property
    def reference_speedup(self) -> float:
        return 1.0 / self.reference_norm

    @property
    def predicted_speedup(self) -> float:
        return 1.0 / self.predicted_norm


def run_validation(tiles=(32, 128, 512, 1024, 2048, 4096, 8096),
                   machine=DEFAULT_MACHINE, seed: int = 0):
    """Returns list[ValidationRow] across tiles x scenarios."""
    rows = []
    for tile in tiles:
        cfg = StencilConfig(tile=tile)
        spec = build_spec(cfg)
        t_base = baseline_time(spec, machine, NETWORK, cfg.bw_share)

        bundle = collect(spec, machine, NETWORK, seed=seed,
                         bw_share=cfg.bw_share,
                         ranks_per_socket=cfg.ranks_per_socket)

        for name, (pool, calls, params_fn) in _SCENARIOS.items():
            t_ref = reference_time(spec, Scenario(name, pool, calls),
                                   machine, NETWORK, cfg.bw_share)
            run = predict_run(bundle, params_fn())
            t_pred = run.predicted_runtime_ns(replaced=set(calls))
            rows.append(ValidationRow(
                tile=tile, scenario=name,
                reference_norm=t_ref / t_base,
                predicted_norm=t_pred / run.baseline_runtime_ns))
    return rows


def overhead_breakdown(tiles=(32, 128, 512, 1024, 2048, 4096, 8096),
                       machine=DEFAULT_MACHINE, seed: int = 0):
    """Paper Fig. 8: modeled Optane shared-window overhead split into data
    transfer vs data load, for horizontal and vertical halos."""
    out = []
    for tile in tiles:
        cfg = StencilConfig(tile=tile)
        spec = build_spec(cfg)
        bundle = collect(spec, machine, NETWORK, seed=seed,
                         bw_share=cfg.bw_share,
                         ranks_per_socket=cfg.ranks_per_socket)
        run = predict_run(bundle, ModelParams.optane())
        for group, calls in (("NS", NS_CALLS), ("WE", WE_CALLS)):
            transfer = sum(run.calls[c].t_transfer_cxl_ns for c in calls)
            access = sum(run.calls[c].t_access_cxl_ns for c in calls)
            out.append({"tile": tile, "halo": group,
                        "transfer_ns": transfer, "access_ns": access,
                        "transfer_frac": transfer / max(transfer + access, 1e-9)})
    return out


def multinode_prediction(tiles=(32, 128, 512, 1024, 2048, 4096),
                         machine=DEFAULT_MACHINE, seed: int = 0,
                         optimistic: bool = False):
    """Paper Fig. 7 / Sec. V-C3: 64 ranks over 4 nodes, all-cross-node
    communication; prediction only (no reference exists — CXL.mem 3.0
    hardware is not on the market).

    Returns rows with predicted normalized time for replacing N+S, W+E and
    ALL halos.  ``optimistic=True`` uses the 300 ns CXL_LAT / 350 ns atomic
    upper-end parameters quoted for the 1.59x claim.
    """
    if optimistic:
        params = ModelParams.multinode(cxl_lat_ns=300.0, cxl_atomic_lat_ns=350.0)
    else:
        params = ModelParams.multinode()
    network = NetworkParams.multinode()
    out = []
    for tile in tiles:
        cfg = StencilConfig(tile=tile, grid=(8, 8), ranks_per_socket=6)
        spec = build_spec(cfg)
        bundle = collect(spec, machine, network, seed=seed,
                         bw_share=cfg.bw_share,
                         ranks_per_socket=cfg.ranks_per_socket)
        run = predict_run(bundle, params)
        for group, calls in (("NS", NS_CALLS), ("WE", WE_CALLS),
                             ("ALL", HALO_CALLS)):
            t_pred = run.predicted_runtime_ns(replaced=set(calls))
            out.append({"tile": tile, "halo": group,
                        "predicted_norm": t_pred / run.baseline_runtime_ns,
                        "predicted_speedup": run.baseline_runtime_ns / t_pred})
    return out
