"""Quickstart: the vectorized scenario-sweep engine behind ``price()``, on
the port.

1. Collect the stencil trace bundle (one measurement run, as always).
2. Compile it to packed arrays with ``compile_bundle``.
3. Price a (cxl_lat_ns x cxl_atomic_lat_ns) grid and read the
   ``(n_scenarios, n_calls)`` gain matrix and per-scenario aggregates.
4. Swap the MPI-side transfer model for LogGP (Sec. VI) without touching
   the access physics, or mix both inside one grid with the categorical
   ``mpi_transfer=`` axis.
5. Go beyond the factorial grid: ``ParamGrid.sample`` (Latin hypercube),
   ``ParamGrid.zip`` (paired calibration points) and ``ParamGrid.concat``
   (their union) price the same way.
6. Re-run on the ``torch`` backend and the ``fused`` backend (the fused
   bracket/segment-sum CUDA kernel on the card, its plain version on the
   CPU), and chunked (bounded peak memory, bit-identical): all through
   ``ExecPlan``.
7. Stream a 4k-scenario adaptive sweep through the ``distributed``
   backend (sharded top-k and exact aggregates, frontier refinement).
8. Audit your own step with the capture-based checker
   (``repro_torch.analysis.ircheck``): an entry spec, its passes.

Run:  PYTHONPATH=src python -m repro_torch.examples.sweep_quickstart [--device cpu]
"""
from __future__ import annotations

import numpy as np

from ..apps.stencil.spec import HALO_CALLS, StencilConfig, build_spec
from ..core import (ExecPlan, LogGPTransfer, ModelParams, ParamGrid,
                    TRANSFER_MODELS, adaptive_sample, compile_bundle, price)
from ..memsim import collect
from ..memsim.machine import NetworkParams
from ._args import parser

REPLACED = set(HALO_CALLS)


def bundle():
    """The 8 x 8 stencil's compiled bundle at tile 32."""
    cfg = StencilConfig(tile=32, grid=(8, 8), ranks_per_socket=6)
    return compile_bundle(collect(build_spec(cfg),
                                  network=NetworkParams.multinode(),
                                  bw_share=cfg.bw_share,
                                  ranks_per_socket=cfg.ranks_per_socket))


def loggp() -> LogGPTransfer:
    """The overhead-calibrated LogGP instance of step 4, registered under
    ``"loggp_overhead"``."""
    lg = LogGPTransfer(L_ns=1200.0, o_ns=200.0, G_ns_per_byte=1 / 24.715)
    TRANSFER_MODELS["loggp_overhead"] = lambda p: lg
    return lg


def scenario_sets() -> dict:
    """Steps 3-5's scenario sets, by name."""
    mp = ModelParams.multinode()
    grid = ParamGrid.product(
        mp, cxl_lat_ns=[float(v) for v in np.linspace(250.0, 700.0, 8)],
        cxl_atomic_lat_ns=[float(v) for v in np.linspace(300.0, 800.0, 8)])
    mixed = ParamGrid.product(mp, cxl_lat_ns=[300.0, 350.0, 400.0],
                              mpi_transfer=["hockney", "loggp_overhead"])
    sampled = ParamGrid.sample(mp, 32, seed=0, cxl_lat_ns=(250.0, 700.0),
                               cxl_atomic_lat_ns=(300.0, 800.0),
                               mpi_transfer=["hockney", "loggp_overhead"])
    paper = ParamGrid.zip(mp, cxl_lat_ns=[350.0, 300.0],
                          cxl_atomic_lat_ns=[430.0, 350.0])
    return {"grid": grid, "mixed": mixed, "sampled": sampled,
            "paper": paper, "union": ParamGrid.concat(grid, sampled, paper)}


def sweeps(cb, device) -> dict:
    """Every ``price()`` result of steps 3-6 by name (``"grid"`` on the
    numpy backend; ``"torch"``, ``"fused"`` and ``"chunked"`` the grid on
    the other plans; ``"loggp"`` the grid under step 4's LogGP)."""
    lg = loggp()
    sets = scenario_sets()
    out = {name: price(cb, s, plan="numpy") for name, s in sets.items()}
    out["loggp"] = price(cb, sets["grid"], mpi_transfer=lg, plan="numpy")
    out["torch"] = price(cb, sets["grid"], plan=ExecPlan("torch",
                                                         device=device))
    out["fused"] = price(cb, sets["grid"], plan=ExecPlan("fused",
                                                         device=device))
    out["chunked"] = price(cb, sets["grid"], plan=ExecPlan(
        "numpy", chunk_scenarios=16))
    return out


def drift(other, base) -> float:
    """The largest relative distance of ``other``'s gain matrix from
    ``base``'s."""
    return float(np.max(np.abs(other.gain_ns - base.gain_ns)
                        / np.maximum(np.abs(base.gain_ns), 1e-12)))


def streamed(cb, device):
    """Step 7: 4,096 seed scenarios and two refinement rounds streamed
    through the ``distributed`` backend."""
    loggp()
    big = adaptive_sample(ModelParams.multinode(), 4096, seed=0,
                          cxl_lat_ns=(250.0, 700.0),
                          cxl_atomic_lat_ns=(300.0, 800.0),
                          mpi_transfer=["hockney", "loggp_overhead"])
    return big, price(cb, big, plan=f"distributed:topk=8,refine=2,"
                      f"device={device}")


def audit():
    """Step 8: a toy optimizer step captured and checked."""
    import torch

    from ..analysis import ircheck
    from ..core import graph

    def my_step(state, grad):               # a toy "optimizer step"
        return state.sub_(0.1 * grad), grad.abs().sum()

    spec = ircheck.EntrySpec(
        "quickstart.my_step", my_step,
        args=(graph.abstract(torch.zeros, (64, 64)),
              graph.abstract(torch.zeros, (64, 64))),
        inplace=(0,))                       # state is updated in place
    report, _ = ircheck.check_entry(spec)   # captured, never run
    return report


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    cb = bundle()
    print(f"compiled {cb.n_calls} call-sites, "
          f"{len(cb.hit_lat) + len(cb.lfb_lat) + len(cb.miss_lat)} samples")
    res = sweeps(cb, args.device)
    sets = scenario_sets()
    grid, base = sets["grid"], res["grid"]
    print(f"gain matrix shape: {base.gain_ns.shape}  (scenarios x calls)")
    speed = base.predicted_speedup(replaced=REPLACED)
    best = base.best_scenario(replaced=REPLACED)
    print(f"best scenario: {grid.labels()[best]} -> {speed[best]:.3f}x app "
          "speedup")
    worst = int(np.argmin(speed))
    print(f"worst scenario: {grid.labels()[worst]} -> {speed[worst]:.3f}x")
    print(f"message-free wins every call in "
          f"{int((base.n_beneficial() == cb.n_calls).sum())}/{len(grid)} "
          "scenarios")
    chosen, _ = base.prioritize_for_capacity(capacity_bytes=64 * 1024)
    print(f"64 KiB CXL budget fits {chosen.sum(axis=1).min()}.."
          f"{chosen.sum(axis=1).max()} buffers depending on scenario")
    s_lg = res["loggp"].predicted_speedup(replaced=REPLACED)
    print(f"LogGP MPI baseline shifts the band to "
          f"[{s_lg.min():.3f}, {s_lg.max():.3f}]x")
    for row in res["mixed"].summary_rows(replaced=REPLACED)[:2]:
        print(f"mixed-grid scenario {row['mpi_transfer']:14s} "
              f"@ {row['cxl_lat_ns']:.0f} ns "
              f"-> {row['predicted_speedup']:.3f}x")
    s_sam = res["sampled"].predicted_speedup(replaced=REPLACED)
    print(f"LHS sample (32 pts) speedup band: "
          f"[{s_sam.min():.3f}, {s_sam.max():.3f}]x")
    s_pts = res["paper"].predicted_speedup(replaced=REPLACED)
    print(f"paper points (default, optimistic): "
          f"{s_pts[0]:.3f}x, {s_pts[1]:.3f}x")
    print(f"union set: {len(sets['union'])} scenarios in one evaluation; "
          f"best {res['union'].predicted_speedup(replaced=REPLACED).max():.3f}x")
    for name in ("torch", "fused"):
        print(f"{name} backend on {args.device} max relative drift vs "
              f"numpy: {drift(res[name], base):.2e}")
    print(f"chunked numpy bit-identical: "
          f"{np.array_equal(res['chunked'].gain_ns, base.gain_ns)}")
    big, top = streamed(cb, args.device)
    print(f"streamed {top.aggregates.count} scenario evaluations "
          f"({len(big)} seed + {top.plan.refine} refinement rounds); "
          f"per-shard working set {top.shard_rows} rows")
    print(f"top-{len(top)} speedups: "
          f"[{top.speedups[-1]:.4f}, {top.speedups[0]:.4f}]x; "
          f"best scenario {top.labels()[0]}")
    print(f"speedup histogram mass around 1.0x: "
          f"{int(top.aggregates.hist[19:23].sum())} scenarios")
    report = audit()
    print(f"ircheck {report.name}: {report.status}, "
          f"peak live {report.metrics['peak_live_bytes']:,} B, "
          f"layout churn {report.metrics['copy_transpose_bytes']:,} B")
    for f in report.findings:
        print(f"  {f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
