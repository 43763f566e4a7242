"""The paper's guidance story, end to end: for each tile size, which halo
exchanges should move to message-free CXL.mem, including the multi-node
projection (paper Fig. 7, up to ~1.37x/1.59x).  Host physics only: the
``--device`` option is accepted and unused.

Run:  PYTHONPATH=src python -m repro_torch.examples.stencil_advisor
"""
from __future__ import annotations

from ..apps.stencil.spec import NS_CALLS, WE_CALLS, StencilConfig, build_spec
from ..apps.stencil.validation import multinode_prediction
from ..core import ModelParams, predict_run
from ..memsim import NetworkParams, collect
from ._args import parser

TILES = (32, 128, 512, 2048)


def guidance(tiles=TILES) -> list:
    """``(tile, run, NS gain us, WE gain us, guidance)`` per tile on the
    Optane-backed single-node window."""
    rows = []
    for tile in tiles:
        cfg = StencilConfig(tile=tile)
        bundle = collect(build_spec(cfg), network=NetworkParams.cross_numa(),
                         bw_share=cfg.bw_share,
                         ranks_per_socket=cfg.ranks_per_socket)
        run = predict_run(bundle, ModelParams.optane())
        ns = sum(run.calls[c].gain_ns for c in NS_CALLS) / 1e3
        we = sum(run.calls[c].gain_ns for c in WE_CALLS) / 1e3
        best = ("replace W+E first" if we > ns and we > 0 else
                "replace N+S first" if ns > 0 else "keep MPI")
        rows.append((tile, run, ns, we, best))
    return rows


def main(argv=None) -> int:
    parser(__doc__).parse_args(argv)
    print("single-node, Optane-backed shared window (paper Sec. V-C1):")
    print(f"{'tile':>6} {'NS gain_us':>11} {'WE gain_us':>11} guidance")
    for tile, _, ns, we, best in guidance():
        print(f"{tile:>6} {ns:11.1f} {we:11.1f} {best}")
    print("\nfour-node CXL.mem projection (paper Fig. 7):")
    print(f"{'tile':>6} {'halos':>6} {'speedup':>8}")
    for row in multinode_prediction(tiles=(32, 128, 1024)):
        print(f"{row['tile']:>6} {row['halo']:>6} "
              f"{row['predicted_speedup']:8.3f}")
    print("\n(with optimistic 300 ns CXL latency:)")
    for row in multinode_prediction(tiles=(32,), optimistic=True):
        if row["halo"] == "ALL":
            print(f"{row['tile']:>6}    ALL {row['predicted_speedup']:8.3f}"
                  f"   <- the paper's 1.59x headline regime")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
