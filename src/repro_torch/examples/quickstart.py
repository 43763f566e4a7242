"""Quickstart: the paper's full workflow in one minute, on the port.

1. Build the 2D heat-transfer app spec (paper Sec. V-C).
2. Run the mitoshooks-analog collection (PEBS samples + MPI traces + PAPI
   counters): one measurement run, MPI baseline.
3. Run the model and print the per-MPI-call guidance: which halos to move
   to message-free CXL.mem, where to invest first, what fits a budget.
4. Cross-check the physics: the stencil on a 2 x 2 rank grid gives the
   oracle's plane with message-based and message-free halo exchanges.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import torch

from ..apps.stencil.spec import StencilConfig, build_spec
from ..apps.stencil.torch_impl import init_plane, make_runner, reference_step
from ..comm.topology import grid_mesh
from ..core import ModelParams, predict_run
from ..memsim import collect
from ._args import parser


def predictions(tile: int = 128):
    """``(config, run)``: the stencil's traces collected and priced on the
    Optane-backed shared window."""
    cfg = StencilConfig(tile=tile)
    bundle = collect(build_spec(cfg), bw_share=cfg.bw_share,
                     ranks_per_socket=cfg.ranks_per_socket)
    return cfg, bundle, predict_run(bundle, ModelParams.optane())


def stencil_errors(device, n_steps: int = 10, size: int = 64) -> dict:
    """``{backend: max |plane - oracle|}`` after ``n_steps`` steps of a
    ``size``-square plane on a 2 x 2 rank grid."""
    grid = grid_mesh(2, 2, device=device)
    plane = init_plane(size, size, device=device)
    ref = plane
    for _ in range(n_steps):
        ref = reference_step(ref)
    return {backend: float(torch.max(torch.abs(
        make_runner(grid, backend)(plane, n_steps) - ref)))
        for backend in ("message_based", "message_free")}


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    cfg, bundle, run = predictions()
    print(f"collected {sum(len(s.samples) for s in bundle.call_sites.values())}"
          f" samples over {len(bundle.call_sites)} call-sites")
    print("\nper-MPI-call verdicts (positive gain -> go message-free):")
    print(f"{'call':>8} {'T_mpi_us':>10} {'T_cxl_us':>10} {'gain_us':>9} "
          "verdict")
    for c in run.ranked_by_gain():
        verdict = "message-free" if c.gain_ns > 0 else "keep MPI"
        print(f"{c.call_id:>8} {c.t_mpi_ns / 1e3:10.1f} "
              f"{c.t_cxl_ns / 1e3:10.1f} {c.gain_ns / 1e3:9.1f} {verdict}")
    chosen, _ = run.prioritize_for_capacity(4 * cfg.halo_bytes)
    print(f"\nwith a {4 * cfg.halo_bytes} B pooled budget, prioritize: "
          f"{[c.call_id for c in chosen]}")
    for backend, err in stencil_errors(args.device).items():
        print(f"stencil [{backend:>14}] on {args.device}: max|err| vs "
              f"oracle = {err:.2e}")
    print("\nquickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
