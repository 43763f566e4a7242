"""HPCG use case (paper Sec. V-D): model vs reference with the unpack
penalty, plus a distributed CG solve over a ring of z-slab ranks with
both communication backends (on the card the message-free exchange runs
the halo kernel).

Run:  PYTHONPATH=src python -m repro_torch.examples.hpcg_analysis [--device cpu]
"""
from __future__ import annotations

import torch

from ..apps.hpcg.torch_impl import make_cg, make_problem
from ..apps.hpcg.validation import overhead_breakdown, run_validation
from ..comm.topology import grid_mesh
from ._args import parser

SIZES = (16, 64, 128)
RANKS = 4


def solves(device, n_ranks: int = RANKS, n_iter: int = 30) -> dict:
    """``{backend: (residual, max |x - 1|)}`` of the PCG solve of a 16^3
    lattice over ``n_ranks`` z-slabs."""
    grid = grid_mesh(n_ranks, device=device)
    b = make_problem((16, 16, 16), device=device)
    out = {}
    for backend in ("message_based", "message_free"):
        x, res = make_cg(grid, backend, n_iter=n_iter)(b, torch.zeros_like(b))
        out[backend] = (float(res), float(torch.max(torch.abs(x - 1.0))))
    return out


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    print("model vs reference (normalized to MPI baseline):")
    print(f"{'nx':>5} {'scenario':>8} {'reference':>10} {'model':>8}")
    for r in run_validation(sizes=SIZES):
        print(f"{r.nx:>5} {r.scenario:>8} {r.reference_norm:10.3f} "
              f"{r.predicted_norm:8.3f}")
    print("\noverhead split (transfer share of total):")
    for row in overhead_breakdown(sizes=(16, 128)):
        print(f"  nx={row['nx']:<4} {row['mode']:>4}: "
              f"{row['transfer_frac'] * 100:5.1f}% transfer")
    print(f"\ndistributed PCG solve ({RANKS} z-slab ranks on "
          f"{args.device}):")
    for backend, (res, err) in solves(args.device).items():
        print(f"  [{backend:>14}] residual={res:.3e} max|x-1|={err:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
