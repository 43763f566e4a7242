"""One cell captured with overrides, its roofline terms printed as JSON:
the JAX package's ``scripts/perf_cell.py`` (its hill-climbing harness) over
``torch.distributed`` ranks.

The cell is built and captured by :func:`launch.dryrun.run_cell` (rank 0's
view under a fake process group of the production mesh's 256 or 512
ranks, as ``dryrun.main`` runs it), with no adaptive retry: the
microbatch count is ``--n-micro`` or the default, as the reference's
script lowers it.  The printed keys are the reference's, with
``live_tpu_GB`` renamed ``live_device_GB`` (the record's
``live_bytes_device_estimate``, as ``run_cell`` renames its key); the
times are the H100's modelled roofline terms, not measurements.
``--save-graph`` takes ``--save-hlo``'s place: the step's ``make_fx``
graph code, gzipped.

    PYTHONPATH=src python -m repro_torch.launch.perf_cell \\
        --arch qwen2.5-3b --shape train_4k --layout fsdp_seq
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import tempfile
import time

import torch.distributed as dist

from ..configs import get_arch, get_shape
from .dryrun import run_cell
from .mesh import init_fake_ranks, make_production_mesh


def parse_overrides(pairs) -> dict:
    """``k=v`` pairs as ``ArchConfig`` overrides: ``True`` / ``False``,
    digits as an int, anything else the string (the reference's rule)."""
    over = {}
    for kv in pairs:
        k, v = kv.split("=")
        over[k] = {"True": True, "False": False}.get(
            v, int(v) if v.isdigit() else v)
    return over


def summary(rec: dict, over: dict, seconds: float) -> dict:
    """The reference script's JSON of a ``run_cell`` record."""
    r = rec["roofline"]
    return {"overrides": over, "n_micro": rec.get("n_micro"),
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "dominant": r["dominant"],
            "wire_GB": r["wire_bytes"] / 1e9,
            "live_device_GB":
                rec["memory"]["live_bytes_device_estimate"] / 1e9,
            "roofline_fraction": r["compute_s"] / r["step_time_s"],
            "useful_ratio": r["useful_flops_ratio"],
            "compile_s": round(seconds, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one cell's roofline terms")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="ArchConfig overrides k=v (bool/int)")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--layout", default="tp", choices=("tp", "fsdp_seq"))
    ap.add_argument("--moe-impl", default=None,
                    help="scatter, dense or ep_local (default: ep_local "
                    "under tp, scatter under fsdp_seq)")
    ap.add_argument("--save-graph", default=None,
                    help="write the step's graph code here (gzipped)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    over = parse_overrides(args.set)
    if over:
        cfg = cfg.replace(**over)
    shape = get_shape(args.shape)
    t0 = time.time()
    init_fake_ranks(512 if args.multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type="cpu")
        with tempfile.TemporaryDirectory() as tmp:
            graph_dir = pathlib.Path(tmp) if args.save_graph else None
            rec = run_cell(cfg, shape, mesh, save_hlo_dir=graph_dir,
                           n_micro=args.n_micro, layout=args.layout,
                           moe_impl=args.moe_impl, retry=False)
            if graph_dir is not None:
                shutil.move(graph_dir / f"{cfg.name}__{shape.name}.py.gz",
                            args.save_graph)
    finally:
        dist.destroy_process_group()
    print(json.dumps(summary(rec, over, time.time() - t0), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
