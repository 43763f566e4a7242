"""Offline refresh of the memory-fit verdicts in the port's dry-run
records: each record's analytic footprint (``core.analytic``) and its
fits-80-GB verdicts against the H100 (``core.params.H100``), recomputed
without capturing the step again.

Run:  PYTHONPATH=src python -m repro_torch.scripts.refresh_fits \\
          [--root experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib

from ..configs import ARCHS, SHAPES
from ..core import analytic
from ..core.params import H100

DEFAULT_ROOT = pathlib.Path("experiments/dryrun_torch")


def mesh_sizes(name: str) -> tuple | None:
    """``(data ranks, model ranks)`` of a mesh directory's name (``16x16``,
    ``2x16x16``: the last axis is ``model``), or ``None``."""
    try:
        dims = [int(x) for x in name.split("x")]
    except ValueError:
        return None
    if len(dims) < 2:
        return None
    return math.prod(dims[:-1]), dims[-1]


def refresh(path: pathlib.Path, dp: int, tp: int) -> bool:
    """Rewrite one record's ``memory.analytic_live_bytes``, ``fits_hbm``
    and ``fits_hbm_parsed``; ``False`` when it was not an ``ok`` record of
    a known arch and shape."""
    rec = json.loads(path.read_text())
    if rec.get("status") != "ok" or rec.get("arch") not in ARCHS \
            or rec.get("shape") not in SHAPES:
        return False
    cfg, shape = ARCHS[rec["arch"]], SHAPES[rec["shape"]]
    foot = analytic.analytic_live_bytes(
        cfg, shape, dp, tp, n_micro=rec.get("n_micro", 1),
        fsdp=rec.get("fsdp", False), optimizer=rec.get("optimizer", "adamw"))
    mem = rec["memory"]
    live = mem.get("live_bytes_device_estimate", mem["live_bytes"])
    mem["analytic_live_bytes"] = {k: int(v) for k, v in foot.items()}
    mem["fits_hbm_parsed"] = bool(live <= H100.hbm_bytes)
    mem["fits_hbm"] = bool(min(live, foot["total"]) <= H100.hbm_bytes)
    path.write_text(json.dumps(rec, indent=2))
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(DEFAULT_ROOT),
                    help="the dry run's output directory")
    args = ap.parse_args(argv)
    root = pathlib.Path(args.root)
    n = 0
    for mdir in sorted(root.iterdir()) if root.is_dir() else ():
        sizes = mesh_sizes(mdir.name) if mdir.is_dir() else None
        if sizes is None:
            continue
        n += sum(refresh(f, *sizes) for f in sorted(mdir.glob("*.json")))
    print(f"fits refreshed: {n} records under {root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
