"""The readings that a cell's correctness limits are set from: the program's
(sound runs), and the control's: the program itself run in the precision
below the configuration's (float32 for float64, bfloat16 for float32; the
apps run no matrix product, so TF32 has nothing to round), the path that
would tempt a later change.  A limit lies above the first and below the
second.  With ``--faults``, the readings of each fault that the cell's app
plants in the timed path (its ``FAULTS``) instead.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--units N] [--faults]

For each seed, in one process: ``--units`` units of work (HPCG: sets;
heat: steps, as many as a run's window makes) from the cell's inputs,
each run held to the float64 reference by the cell's own check.  One JSON
line a reading.  The benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

#: The precision a control runs in, by the configuration's dtype.
LOWER = {"float64": "float32", "float32": "bfloat16"}


def _reading(torch, cell: str, seed: int, units: int, device: str,
             config, params, limits, dtype=None, plant=None) -> dict:
    """The cell's numbers after ``units`` units of work of the program in
    ``dtype`` (the configuration's where ``None``), with ``plant(app)``
    applied first where given."""
    from perfbench import catalog
    wl = catalog.workload(cell)
    cfg = catalog.config(wl["config"]) if config is None else config
    app = catalog.app(cfg["app"]).App(
        torch, cfg, {**wl["params"], **(params or {})}, seed, device,
        dtype=None if dtype is None else getattr(torch, dtype))
    if plant is not None:
        plant(app)
    app.setup()
    for _ in range(units):
        app.unit()
    app.sync()
    app.finish()
    checks, _, _ = app.check(wl["limits"] if limits is None else limits)
    del app
    if device == "cuda":
        torch.cuda.empty_cache()
    return {k: v for k, (v, _) in checks.items()}


def readings(torch, cell: str, seed: int, units: int, device: str,
             config=None, params=None, limits=None) -> dict:
    """The program's and the control's readings of ``cell``'s numbers on
    ``seed``, after ``units`` units of work."""
    from perfbench import catalog
    wl = catalog.workload(cell)
    cfg = catalog.config(wl["config"]) if config is None else config
    limits = wl["limits"] if limits is None else limits
    args = (torch, cell, seed, units, device, cfg, params, limits)
    return {"cell": cell, "seed": seed, "units": units,
            "program": _reading(*args),
            "control": _reading(*args, dtype=LOWER[cfg["dtype"]]),
            "control_dtype": LOWER[cfg["dtype"]], "limits": limits}


def fault_readings(torch, cell: str, seed: int, units: int, device: str,
                   config=None, params=None, limits=None) -> dict:
    """Each of the app's planted faults' readings of ``cell``'s numbers on
    ``seed``, after ``units`` units of work."""
    import pytest

    from perfbench import catalog
    wl = catalog.workload(cell)
    cfg = catalog.config(wl["config"]) if config is None else config
    limits = wl["limits"] if limits is None else limits
    out = {}
    for name, plant in catalog.app(cfg["app"]).FAULTS.items():
        with pytest.MonkeyPatch.context() as mp:
            out[name] = _reading(torch, cell, seed, units, device, cfg,
                                 params, limits,
                                 plant=lambda app: plant(app, mp))
    return {"cell": cell, "seed": seed, "units": units, "faults": out,
            "limits": limits}


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="perfbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated whole numbers")
    p.add_argument("--units", type=int, default=1)
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("perfbench/control.py: no CUDA device", file=sys.stderr)
        return 3
    read = fault_readings if args.faults else readings
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = read(torch, args.workload, seed, args.units, "cuda")
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    ROOT = pathlib.Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]
    sys.exit(main(sys.argv[1:]))
