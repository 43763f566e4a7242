"""One run of one cell: set-up, the measured or traced window, the metrics,
the correctness check, and the result line.

``main`` is what ``run.py`` calls on the card.  ``run_cell`` is the run
without the look for a card, so that tests drive it on the CPU at small
sizes.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import dataclass

from . import catalog, counts, tracing

#: Top-level module names that no run may hold once its window has closed:
#: JAX and the JAX package the port was made from (compared whole, so
#: ``repro_torch`` is not ``repro``).
FOREIGN = ("jax", "jaxlib", "flax", "repro")
#: Where a traced run leaves its profiler trace (one file a cell, replaced
#: by the next traced run of that cell).
TRACE_DIR = catalog.ROOT / "build" / "perfbench" / "traces"


@dataclass
class Context:
    """What a metric's reader reads.  ``window_s`` and ``steps`` are the
    untraced window's, ``trace`` the traced window's (each ``None`` in the
    other kind of run); ``peak_bytes`` is ``None`` off the card."""

    torch: object
    app: object
    setup_s: float
    peak_bytes: int | None
    window_s: float | None = None
    steps: int | None = None
    trace: tracing.Trace | None = None

    @property
    def on_card(self) -> bool:
        return self.app.device.type == "cuda"


def foreign_modules(modules=None) -> list:
    """The modules of :data:`FOREIGN` that the process holds."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FOREIGN))


def card_line(torch) -> str:
    """The card's name and power limit, and the peaks every share is
    taken against."""
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        limit = "unknown"
    return (f"card: {torch.cuda.get_device_name(0)}, power.limit {limit}; "
            f"peaks: HBM {counts.HBM_BYTES_S:.3e} B/s, float32 "
            f"{counts.FP32_OPS_S:.3e} and float64 {counts.FP64_OPS_S:.3e} "
            f"operations/s (H100 SXM data sheet)")


def log(msg: str):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def _window(app, seconds: float) -> tuple:
    """Enqueue units of work until ``seconds`` have passed on the host,
    then synchronise: (app steps, seconds).  No unit waits for the one
    before it."""
    app.sync()
    t0 = time.perf_counter()
    steps, marks = 0, [t0]
    while True:
        steps += app.unit()
        marks.append(time.perf_counter())
        if marks[-1] - t0 >= seconds:
            break
    app.sync()
    window_s = time.perf_counter() - t0
    # The host waits while the card's queue is full, so the gaps between
    # enqueues follow the card's pace: a slow stretch shows in the largest.
    gaps = sorted(b - a for a, b in zip(marks, marks[1:]))
    log(f"host seconds between enqueued units: least {gaps[0]:.4f}, "
        f"median {gaps[len(gaps) // 2]:.4f}, most {gaps[-1]:.4f}")
    return steps, window_s


def run_cell(torch, cell: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, bench: dict | None = None,
             config: dict | None = None, params: dict | None = None,
             limits: dict | None = None, patch=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object.
    ``config``, ``params`` and ``limits`` replace the cell's configuration
    and limits and update its traffic parameters (tests run small sizes);
    ``patch(app)``, if given, runs after the app is built (tests break the
    timed path)."""
    bench = catalog.benchmark() if bench is None else bench
    wl = catalog.workload(cell)
    cfg = catalog.config(wl["config"]) if config is None else config
    traffic = {**wl["params"], **(params or {})}
    log(f"{cell} seed {seed}: torch and the device ready at "
        f"{time.perf_counter() - t_start:.3f} s")
    app = catalog.app(cfg["app"]).App(torch, cfg, traffic, seed, device)
    if patch is not None:
        patch(app)
    log(f"program loaded at {time.perf_counter() - t_start:.3f} s")
    app.setup()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    on_card = app.device.type == "cuda"
    ctx = Context(torch, app, setup_s, None)
    if trace:
        ctx.trace = tr = tracing.traced_window(
            torch, lambda: sum(app.unit() for _ in range(app.trace_units)),
            app.sync, on_card)
        log(f"traced window {tr.window_s:.3f} s, {tr.steps} steps, "
            f"{len(tr.device)} device operations of {tr.enqueued} enqueued "
            f"({time.perf_counter() - t_start:.3f} s into the run)")
    else:
        ctx.steps, ctx.window_s = _window(app, seconds)
        log(f"window {ctx.window_s:.3f} s, {ctx.steps} steps")
    if on_card:
        ctx.peak_bytes = torch.cuda.max_memory_allocated(app.device)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in catalog.metrics_of(bench, cell, kind):
        value = catalog.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    trace_result = ctx.trace
    if trace_result is not None:
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        trace_result.profiler.export_chrome_trace(
            str(TRACE_DIR / f"{cell}.json.gz"))
        trace_result.profiler = None
        log(f"trace written ({time.perf_counter() - t_start:.3f} s into "
            f"the run)")
    app.finish()
    t_check = time.perf_counter()
    checks, attempted, failed = app.check(
        wl["limits"] if limits is None else limits)
    log(f"check {time.perf_counter() - t_check:.3f} s; the run "
        f"{time.perf_counter() - t_start:.3f} s")
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(app.device)
                            if on_card else "cpu"),
                   "count": 1, "memory_peak_bytes": ctx.peak_bytes or 0}
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info}
    if trace_result is not None:
        device_info["busy_s"] = trace_result.busy_s
        device_info["window_s"] = trace_result.window_s
        out["breakdown"] = {"device_ops": trace_result.top_ops(),
                            "idle_gaps": trace_result.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="perfbench/run.py",
                                description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = catalog.benchmark()
    chips = catalog.cell_entry(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    out = run_cell(torch, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", t_start, bench=bench)
    # after the window, so that set-up holds no call of nvidia-smi
    print(card_line(torch), flush=True)
    bad = foreign_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
