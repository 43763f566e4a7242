"""What the program's spans cost while they record: one cell's ``step_ms``
in untraced windows with ``repro_torch.spans.recording()`` off and on, in
turn, in one process on one card.

    python3 perfbench/span_cost.py --workload <cell> --seed <n> --seconds <s> --pairs <k>

Set-up as a benchmark run makes it, then ``k`` pairs of windows of
``--seconds`` each, off then on and on then off by turns.  Prints each
window's ``step_ms``, then one JSON object ``{"cell", "off", "on"}``.  Not
part of a benchmark run: the benchmark's windows keep the spans off.
"""
import argparse
import json
import pathlib
import sys
import time

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]

from perfbench import catalog, harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="perfbench/span_cost.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--pairs", type=int, default=3)
    args = p.parse_args(argv)
    import torch
    from repro_torch import spans
    wl = catalog.workload(args.workload)
    cfg = catalog.config(wl["config"])
    app = catalog.app(cfg["app"]).App(torch, cfg, wl["params"], args.seed,
                                      "cuda")
    app.setup()
    harness.log(f"set-up {time.perf_counter() - T_START:.3f} s")
    got = {"off": [], "on": []}
    for i in range(args.pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if on:
                with spans.recording():
                    steps, window_s = harness._window(app, args.seconds)
            else:
                steps, window_s = harness._window(app, args.seconds)
            step_ms = window_s * 1e3 / steps
            got["on" if on else "off"].append(step_ms)
            print(f"spans {'on' if on else 'off'}: {steps} steps, "
                  f"{window_s:.3f} s, step_ms {step_ms!r}", flush=True)
    print(harness.card_line(torch), flush=True)
    print(json.dumps({"cell": args.workload, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
