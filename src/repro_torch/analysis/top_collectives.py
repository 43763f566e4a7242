"""Print the top collectives by total wire bytes of an HLO text (a dry-run
cell's), and (optionally) how stable each one's message-free verdict is
across a CXL latency-band scenario sweep: the port's counterpart of the
JAX package's ``scripts/top_collectives.py``, through the port's
``core.hlo``, ``ExecPlan``, ``CommAdvisor`` and ``price``.

Usage: ``python -m repro_torch.analysis.top_collectives HLO.gz [N]
[--sweep] [--backend=SPEC] [--chunk=K]``

``--backend=`` takes the ``ExecPlan.parse`` spec form (a registered backend
name plus options, e.g. ``--backend=fused:device=cuda``); ``--chunk=K``
bounds peak memory to K scenarios at a time.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
import sys

USAGE = ("usage: python -m repro_torch.analysis.top_collectives HLO.gz [N] "
         "[--sweep] [--backend=SPEC] [--chunk=K]")


def main(argv=None) -> int:
    from ..core import CommAdvisor, ExecPlan, hlo, price

    argv = sys.argv[1:] if argv is None else list(argv)
    args = [a for a in argv if not a.startswith("--")]
    do_sweep = "--sweep" in argv
    backend, chunk = "numpy", None
    for a in argv:
        if a.startswith("--backend="):
            backend = a.split("=", 1)[1]
        elif a.startswith("--chunk="):
            chunk = int(a.split("=", 1)[1])
    try:
        # ExecPlan.parse validates the backend against the registry
        plan = ExecPlan.parse(backend)
    except ValueError as e:
        print(f"error: {e}\n{USAGE}", file=sys.stderr)
        return 1
    if chunk is not None:
        plan = dataclasses.replace(plan, chunk_scenarios=chunk)
    if not args:
        print(f"error: missing HLO input\n{USAGE}", file=sys.stderr)
        return 1
    path = args[0]
    n = int(args[1]) if len(args) > 1 else 12
    if not os.path.isfile(path):
        print(f"error: HLO input not found: {path}", file=sys.stderr)
        return 1
    with gzip.open(path, "rt") as f:
        text = f.read()
    ops = hlo.parse_collectives(text)
    ops.sort(key=lambda o: -o.total_wire_bytes)
    total = sum(o.total_wire_bytes for o in ops)
    print(f"total wire: {total/1e9:.1f} GB over {len(ops)} sites")
    for o in ops[:n]:
        print(f"  {o.total_wire_bytes/1e9:8.1f} GB  {o.kind:18s} "
              f"g={o.group_size:<3} x{o.multiplier:<6.0f} "
              f"{o.result_bytes/1e6:8.1f} MB/op  {o.name[:28]:28s} in "
              f"{o.computation[:44]}")

    if do_sweep:
        advisor = CommAdvisor()
        res = price(text, advisor.default_grid(), plan=plan, advisor=advisor)
        frac_free = res.beneficial_mask().mean(axis=0)
        mean_gain = res.gain_ns.mean(axis=0)
        print(f"\nscenario sweep: {len(res.grid)} points, "
              f"backend={plan.backend} (cxl_lat x atomic at 0.5x..3x of "
              "the TPU preset)")
        order = sorted(range(len(res.call_ids)), key=lambda j: -mean_gain[j])
        for j in order[:n]:
            verdict = ("always-free" if frac_free[j] == 1.0 else
                       "never-free" if frac_free[j] == 0.0 else
                       f"free in {100 * frac_free[j]:3.0f}%")
            print(f"  {mean_gain[j]/1e3:10.1f} us mean gain  {verdict:14s} "
                  f"{res.call_ids[j][:64]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
