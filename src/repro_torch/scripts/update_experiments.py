"""The roofline table of the port's dry-run records: per mesh, each cell's
modelled H100 terms (seconds a step; decode: a token), the dominant term,
the useful-FLOP ratio, the live bytes a rank and whether it fits 80 GB.
Written between the table's markers in ``--out`` (or at its end, or a new
file), or printed.  Run after ``python -m repro_torch.launch.dryrun
--both-meshes``.

Run:  PYTHONPATH=src python -m repro_torch.scripts.update_experiments \\
          [--root experiments/dryrun_torch] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re

from .refresh_fits import DEFAULT_ROOT, mesh_sizes

BEGIN = "<!-- ROOFLINE TABLE BEGIN -->"
END = "<!-- ROOFLINE TABLE END -->"


def fmt(x) -> str:
    return f"{x:.2e}"


def build_table(root: pathlib.Path) -> str:
    """The table's markdown over every mesh directory under ``root``."""
    lines = []
    meshes = sorted((d for d in root.iterdir() if d.is_dir()
                     and mesh_sizes(d.name)), key=lambda d: (
                         len(d.name.split("x")), d.name)) \
        if root.is_dir() else []
    for mdir in meshes:
        dp, tp = mesh_sizes(mdir.name)
        lines.append(f"\n**Mesh {mdir.name} ({dp * tp} H100s)**: terms in "
                     f"seconds a step (decode: a token):\n")
        lines.append("| arch | shape | compute | memory | collective | "
                     "dominant | useful-FLOP ratio | live GB a rank | fits |")
        lines.append("|---|---|---:|---:|---:|---|---:|---:|---|")
        for f in sorted(mdir.glob("*.json")):
            r = json.loads(f.read_text())
            if r["status"] == "skipped":
                lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                             f"skip (long_500k is sub-quadratic-only) | — | "
                             f"— | — |")
                continue
            if r["status"] != "ok":
                lines.append(f"| {r['arch']} | {r['shape']} | ERROR |||||||")
                continue
            rf, m = r["roofline"], r["memory"]
            live = m.get("live_bytes_device_estimate", m["live_bytes"])
            total = m.get("analytic_live_bytes", {}).get("total", live)
            lines.append(
                f"| {r['arch']} | {r['shape']} | {fmt(rf['compute_s'])} | "
                f"{fmt(rf['memory_s'])} | {fmt(rf['collective_s'])} | "
                f"{rf['dominant']} | "
                f"{rf.get('useful_flops_ratio', 0):.2f} | "
                f"{min(live, total) / 1e9:.1f} | "
                f"{'Y' if m['fits_hbm'] else 'N'} |")
    lines.append(
        "\n`useful-FLOP ratio` = MODEL_FLOPS (6·N·D / 6·N_active·D, 2·N·D "
        "for prefill, 2·N_active per decoded token) over the captured "
        "step's FLOPs; live bytes are the capture's, or the analytic "
        "footprint where that is smaller.")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(DEFAULT_ROOT),
                    help="the dry run's output directory")
    ap.add_argument("--out", default=None,
                    help="the markdown file to write the table into "
                    "(default: print it)")
    args = ap.parse_args(argv)
    table = f"{BEGIN}\n{build_table(pathlib.Path(args.root))}\n{END}"
    if args.out is None:
        print(table)
        return 0
    out = pathlib.Path(args.out)
    text = out.read_text() if out.exists() else ""
    if BEGIN in text:
        text = re.sub(re.escape(BEGIN) + r".*?" + re.escape(END),
                      lambda _: table, text, flags=re.S)
    else:
        text = (text + "\n\n" if text else "") + table + "\n"
    out.write_text(text)
    print(f"roofline table written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
