"""Dataflow tier: which CTA writes which output element, for the port's
CUDA kernels.

``python -m repro_torch.analysis.dataflow`` sits between ``kernelcheck``
(does the launch fit the card?) and ``ircheck`` (captured steps).  It asks
whether the launch *means* what the kernel thinks it means.  For every
registered kernel case it takes the launch plan the wrapper would issue
(``ops.plan``, the mirror of the launcher's plan function), enumerates the
grid's CTAs (refusing more than :data:`MAX_GRID_POINTS`) and asks the
kernel's contract for the output region each CTA writes, as the CUDA code
computes it from ``blockIdx`` (a persistent kernel's stride loop, the
halo exchange's windows of each rank, the masked ragged edges).  Then:

  * **coverage** (``tile-uncovered``): every element of every output is
    written by some CTA (an unwritten element comes back as whatever the
    allocator left there);
  * **race freedom** (``write-race``): no element is written by two CTAs
    whose coordinates differ along a parallel grid axis (CTAs run in
    parallel and in no order; every grid axis of the port's kernels is
    parallel, a loop inside the CTA takes the TPU's sequential axes);
  * **bounds** (``block-oob``): every region lies inside its array (the
    card faults, or writes a neighbour's memory, where the TPU clamped);
  * **every grid axis moves a region** (``dropped-grid-index``): moving
    one step along a grid axis of extent > 1 changes what a CTA writes;
  * **shared memory by buffer** (``-v``): each plan's dynamic shared
    memory split by buffer (the q tile, the kv ring's stages, the sites'
    metadata, ...), and its static shared memory, each split summing to
    the plan's (``smem-split`` otherwise): the counterpart of the
    reference's lifetime-aware VMEM report.

The contract half (the grid axes' semantics, the case's plan, the
outputs' shapes and each CTA's regions) is declared next to each kernel's
``ops.plan`` (``DATAFLOW = DataflowContract(...)``) and found through the
``register_kernel_checker(..., dataflow="module[:attr]")`` registry.

No counterpart of the reference's ``scratch-uninit``: the kernels'
shared memory is not described in Python (their bodies are CUDA), and no
sanitizer runs on the card (``compute-sanitizer`` does not work there).
An element read before it is written shows only through the outputs:
``chip_smoke.py``'s analysis phase launches every kernel over two output
fills and guard regions, and holds the two results equal bit for bit.

Findings share the ``file:line rule message`` / nonzero-exit /
``--format json`` contract of the linter, ``kernelcheck`` and
``ircheck``; the location is the contract's region function.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import inspect
import itertools
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from .kernelcheck import _CASES, _fmt_case, dataflow_module, known_kernels
from .lint import Finding

#: Repo root (dataflow.py lives at src/repro_torch/analysis/).
REPO_ROOT = Path(__file__).resolve().parents[3]

#: Enumerating more CTAs than this is refused (a registered case should be
#: representative, and the main paths' grids are a few thousand CTAs).
MAX_GRID_POINTS = 1_000_000

_VALID_SEMANTICS = ("parallel", "sequential")


@dataclass(frozen=True)
class DataflowContract:
    """A kernel package's dataflow declaration, next to its ops.

    ``semantics`` names each grid axis (x, y, z) ``"parallel"`` (CTAs
    differing along it must not write one element) or ``"sequential"``
    (a CTA along it may revisit what another wrote: none of the port's
    kernels has one).  ``plan(case)`` is the case's launch plan,
    ``outputs(case)`` ``{name: shape}`` of what the kernel writes, and
    ``tiles(case, plan, cta)`` ``{name: [region, ...]}`` for the CTA at
    ``cta = (x, y, z)``, a region being one ``(lo, hi)`` range per
    dimension (``hi`` exclusive).
    """

    semantics: tuple
    plan: Callable
    outputs: Callable
    tiles: Callable

    def __post_init__(self):
        for sem in self.semantics:
            if sem not in _VALID_SEMANTICS:
                raise ValueError(
                    f"unknown grid-axis semantic {sem!r} "
                    f"(expected one of {_VALID_SEMANTICS})")


@dataclass
class DataflowReport:
    kernel: str
    case: str
    status: str                  # "ok" | "findings" | "error"
    grid: tuple = ()
    findings: list = field(default_factory=list)
    smem: list = field(default_factory=list)     # (name, bytes, kind)
    metrics: dict = field(default_factory=dict)
    note: str = ""

    @property
    def ok(self) -> bool:
        return not self.findings

    def as_dict(self) -> dict:
        return {"kernel": self.kernel, "case": self.case,
                "status": self.status, "grid": list(self.grid),
                "note": self.note, "metrics": self.metrics,
                "smem": [{"name": n, "bytes": b, "kind": k}
                         for n, b, k in self.smem],
                "findings": [dataclasses.asdict(f) for f in self.findings]}


def _src_of(fn, fallback=("<unknown>", 0)) -> tuple:
    """``(repo-relative path, line)`` of a contract function."""
    try:
        path = Path(inspect.getsourcefile(fn) or "")
        line = inspect.getsourcelines(fn)[1]
    except (OSError, TypeError):
        return fallback
    try:
        path = path.resolve().relative_to(REPO_ROOT)
    except ValueError:
        pass
    return str(path).replace("\\", "/"), line


# --------------------------------------------------------------------------
# Region bookkeeping: coordinate-compressed owner maps
# --------------------------------------------------------------------------

class _Owners:
    """Who wrote each element of one output, over the cells that the
    regions' boundaries cut the array into (so a 33-million-element output
    written in 2,048 blocks costs 2,048 cells, not 33 million)."""

    def __init__(self, shape: tuple, regions: list):
        import numpy as np
        self.shape = shape
        self.cuts = [sorted({0, n} | {r[d][0] for _, r in regions}
                            | {r[d][1] for _, r in regions})
                     for d, n in enumerate(shape)]
        self.owner = np.full([len(c) - 1 for c in self.cuts], -1,
                             dtype=np.int64)

    def slices(self, region) -> tuple:
        import bisect
        return tuple(slice(bisect.bisect_left(c, lo), bisect.bisect_left(c, hi))
                     for c, (lo, hi) in zip(self.cuts, region))

    def write(self, key: int, region):
        """Mark ``region`` written by ``key``; the first cell another key
        wrote (its index in the cell grid), else ``None``."""
        import numpy as np
        view = self.owner[self.slices(region)]
        clash = (view >= 0) & (view != key)
        hit = None
        if clash.any():
            hit = (tuple(int(i) for i in np.argwhere(clash)[0]),
                   int(view[clash][0]))
        view[view < 0] = key
        return hit

    def first_unwritten(self):
        """The lowest element no region covers, else ``None``."""
        import numpy as np
        holes = np.argwhere(self.owner < 0)
        if not len(holes):
            return None
        return tuple(self.cuts[d][int(i)] for d, i in enumerate(holes[0]))

    def element(self, cell: tuple) -> tuple:
        return tuple(self.cuts[d][i] for d, i in enumerate(cell))


def _region_ok(region, shape) -> bool:
    return len(region) == len(shape) and all(
        0 <= lo <= hi <= n for (lo, hi), n in zip(region, shape))


def _clip(region, shape) -> tuple:
    return tuple((min(max(lo, 0), n), min(max(hi, 0), n))
                 for (lo, hi), n in zip(region, shape))


# --------------------------------------------------------------------------
# One plan
# --------------------------------------------------------------------------

def analyze_plan(plan, outputs: dict, tiles: Callable, semantics, *,
                 kernel: str = "?", case: str = "?",
                 src: tuple = ("<plan>", 0)) -> DataflowReport:
    """Run every dataflow pass over ONE launch plan.

    ``outputs``: ``{name: shape}``; ``tiles(plan, cta)``: the CTA's
    ``{name: [region, ...]}``.  Separated from the registry driver so
    tests can analyze hand-built or deliberately broken plans."""
    rep = DataflowReport(kernel=kernel, case=case, status="ok",
                         grid=tuple(plan.grid))
    semantics = tuple(semantics)
    grid = tuple(plan.grid)

    def finding(rule, message):
        rep.findings.append(Finding(*src, rule, message))

    if len(semantics) != len(grid):
        finding("contract-mismatch",
                f"the contract names {len(semantics)} grid axes "
                f"{semantics}, the plan's grid {grid} has {len(grid)}")
        rep.status = "findings"
        return rep
    n_points = math.prod(grid)
    if n_points > MAX_GRID_POINTS:
        finding("grid-too-large",
                f"grid {grid} has {n_points:,} CTAs, over the "
                f"{MAX_GRID_POINTS:,} enumeration cap: register a smaller "
                "representative case")
        rep.status = "findings"
        return rep

    par = tuple(d for d, s in enumerate(semantics) if s == "parallel")
    writes = {name: [] for name in outputs}           # name -> [(key, r)]
    keys: dict = {}
    oob_seen = set()
    for cta in itertools.product(*(range(g) for g in grid)):
        key = keys.setdefault(tuple(cta[d] for d in par), len(keys))
        for name, regions in tiles(plan, cta).items():
            shape = outputs[name]
            for region in regions:
                region = tuple(tuple(int(v) for v in r) for r in region)
                if not _region_ok(region, shape):
                    if name not in oob_seen:
                        oob_seen.add(name)
                        finding("block-oob",
                                f"output {name!r}: CTA {cta} writes region "
                                f"{region}, outside its extent {shape}")
                    if len(region) != len(shape):
                        continue
                    region = _clip(region, shape)
                writes[name].append((key, region, cta))

    # dropped-grid-index: one step along an axis moves nothing
    origin = tiles(plan, (0,) * len(grid))
    for d in par:
        if grid[d] <= 1:
            continue
        probe = [0] * len(grid)
        probe[d] = 1
        if tiles(plan, tuple(probe)) == origin:
            finding("dropped-grid-index",
                    f"grid axis {'xyz'[d]} (extent {grid[d]}) moves no "
                    "output region: every CTA along it writes what CTA 0 "
                    "writes")

    n_regions = 0
    for name, shape in outputs.items():
        regs = writes[name]
        n_regions += len(regs)
        owners = _Owners(shape, [(k, r) for k, r, _ in regs])
        raced = False
        for key, region, cta in regs:
            hit = owners.write(key, region)
            if hit is not None and not raced:
                raced = True
                finding("write-race",
                        f"output {name!r}: element "
                        f"{owners.element(hit[0])} is written by CTA {cta} "
                        f"and by another CTA of distinct parallel "
                        "coordinates (CTAs run in no order)")
        hole = owners.first_unwritten()
        if hole is not None and math.prod(shape):
            missing = int((owners.owner < 0).sum())
            finding("tile-uncovered",
                    f"output {name!r} of shape {shape}: {missing} of "
                    f"{owners.owner.size} cells are never written (first "
                    f"unwritten element {hole})")

    dyn = sum(b for _, b, k in plan.buffers if k == "dynamic")
    static = sum(b for _, b, k in plan.buffers if k == "static")
    rep.smem = list(plan.buffers)
    if (plan.buffers or plan.smem) and dyn != plan.smem:
        finding("smem-split", f"dynamic buffers sum to {dyn} B, the plan "
                f"takes {plan.smem} B")
    if static != plan.static_smem:
        finding("smem-split", f"static buffers sum to {static} B, the plan "
                f"declares {plan.static_smem} B")
    rep.metrics = {"grid_points": n_points, "regions": n_regions,
                   "smem": plan.smem, "static_smem": plan.static_smem}
    if rep.findings:
        rep.status = "findings"
    return rep


# --------------------------------------------------------------------------
# Registry driver
# --------------------------------------------------------------------------

def dataflow_contract(name: str) -> DataflowContract | None:
    """Resolve a kernel's registered contract (``"module"`` -> its
    ``DATAFLOW``; ``"module:attr"`` -> that attribute), ``None`` when the
    kernel registered no dataflow module."""
    spec = dataflow_module(name)
    if spec is None:
        return None
    mod_path, _, attr = spec.partition(":")
    contract = getattr(importlib.import_module(mod_path), attr or "DATAFLOW",
                       None)
    if contract is None:
        raise ValueError(f"kernel {name!r} registered dataflow {spec!r} but "
                         "it names no contract")
    return contract


def analyze_case(name: str, case: dict,
                 contract: DataflowContract) -> DataflowReport:
    """Plan + analyze one registered kernel case under its contract."""
    case_s = _fmt_case(case)
    src = _src_of(contract.tiles)
    try:
        plan = contract.plan(dict(case))
        outputs = contract.outputs(dict(case))
    except (ValueError, RuntimeError) as e:
        rep = DataflowReport(kernel=name, case=case_s, status="error",
                             note=f"{type(e).__name__}: {e}")
        rep.findings.append(Finding(*src, "plan-failed",
                                    f"the case has no plan: {rep.note}"))
        return rep
    return analyze_plan(plan, outputs,
                        lambda p, cta: contract.tiles(case, p, cta),
                        contract.semantics, kernel=name, case=case_s,
                        src=src)


def check_dataflow(kernels=None) -> list:
    """Run the dataflow checker over every registered kernel's cases ->
    list of :class:`DataflowReport` (one per case)."""
    names = known_kernels() if kernels is None else list(kernels)
    unknown = sorted(set(names) - set(known_kernels()))
    if unknown:
        raise ValueError(f"unknown kernel(s) {unknown} (registered: "
                         f"{', '.join(known_kernels())})")
    reports = []
    for name in names:
        contract = dataflow_contract(name)
        if contract is None:
            reports.append(DataflowReport(
                kernel=name, case="*", status="skipped",
                note="no dataflow contract registered (pass dataflow= to "
                     "register_kernel_checker)"))
            continue
        for case in _CASES[name]:
            reports.append(analyze_case(name, case, contract))
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.dataflow",
        description="which CTA writes which output element, for the port's "
                    "CUDA kernels (coverage, races, bounds, dropped grid "
                    "axes, shared memory by buffer); exits nonzero on "
                    "findings")
    ap.add_argument("--kernel", action="append", default=None,
                    help="check only this kernel (repeatable)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print each plan's shared memory by buffer too")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="report as text lines (default) or one JSON "
                         "document for CI artifacts")
    args = ap.parse_args(argv)

    try:
        reports = check_dataflow(args.kernel)
    except ValueError as e:
        print(f"error: {e}")
        return 2

    findings = [f for r in reports for f in r.findings]
    if args.format == "json":
        print(json.dumps({"tool": "repro_torch.analysis.dataflow",
                          "n_findings": len(findings),
                          "n_skipped": sum(r.status == "skipped"
                                           for r in reports),
                          "reports": [r.as_dict() for r in reports]},
                         indent=2))
        return 1 if findings else 0

    for f in findings:
        print(f)
    hdr = (f"{'kernel':<16} {'case':<52} {'grid':<14} {'CTAs':>7} "
           f"{'smem':>7}  result")
    print(hdr)
    print("-" * len(hdr))
    for r in reports:
        grid = "x".join(str(g) for g in r.grid) if r.grid else "-"
        result = r.status if r.status == "skipped" else \
            ("ok" if r.ok else f"FAIL ({len(r.findings)})")
        m = r.metrics
        smem = str(m.get("smem", 0) + m.get("static_smem", 0)) if m else "-"
        print(f"{r.kernel:<16} {r.case:<52} {grid:<14} "
              f"{m.get('grid_points', '-'):>7} {smem:>7}  {result}")
        if args.verbose:
            for name, nbytes, kind in r.smem:
                print(f"    {kind:<8} {name:<28} {nbytes:>8} B")
    n_skip = sum(r.status == "skipped" for r in reports)
    print(f"dataflow: {len(findings)} finding(s) across {len(reports)} "
          f"case(s), {n_skip} skipped")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
