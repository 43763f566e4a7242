"""Launch-geometry checker for the port's CUDA kernels.

``python -m repro_torch.analysis.kernelcheck`` builds, for each registered
kernel and a set of representative shapes (the reference's cases and each
main path's real shape), the launch plan its wrapper would issue, from the
kernel package's ``ops.plan`` (the Python mirror of the plan function the
CUDA launcher calls; ``chip_smoke.py`` holds the two equal on the card),
and checks, without a card:

  * the **shape contract** the port's wrappers keep from the reference:
    the GQA head mapping, S and T divisible by their blocks, d by
    ``d_block``, L by ``chunk``, the segment axis within a grid axis;
  * **what an H100 refuses** (``kernels._plan.limits``): threads per block
    at most 1,024 and a multiple of 32 (128 for the warpgroup kernel),
    shared memory at most 232,448 bytes (static at most 48 KB), grid y and
    z at most 65,535, a cluster of at most 8 dividing the grid, a
    cooperative grid no larger than its co-resident CTAs, and for the TMA
    maps 16-byte-aligned strides, boxes of at most 256 and inner boxes of
    whole 16-byte units (within the swizzle).

Shape-contract and limit violations are **errors** (exit 1); float64
operands are a **warning** (exit 0), as in the reference: they run at the
card's float64 rate.  The reference's Mosaic tile-legality checks have no
counterpart: the TMA rules take their place.  Registers, spills and
occupancy are known only on the card, where ``chip_smoke.py``'s analysis
phase reads them from each source's ``<entry>_attrs``.

Where a plan depends on the card (the bracket kernel's SM count and CTAs
per SM, the halo flags route's co-resident CTAs), a case carries the
value, by default an H100's: 132 SMs, the CTAs per SM that 227 KB of
shared memory and 2,048 threads allow, 8 resident CTAs of 256 threads per
SM.

Checkers live in a registry (:func:`register_kernel_checker`), each with
its cases and the module holding its ``DATAFLOW`` contract (the dataflow
tier's).
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
from dataclasses import dataclass, field
from typing import Callable

@dataclass(frozen=True)
class Check:
    name: str
    ok: bool
    severity: str = "error"      # "error" | "warn"
    detail: str = ""
    contract: bool = False       # part of the wrapper's shape contract


@dataclass
class KernelReport:
    kernel: str
    case: str
    plan: object = None          # kernels._plan.LaunchPlan
    checks: list = field(default_factory=list)

    @property
    def grid(self) -> tuple:
        return self.plan.grid if self.plan is not None else ()

    @property
    def errors(self) -> list:
        return [c for c in self.checks
                if not c.ok and c.severity == "error"]

    @property
    def warnings(self) -> list:
        return [c for c in self.checks if not c.ok and c.severity == "warn"]

    @property
    def ok(self) -> bool:
        return not self.errors

    @property
    def contract_ok(self) -> bool:
        """The shape-contract verdict alone (the reference's checks)."""
        return all(c.ok for c in self.checks if c.contract)

    def as_dict(self) -> dict:
        p = self.plan
        plan = None if p is None else {
            "kernel": p.kernel, "grid": list(p.grid), "block": list(p.block),
            "smem": p.smem, "static_smem": p.static_smem,
            "cluster": list(p.cluster), "cooperative": p.cooperative}
        return {"kernel": self.kernel, "case": self.case, "ok": self.ok,
                "plan": plan,
                "checks": [dataclasses.asdict(c) for c in self.checks]}


# --------------------------------------------------------------------------
# Checker registry
# --------------------------------------------------------------------------

_CHECKERS: dict = {}
_CASES: dict = {}
_DATAFLOW: dict = {}


def register_kernel_checker(name: str, cases, *, dataflow: str = None,
                            overwrite: bool = False):
    """Register ``fn(case: dict) -> KernelReport`` under ``name`` with its
    representative shape ``cases``.  ``dataflow`` names the module (dotted
    path) whose ``DATAFLOW`` attribute is the kernel's
    :class:`repro_torch.analysis.dataflow.DataflowContract`, resolved only
    when the dataflow tier runs."""
    def deco(fn: Callable) -> Callable:
        if not overwrite and name in _CHECKERS:
            raise ValueError(f"kernel checker {name!r} is already "
                             "registered (pass overwrite=True)")
        _CHECKERS[name] = fn
        _CASES[name] = tuple(cases)
        if dataflow is not None:
            _DATAFLOW[name] = dataflow
        elif overwrite:
            _DATAFLOW.pop(name, None)
        return fn
    return deco


def known_kernels() -> tuple:
    return tuple(sorted(_CHECKERS))


def cases(name: str) -> tuple:
    """The registered cases of ``name``."""
    return _CASES[name]


def dataflow_module(name: str):
    """Dotted module path holding ``name``'s ``DATAFLOW`` contract, or
    ``None`` if the kernel registered without one."""
    return _DATAFLOW.get(name)


# --------------------------------------------------------------------------
# Shared check builders
# --------------------------------------------------------------------------

def _div(label: str, total: int, block: int) -> Check:
    return Check(f"{label} divisible", block > 0 and total % block == 0,
                 detail=f"{total} % {block}", contract=True)


def _sig_default(fn, name: str, fallback: int) -> int:
    """Default of a block-size keyword of a wrapper (follows
    ``inspect``); ``fallback`` if introspection fails."""
    try:
        d = inspect.signature(fn).parameters[name].default
        return d if isinstance(d, int) else fallback
    except (TypeError, ValueError, KeyError):
        return fallback


def _fmt_case(case: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in case.items())


def plan_checks(plan, co_resident: int | None = None) -> list:
    """The plan against the card's limits, as :class:`Check`\\ s."""
    from ..kernels import _plan
    return [Check(name, ok, detail=detail)
            for name, ok, detail in _plan.limits(plan, co_resident)]


def _dtype_checks(dtype: str) -> list:
    if dtype == "float64":
        return [Check("float64 operands", False, severity="warn",
                      detail="float64 runs on the card's FP64 pipe "
                             "(34 TFLOP/s against 67 in float32)")]
    return []


def report(kernel: str, case: dict, plan, contract=(), co_resident=None,
           dtype: str = "") -> KernelReport:
    """A report of ``plan`` for ``case``: the ``contract`` checks, the
    limits and the dtype warning."""
    rep = KernelReport(kernel, _fmt_case(case), plan)
    rep.checks = list(contract) + plan_checks(plan, co_resident) \
        + _dtype_checks(dtype)
    return rep


# --------------------------------------------------------------------------
# sweep_bracket: the fused bracket kernel, and the CSR segment sum
# --------------------------------------------------------------------------

_SWEEP_CASES = (
    # the reference's: parity mode (f64, odd sample count), the degenerate
    # minimum, an f32 grid whose bundle takes the tiled path
    {"S": 64, "n_max": 640, "n_seg": 12, "dtype": "float64"},
    {"S": 1, "n_max": 1, "n_seg": 1, "dtype": "float64"},
    {"S": 4096, "n_max": 8192, "n_seg": 257, "dtype": "float32"},
    # the main path: 262,144 scenarios of the tile-4096 stencil bundle, and
    # of the ten main-path bundles in one call (3,124 samples over 40
    # sites: the tiled path)
    {"S": 262_144, "n_max": 192, "n_seg": 4, "dtype": "float64"},
    {"S": 262_144, "n_max": 1042, "n_seg": 40, "dtype": "float64"},
)


@register_kernel_checker("sweep_bracket", _SWEEP_CASES,
                         dataflow="repro_torch.kernels.sweep_bracket.ops")
def check_sweep_bracket(case: dict) -> KernelReport:
    from ..kernels.sweep_bracket import ops
    plan = ops.case_plan(case)
    return report("sweep_bracket", case, plan,
                  [Check("segment axis within a grid axis",
                         1 <= case["n_seg"] <= ops._MAX_SEG,
                         detail=f"n_seg {case['n_seg']}", contract=True)],
                  dtype=case["dtype"])


_SEGSUM_CASES = (
    {"rows": 64, "n": 640, "n_seg": 12, "dtype": "float64"},
    {"rows": 4096, "n": 8192, "n_seg": 257, "dtype": "float32"},
)


@register_kernel_checker(
    "segment_sum", _SEGSUM_CASES,
    dataflow="repro_torch.kernels.sweep_bracket.ops:SEGSUM_DATAFLOW")
def check_segment_sum(case: dict) -> KernelReport:
    from ..kernels.sweep_bracket import ops
    return report("segment_sum", case, ops.segsum_case_plan(case),
                  dtype=case["dtype"])


# --------------------------------------------------------------------------
# flash_attention
# --------------------------------------------------------------------------

_FLASH_CASES = (
    # the reference's
    {"B": 1, "S": 512, "Hq": 8, "Hkv": 8, "T": 512, "D": 128,
     "dtype": "float32"},
    {"B": 2, "S": 128, "Hq": 16, "Hkv": 4, "T": 1024, "D": 128,
     "dtype": "bfloat16"},
    {"B": 1, "S": 2048, "Hq": 32, "Hkv": 8, "T": 2048, "D": 128,
     "dtype": "bfloat16"},
    # the main path: jamba's attention at train_4k, and the widest head
    {"B": 2, "S": 4096, "Hq": 32, "Hkv": 8, "T": 4096, "D": 128,
     "dtype": "bfloat16"},
    {"B": 1, "S": 512, "Hq": 8, "Hkv": 2, "T": 512, "D": 256,
     "dtype": "bfloat16"},
)


@register_kernel_checker("flash_attention", _FLASH_CASES,
                         dataflow="repro_torch.kernels.flash_attention.ops")
def check_flash_attention(case: dict) -> KernelReport:
    from ..kernels.flash_attention import ops
    B, S, Hq, Hkv, T, D = (case[k] for k in ("B", "S", "Hq", "Hkv", "T",
                                             "D"))
    block_q = min(_sig_default(ops.flash_attention, "block_q", 128), S)
    block_k = min(_sig_default(ops.flash_attention, "block_k", 128), T)
    contract = [Check("GQA head mapping", Hkv > 0 and Hq % Hkv == 0,
                      detail=f"Hq={Hq} % Hkv={Hkv}", contract=True),
                _div("query axis", S, block_q), _div("kv axis", T, block_k)]
    try:
        plan = ops.case_plan(case)
    except ValueError as e:                 # no route takes (dtype, D)
        rep = KernelReport("flash_attention", _fmt_case(case))
        rep.checks = contract + [Check("a kernel takes the head width",
                                       False, detail=str(e))]
        return rep
    return report("flash_attention", case, plan, contract,
                  dtype=case["dtype"])


# --------------------------------------------------------------------------
# mamba_scan
# --------------------------------------------------------------------------

_MAMBA_CASES = (
    # the reference's
    {"B": 2, "L": 512, "d": 768, "N": 16, "dtype": "float32"},
    {"B": 1, "L": 256, "d": 256, "N": 16, "dtype": "float32"},
    {"B": 4, "L": 2048, "d": 2048, "N": 16, "dtype": "float32"},
    # the main path: jamba's mixer at train_4k
    {"B": 2, "L": 4096, "d": 8192, "N": 16, "dtype": "float32"},
)


@register_kernel_checker("mamba_scan", _MAMBA_CASES,
                         dataflow="repro_torch.kernels.mamba_scan.ops")
def check_mamba_scan(case: dict) -> KernelReport:
    from ..kernels.mamba_scan import ops
    from ..kernels.mamba_scan.mamba_scan import MAX_STATES
    B, L, d, N = (case[k] for k in ("B", "L", "d", "N"))
    d_block = min(_sig_default(ops.mamba_scan, "d_block", 256), d)
    chunk = min(_sig_default(ops.mamba_scan, "chunk", 256), L)
    contract = [_div("channel axis", d, d_block), _div("time axis", L, chunk),
                Check(f"states within {MAX_STATES}", 1 <= N <= MAX_STATES,
                      detail=f"N={N}")]
    return report("mamba_scan", case, ops.case_plan(case), contract,
                  dtype=case["dtype"])


# --------------------------------------------------------------------------
# halo_exchange
# --------------------------------------------------------------------------

_HALO_CASES = (
    # the reference's boundary planes, on HPCG's ring of 8
    {"n": 8, "plane": (1, 256), "dtype": "float32"},
    {"n": 8, "plane": (1, 1024), "dtype": "float32"},
    {"n": 8, "plane": (1, 4096), "dtype": "float32"},
    # the main path: the V-cycle's four levels of the 8 x 256^3 HPCG
    {"n": 8, "plane": (256, 256), "dtype": "float32"},
    {"n": 8, "plane": (128, 128), "dtype": "float32"},
    {"n": 8, "plane": (64, 64), "dtype": "float32"},
    {"n": 8, "plane": (32, 32), "dtype": "float32"},
    # the flags route: a ring wider than a cluster, odd planes (no 16-byte
    # units)
    {"n": 64, "plane": (33, 31), "dtype": "float64"},
    {"n": 3, "plane": (129, 127), "dtype": "float32", "route": "flags"},
)


@register_kernel_checker("halo_exchange", _HALO_CASES,
                         dataflow="repro_torch.kernels.halo_exchange.ops")
def check_halo_exchange(case: dict) -> KernelReport:
    from ..kernels.halo_exchange import ops
    n = case["n"]
    route = case.get("route") or ops.route_for(n)
    contract = [Check("route takes the ring",
                      route == "flags" or n <= ops.CLUSTER_MAX,
                      detail=f"{route} with {n} ranks", contract=True)]
    try:
        plan = ops.case_plan(case)
    except RuntimeError as e:               # more ranks than resident CTAs
        rep = KernelReport("halo_exchange", _fmt_case(case))
        rep.checks = contract + [Check("ranks co-resident", False,
                                       detail=str(e))]
        return rep
    return report("halo_exchange", case, plan, contract,
                  co_resident=ops.case_max_ctas(case), dtype=case["dtype"])


# --------------------------------------------------------------------------
# stencil27: HPCG's 27-point operator
# --------------------------------------------------------------------------

_STENCIL_CASES = tuple(
    # the main path: the V-cycle's four levels of the 8 x 256^3 HPCG, in
    # float64 (the benchmark's) and float32 (its control's)
    {"n": 8, "slab": (s, s, s), "dtype": dtype}
    for dtype in ("float64", "float32") for s in (256, 128, 64, 32)) + (
    # ragged tiles in y and x, one run and several
    {"n": 3, "slab": (5, 7, 9), "dtype": "float64"},
    {"n": 8, "slab": (2, 3, 33), "dtype": "float32"},
)


@register_kernel_checker("stencil27", _STENCIL_CASES,
                         dataflow="repro_torch.kernels.stencil27.ops")
def check_stencil27(case: dict) -> KernelReport:
    from ..kernels.stencil27 import ops
    return report("stencil27", case, ops.case_plan(case),
                  dtype=case["dtype"])


# --------------------------------------------------------------------------
# mamba2_state: one Mamba-2 decode step's state update and readout
# --------------------------------------------------------------------------

_MAMBA2_STATE_CASES = (
    # the main path: granite-4.0-h-small's mixer at the benchmark's 256
    # slots, and one row
    {"b": 256, "H": 128, "P": 64, "N": 128},
    {"b": 1, "H": 128, "P": 64, "N": 128},
    # the reduced test widths (heads of 16, N 8), and ragged rows: P that
    # no warp's rows divide, the narrowest N, a thread's rows in turns
    {"b": 3, "H": 8, "P": 16, "N": 8},
    {"b": 5, "H": 6, "P": 20, "N": 8},
    {"b": 2, "H": 4, "P": 7, "N": 4},
    {"b": 2, "H": 2, "P": 128, "N": 128},
    {"b": 2, "H": 3, "P": 300, "N": 4},
)


@register_kernel_checker("mamba2_state", _MAMBA2_STATE_CASES,
                         dataflow="repro_torch.kernels.mamba2_state.ops")
def check_mamba2_state(case: dict) -> KernelReport:
    from ..kernels.mamba2_state import ops
    return report("mamba2_state", case, ops.case_plan(case),
                  dtype="float32")


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------

def check_kernels(kernels=None) -> list:
    """Run every registered checker over its cases -> ``KernelReport``\\ s."""
    names = known_kernels() if kernels is None else list(kernels)
    reports = []
    for name in names:
        try:
            checker = _CHECKERS[name]
        except KeyError:
            raise ValueError(
                f"unknown kernel {name!r} (registered: "
                f"{', '.join(known_kernels())})") from None
        for case in _CASES[name]:
            reports.append(checker(dict(case)))
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.kernelcheck",
        description="launch-geometry checks of the port's CUDA kernels "
                    "(shape contract, block, shared memory, grid, cluster, "
                    "cooperative and TMA limits); exits nonzero on errors")
    ap.add_argument("--kernel", action="append", default=None,
                    help="check only this kernel (repeatable)")
    ap.add_argument("--verbose", action="store_true",
                    help="print every check, not just failures")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="report as a table (default) or one JSON "
                         "document for CI artifacts")
    args = ap.parse_args(argv)

    try:
        reports = check_kernels(args.kernel)
    except ValueError as e:
        print(f"error: {e}")
        return 2

    n_err = sum(len(r.errors) for r in reports)
    n_warn = sum(len(r.warnings) for r in reports)
    if args.format == "json":
        print(json.dumps({"tool": "repro_torch.analysis.kernelcheck",
                          "n_errors": n_err, "n_warnings": n_warn,
                          "reports": [r.as_dict() for r in reports]},
                         indent=2))
        return 1 if n_err else 0

    hdr = (f"{'kernel':<16} {'case':<52} {'grid':<14} {'block':>5} "
           f"{'smem':>7}  result")
    print(hdr)
    print("-" * len(hdr))
    for r in reports:
        status = "ok" if r.ok else "FAIL"
        if r.warnings:
            status += f" ({len(r.warnings)} warn)"
        p = r.plan
        grid = "x".join(str(g) for g in p.grid) if p else "-"
        block = str(p.threads) if p else "-"
        smem = str(p.smem + p.static_smem) if p else "-"
        print(f"{r.kernel:<16} {r.case:<52} {grid:<14} {block:>5} "
              f"{smem:>7}  {status}")
        shown = r.checks if args.verbose \
            else [c for c in r.checks if not c.ok]
        for c in shown:
            mark = "ok " if c.ok else ("ERR" if c.severity == "error"
                                       else "wrn")
            print(f"    [{mark}] {c.name}: {c.detail}")
    print(f"kernelcheck: {len(reports)} cases across "
          f"{len(set(r.kernel for r in reports))} kernels, "
          f"{n_err} error(s), {n_warn} warning(s)")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
