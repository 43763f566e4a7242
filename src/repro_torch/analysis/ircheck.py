"""Captured-step checks over registered entry points: the IR tier.

``python -m repro_torch.analysis.ircheck`` captures the port's
representative steps (the sweep's fused pricing and streaming chunk, the
serving steps, the train step) with ``core.graph.capture``, the port's
counterpart of ``jax.jit(...).lower().compile()``: one pass under fake
tensors, so nothing runs and nothing is allocated.  An audit mode rides
inside the capture and sees every op the step dispatches.  Passes, each
the counterpart of one of the JAX package's:

  * ``peak-live-bytes``: ``CapturedStep.peak_bytes`` (the storages the
    step made and held at once), against the committed budget.
  * ``f64-promotion``: ops whose float inputs are 32 bits or narrower and
    whose output is float64.  PyTorch has no ambient x64 switch to mask a
    promotion, so the pass reads the one capture; entries declared
    ``x64=True`` (float64 by design: the sweep) are exempt.
  * ``host-sync`` (``host-callback``'s counterpart): ops that wait for
    the card: a data-dependent op (``.item()``, ``int()`` of a tensor,
    ``nonzero``, ``bincount``: under fake tensors they have no value, so
    the audit records them and lets the capture go on with a stand-in),
    device-to-host copies, and tensors the step makes from host data
    (``torch.tensor(...)``, ``new_tensor``: ``lift_fresh`` in the capture)
    or copies from the host: on the card each is a copy that blocks the
    host until it lands.  A capture on the host cannot tell a tensor that
    stays there from one that goes to the card, so every one counts, and
    the host's and the card's findings agree.  An entry allows an op by
    name, or by name in one file (``"op@path"``), with a reason
    (``allow_syncs``).
  * ``inplace-dead`` (``donation-dead``'s counterpart): a tensor the entry
    declares the step updates in place (the decode caches, the paged
    pools, the train step's parameters and moments) that no op of the
    step writes: the step reallocated it or never touched it.
  * ``collective-mesh``: collectives whose group size is no product of
    the entry's mesh axes, and single-member groups (a
    ``collective-permute`` records no group, as in the reference's HLO).
  * ``layout-churn``: bytes written by copy ops on one device (``copy_``,
    ``clone``, ``_to_copy``, the ``*_copy`` views; PyTorch's transposes are
    views, so their bytes show where a copy makes one contiguous), against
    the committed budget.  Copies from the host are ``host-sync``'s, and
    counted apart (``host_to_device``).

Budgets for ``peak_live_bytes`` and ``copy_transpose_bytes`` live in
``ircheck_baseline.json`` beside this module (``--write-baseline``), and a
measurement may exceed its budget by ``DEFAULT_SLACK`` (0.25).

Entry points live in an open registry (:func:`register_entrypoint`); each
registration is a lazy builder ``builder(device="cpu", abstract=True) ->
EntrySpec``.  ``abstract`` builds models with fake weights (a capture
needs no more, and a train step's gradients need the parameters the
capture sees); ``abstract=False`` builds real tensors on ``device``, for a
real call.  Builtin entries register themselves from their owning modules
through ``register_ircheck_entrypoints(register)``.  ``min_devices`` is
the ranks an entry's step runs on: the checker joins a fake process group
of that many ranks around it when none is initialized.

No counterpart of the reference's x64 re-trace (PyTorch's promotions are
real in the one capture) or of its HLO alias parsing (the in-place writes
are ops the audit sees).  Findings use the ``file:line rule message`` /
nonzero-exit contract of the linter.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import importlib
import inspect
import json
import math
import sys
import traceback
from dataclasses import dataclass, field
from itertools import combinations
from pathlib import Path
from typing import Callable

from .lint import Finding

#: Tolerance of a measured metric over its committed budget.
DEFAULT_SLACK = 0.25

#: Repo root (ircheck.py lives at src/repro_torch/analysis/).
REPO_ROOT = Path(__file__).resolve().parents[3]
BASELINE = Path(__file__).resolve().with_name("ircheck_baseline.json")

#: Ops that copy a tensor's bytes (the layout-churn pass).
COPY_OPS = frozenset({"aten::copy_", "aten::clone", "aten::_to_copy",
                      "aten::permute_copy", "aten::transpose_copy",
                      "aten::t_copy", "aten::expand_copy",
                      "aten::view_copy", "aten::_unsafe_view_copy"})
#: Ops that read a tensor's value on the host (``.item()``, ``int()``).
SCALAR_OPS = frozenset({"aten::_local_scalar_dense"})


# --------------------------------------------------------------------------
# Entry-point registry
# --------------------------------------------------------------------------

@dataclass
class EntrySpec:
    """One configuration of a step to capture.

    ``fn(*args, **kwargs)`` is the step; its tensors may be real or fake
    (``core.graph.abstract``).  ``inplace`` names what the step updates in
    place: an argnum, or a path ``(argnum, key, ...)`` into that argument.
    ``mesh_axes`` ``{axis: size}`` drives the collective audit (the ranks
    the step runs on are its registration's ``min_devices``).
    ``x64=True`` exempts the entry from the promotion pass.
    ``allow_syncs`` ``{key: reason}`` allows host syncs: a key is an op
    name (``"aten::bincount"``) or an op name in one repo file
    (``"aten::lift_fresh@src/repro_torch/train/optimizer.py"``).  ``grad`` captures with grad enabled (a train step).  ``src``
    is the reported ``path:line``; empty means introspect ``fn``.
    """

    name: str
    fn: Callable
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    inplace: tuple = ()
    mesh_axes: dict | None = None
    x64: bool = False
    allow_syncs: dict = field(default_factory=dict)
    grad: bool = False
    src: str = ""


_ENTRYPOINTS: dict = {}
_BUILTINS_LOADED = False

#: Modules owning builtin entry points; each exposes
#: ``register_ircheck_entrypoints(register)``.
_BUILTIN_PROVIDERS = ("repro_torch.core.sweep_kernel",
                      "repro_torch.serve.scheduler",
                      "repro_torch.serve.paged", "repro_torch.launch.train")


def register_entrypoint(name: str, builder=None, *, min_devices: int = 1,
                        overwrite: bool = False):
    """Register a lazy :class:`EntrySpec` builder under ``name``.

    ``builder(device="cpu", abstract=True)`` returns the spec (heavy
    imports and model construction belong inside it).  Usable directly or
    as a decorator.  ``min_devices`` gates the builder too: it runs inside
    the fake group of that many ranks.  Re-registering raises unless
    ``overwrite=True``."""
    def add(b):
        if not overwrite and name in _ENTRYPOINTS:
            raise ValueError(f"ircheck entry point {name!r} is already "
                             "registered (pass overwrite=True)")
        _ENTRYPOINTS[name] = (b, int(min_devices))
        return b
    return add if builder is None else add(builder)


def _load_builtins() -> None:
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    for mod_name in _BUILTIN_PROVIDERS:
        importlib.import_module(mod_name).register_ircheck_entrypoints(
            register_entrypoint)


def known_entrypoints() -> tuple:
    """Sorted names of every registered entry point (builtins loaded)."""
    _load_builtins()
    return tuple(sorted(_ENTRYPOINTS))


def build_entry(name: str, device: str = "cpu", abstract: bool = True):
    """``name``'s spec, built (call inside :func:`ranks` of its
    ``min_devices``)."""
    _load_builtins()
    return _ENTRYPOINTS[name][0](device=device, abstract=abstract)


def min_devices(name: str) -> int:
    _load_builtins()
    return _ENTRYPOINTS[name][1]


@contextlib.contextmanager
def ranks(n: int):
    """A fake process group of ``n`` ranks around the block when ``n > 1``
    and no group is initialized (yields the world size in force, 1 without
    a group)."""
    import torch.distributed as dist
    if n <= 1 or dist.is_initialized():
        yield dist.get_world_size() if dist.is_initialized() else 1
        return
    from ..launch.mesh import init_fake_ranks
    init_fake_ranks(n)
    try:
        yield n
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# The audit: a dispatch mode inside the capture
# --------------------------------------------------------------------------

def _where() -> str:
    """``path:line`` of the innermost frame in the repo (outside this
    module and the capture) that led to the current op."""
    skip = {Path(__file__).resolve(),
            Path(__file__).resolve().parents[1] / "core" / "graph.py"}
    for f in reversed(traceback.extract_stack()):
        path = Path(f.filename).resolve()
        if path in skip:
            continue
        try:
            rel = path.relative_to(REPO_ROOT)
        except ValueError:
            continue                       # torch, the standard library
        return f"{rel.as_posix()}:{f.lineno}"
    return "<unknown>"


def _transfer(name: str, ins: list, outs: list) -> str:
    """``"to host"`` for a copy from the card to the host (``_to_copy``
    of a device tensor to the CPU, ``copy_`` into a CPU tensor from a
    device one), ``"to device"`` for one the other way, else ``""``."""
    if name == "aten::_to_copy" and ins and outs:
        src, dst = ins[0], outs[0]
    elif name == "aten::copy_" and len(ins) >= 2:
        dst, src = ins[0], ins[1]
    else:
        return ""
    if (src.device.type == "cpu") == (dst.device.type == "cpu"):
        return ""
    return "to host" if dst.device.type == "cpu" else "to device"


def _storage_key(t) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _audit_mode():
    """A ``TorchDispatchMode`` recording what the passes read (made here so
    that importing this module imports no torch)."""
    import torch
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import (TorchDispatchMode,
                                              _disable_current_modes)

    narrow = (torch.float32, torch.float16, torch.bfloat16)
    wide = (torch.float64, torch.complex128)

    class _Audit(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.promotions = collections.Counter()
            self.syncs = []                  # (op name, where)
            self.written = set()             # storage keys
            self.copy_bytes = 0
            self.uploads = []                # (op name, where) from the host

        def _stand_in(self, func, args, kwargs):
            """Run a data-dependent op on zeros of its inputs' shapes (real,
            on the host), and hand back fakes of its outputs' shapes."""
            with _disable_current_modes():
                def zeros(t):
                    if isinstance(t, torch.Tensor):
                        return torch.zeros(t.shape, dtype=t.dtype)
                    return t
                real = func(*pytree.tree_map(zeros, args),
                            **pytree.tree_map(zeros, kwargs))
            dev = next((t.device for t in pytree.tree_leaves((args, kwargs))
                        if isinstance(t, torch.Tensor)), None)
            return pytree.tree_map(
                lambda r: torch.empty(r.shape, dtype=r.dtype, device=dev)
                if isinstance(r, torch.Tensor) else r, real)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.name()
            ins = [t for t in pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            if name in SCALAR_OPS and ins \
                    and getattr(ins[0], "constant", None) is None:
                self.syncs.append((name, _where()))
            try:
                out = func(*args, **kwargs)
            except (DataDependentOutputException,
                    DynamicOutputShapeException):
                if name not in SCALAR_OPS:
                    self.syncs.append((name, _where()))
                out = self._stand_in(func, args, kwargs)
            outs = [t for t in pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            if any(t.dtype in narrow for t in ins) \
                    and any(t.dtype in wide for t in outs):
                self.promotions[name] += 1
            moved = _transfer(name, ins, outs)
            if moved == "to host":
                self.syncs.append((f"{name} (device to host)", _where()))
            elif moved == "to device":
                self.uploads.append((f"{name} (host to device)", _where()))
            elif name == "aten::lift_fresh":
                self.uploads.append((f"{name} (a tensor from host data)",
                                     _where()))
            elif name in COPY_OPS:
                self.copy_bytes += sum(_nbytes(t) for t in outs)
            self._note_writes(func, args, kwargs)
            return out

        def _note_writes(self, func, args, kwargs):
            for i, a in enumerate(func._schema.arguments):
                if a.alias_info is None or not a.alias_info.is_write:
                    continue
                val = args[i] if i < len(args) else kwargs.get(a.name)
                for t in pytree.tree_leaves(val):
                    if isinstance(t, torch.Tensor):
                        self.written.add(_storage_key(t))

    return _Audit()


# --------------------------------------------------------------------------
# Pass helpers
# --------------------------------------------------------------------------

def _select(args: tuple, path):
    """The value at ``path`` (an argnum, or ``(argnum, key, ...)``)."""
    path = (path,) if isinstance(path, int) else tuple(path)
    val = args[path[0]]
    for key in path[1:]:
        val = val[key]
    return val


def arg_tensors(val) -> list:
    """The tensors of one step argument: a pytree of tensors, or leaves
    that carry ``.tensors`` (``models.convert.reference_leaves``)."""
    import torch
    from torch.utils import _pytree as pytree
    if isinstance(val, (list, tuple)) and val \
            and hasattr(val[0], "tensors"):
        return [t for leaf in val for t in leaf.tensors]
    return [t for t in pytree.tree_leaves(val)
            if isinstance(t, torch.Tensor)]


def collective_findings(calls, mesh_axes: dict | None) -> list:
    """Messages for collectives whose group does not match the registered
    mesh, and for single-member groups.  ``calls``: ``(kind, bytes,
    group size, stack)`` as ``CapturedStep.calls`` holds them."""
    msgs = []
    valid: set = set()
    if mesh_axes:
        sizes = [int(s) for s in mesh_axes.values()]
        for r in range(1, len(sizes) + 1):
            for combo in combinations(sizes, r):
                valid.add(math.prod(combo))
    seen = set()
    for kind, _nb, group, _stack in calls:
        if (kind, group) in seen:
            continue
        seen.add((kind, group))
        if kind == "collective-permute":
            continue                       # records no group (the HLO's 1)
        if group <= 1:
            msgs.append(f"degenerate single-member {kind}: the collective "
                        "moves no data but still pays its launch and sync")
        elif mesh_axes is None:
            msgs.append(f"{kind} over groups of {group} but the entry "
                        "registered no mesh (pass mesh_axes= so group sizes "
                        "can be cross-checked)")
        elif group not in valid:
            axes = ", ".join(f"{k}={v}" for k, v in mesh_axes.items())
            msgs.append(f"{kind} spans {group} members: not a product of "
                        f"the registered mesh axes ({axes})")
    return msgs


# --------------------------------------------------------------------------
# Per-entry driver
# --------------------------------------------------------------------------

@dataclass
class EntryReport:
    """The checker's result for one entry point."""

    name: str
    status: str                   # "ok" | "findings" | "skipped" | "error"
    findings: list = field(default_factory=list)
    metrics: dict = field(default_factory=dict)
    note: str = ""
    #: ``(op, where)`` of each host sync the entry's ``allow_syncs``
    #: permits (what a real call on the card may sync at)
    allowed: list = field(default_factory=list)

    def as_dict(self) -> dict:
        return {"name": self.name, "status": self.status,
                "note": self.note, "metrics": self.metrics,
                "findings": [dataclasses.asdict(f) for f in self.findings]}


def src_for(fn) -> str:
    """Repo-root-relative ``path:line`` of a plain function."""
    try:
        path = Path(inspect.getsourcefile(fn) or "")
        line = inspect.getsourcelines(fn)[1]
    except (OSError, TypeError):
        return ""
    try:
        path = path.resolve().relative_to(REPO_ROOT)
    except ValueError:
        pass
    return f"{path.as_posix()}:{line}"


def _src_of(spec: EntrySpec) -> tuple:
    src = spec.src or src_for(getattr(spec.fn, "__wrapped__", spec.fn))
    path, _, line = src.rpartition(":")
    if path and line.isdigit():
        return path, int(line)
    return (src or "<unknown>"), 0


def check_entry(spec: EntrySpec, baseline_entry: dict | None = None,
                slack: float = DEFAULT_SLACK):
    """Capture ``spec`` and run every pass over it -> ``(EntryReport,
    CapturedStep or None)``.  ``baseline_entry`` is this entry's budgets
    (``None`` skips the budget comparisons)."""
    import torch

    from ..core import graph

    path, line = _src_of(spec)
    rep = EntryReport(name=spec.name, status="ok")

    def finding(rule: str, message: str) -> None:
        rep.findings.append(Finding(path, line, rule,
                                    f"[{spec.name}] {message}"))

    audit = _audit_mode()
    declared = {}
    for p in spec.inplace:
        declared[p] = arg_tensors(_select(spec.args, p))

    def audited(*a, **kw):
        with audit:
            return spec.fn(*a, **kw)

    try:
        # the inputs' fakes first, so the keys below are the capture's
        fakes = {p: [graph._fake(t) for t in ts] for p, ts in declared.items()}
        with torch.set_grad_enabled(spec.grad):
            captured = graph.capture(audited, *spec.args, name=spec.name,
                                     **spec.kwargs)
    except Exception as e:                                 # noqa: BLE001
        rep.status = "error"
        rep.note = f"{type(e).__name__}: {e}"
        finding("entry-error", f"capture failed: {rep.note}")
        return rep, None

    rep.metrics["peak_live_bytes"] = int(captured.peak_bytes)
    rep.metrics["copy_transpose_bytes"] = int(audit.copy_bytes)
    rep.metrics["host_syncs"] = len(audit.syncs)
    rep.metrics["host_to_device"] = len(audit.uploads)

    if not spec.x64:
        for op, count in sorted(audit.promotions.items()):
            finding("f64-promotion",
                    f"{count} {op!r} op(s) turn 32-bit or narrower float "
                    "inputs into float64: pin the dtype of the constant or "
                    "the op")

    # one upload a line: on the card ``torch.tensor(x, device=...)`` is a
    # ``lift_fresh`` and a copy, on the host the ``lift_fresh`` alone
    lines, uploads = set(), []
    for op, where in audit.uploads:
        if where not in lines:
            lines.add(where)
            uploads.append((op, where))
    for events, why in (
            (audit.syncs, "waits for the card"),
            (uploads, "is a copy from the host, which waits for the card "
                      "(make the value on the device or pass a Python "
                      "scalar)")):
        for op, where in events:
            base = op.split(" ")[0]
            keys = (op, base, f"{base}@{where.rpartition(':')[0]}")
            if any(k in spec.allow_syncs for k in keys):
                rep.allowed.append((op, where))
            else:
                finding("host-sync", f"{op} at {where} {why} (allow_syncs= "
                        "it with a reason if it is deliberate)")

    for p, ts in fakes.items():
        dead = [t for t in ts if _storage_key(t) not in audit.written]
        if dead:
            finding("inplace-dead",
                    f"argument {p} is declared updated in place, but {len(dead)}"
                    f" of its {len(ts)} tensors are never written in place "
                    "(the step reallocates them or leaves them untouched)")

    for msg in collective_findings(captured.calls, spec.mesh_axes):
        finding("collective-mesh", msg)

    if baseline_entry is not None:
        for metric, rule in (("peak_live_bytes", "peak-live-bytes"),
                             ("copy_transpose_bytes", "layout-churn")):
            measured = rep.metrics[metric]
            budget = baseline_entry.get(metric)
            if budget is None:
                finding("baseline-missing",
                        f"no {metric} budget recorded in {BASELINE.name} "
                        "(run with --write-baseline to record it)")
            elif measured > budget * (1.0 + slack):
                finding(rule,
                        f"{metric} grew to {measured:,} bytes, over the "
                        f"committed budget {budget:,} (+{slack:.0%} slack):"
                        " rebaseline deliberately with --write-baseline or "
                        "fix the regression")

    if rep.findings:
        rep.status = "findings"
    return rep, captured


def check_entrypoints(names=None, baseline: dict | None = None,
                      slack: float | None = None, device: str = "cpu"
                      ) -> list:
    """Capture and check the named (default: all) registered entry points
    on ``device`` -> list of :class:`EntryReport`.  ``baseline`` is the
    parsed ``ircheck_baseline.json`` (``None`` disables budgets)."""
    all_names = known_entrypoints()
    if names:
        unknown = sorted(set(names) - set(all_names))
        if unknown:
            raise ValueError(f"unknown entry point(s) {unknown} "
                             f"(registered: {', '.join(all_names)})")
        run_names = [n for n in all_names if n in set(names)]
    else:
        run_names = list(all_names)
    entries = (baseline or {}).get("entries", {})
    if slack is None:
        slack = float((baseline or {}).get("slack", DEFAULT_SLACK))
    reports = []
    for name in run_names:
        n = min_devices(name)
        with ranks(n) as world:
            if world != n and n > 1:
                reports.append(EntryReport(
                    name=name, status="skipped",
                    note=f"needs {n} ranks, the initialized group has "
                         f"{world}"))
                continue
            spec = build_entry(name, device=device)
            base = entries.get(name) if baseline is not None else None
            reports.append(check_entry(spec, baseline_entry=base,
                                       slack=slack)[0])
    return reports


# --------------------------------------------------------------------------
# Baseline I/O + CLI
# --------------------------------------------------------------------------

def load_baseline(path) -> dict | None:
    path = Path(path)
    if not path.exists():
        return None
    return json.loads(path.read_text())


def write_baseline(path, reports, slack: float) -> dict:
    """Merge the measured budgets of checked entries into the baseline
    file (skipped and failed entries keep their previous budgets)."""
    path = Path(path)
    base = load_baseline(path) or {}
    entries = dict(base.get("entries", {}))
    for rep in reports:
        if rep.metrics:
            entries[rep.name] = {k: rep.metrics[k] for k in
                                 ("copy_transpose_bytes", "peak_live_bytes")}
    out = {"slack": slack, "entries": {k: entries[k]
                                       for k in sorted(entries)}}
    path.write_text(json.dumps(out, indent=2) + "\n")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.ircheck",
        description="captured-step checks over registered entry points "
                    "(peak live bytes, float64 promotion, host syncs, "
                    "in-place updates, collectives against the mesh, copy "
                    "bytes); exits nonzero on findings")
    ap.add_argument("--entry", action="append", default=None,
                    help="check only this entry point (repeatable)")
    ap.add_argument("--baseline", default=str(BASELINE),
                    help="budget file (default: ircheck_baseline.json "
                         "beside this module)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record measured metrics as the new budgets "
                         "instead of comparing against them")
    ap.add_argument("--slack", type=float, default=None,
                    help="relative budget tolerance (default: the "
                         f"baseline file's, else {DEFAULT_SLACK})")
    ap.add_argument("--device", default="cpu",
                    help="device of the entries' tensors (default: cpu)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="findings as text lines (default) or one JSON "
                         "report for CI artifacts")
    ap.add_argument("--list", action="store_true",
                    help="print the registered entry points and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name in known_entrypoints():
            print(name)
        return 0

    baseline = None if args.write_baseline else load_baseline(args.baseline)
    if baseline is None and not args.write_baseline:
        print(f"warning: no baseline at {args.baseline}: budget passes "
              "disabled (run --write-baseline to create it)",
              file=sys.stderr)
    try:
        reports = check_entrypoints(args.entry, baseline=baseline,
                                    slack=args.slack, device=args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        slack = args.slack if args.slack is not None else \
            float((load_baseline(args.baseline) or {}).get(
                "slack", DEFAULT_SLACK))
        write_baseline(args.baseline, reports, slack)
        print(f"wrote {args.baseline}", file=sys.stderr)

    findings = [f for r in reports for f in r.findings]
    if args.format == "json":
        print(json.dumps({"tool": "repro_torch.analysis.ircheck",
                          "n_findings": len(findings),
                          "entries": [r.as_dict() for r in reports]},
                         indent=2))
    else:
        for f in findings:
            print(f)
        for r in reports:
            extra = f" ({r.note})" if r.note else ""
            metrics = ", ".join(f"{k}={v:,}"
                                for k, v in sorted(r.metrics.items()))
            print(f"ircheck: {r.name:28s} {r.status:9s} "
                  f"{metrics}{extra}", file=sys.stderr)
    n_skip = sum(r.status == "skipped" for r in reports)
    print(f"ircheck: {len(findings)} finding(s) across {len(reports)} "
          f"entry point(s), {n_skip} skipped", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
