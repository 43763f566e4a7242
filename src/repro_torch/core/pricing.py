"""``price()`` — the front door of the pricing engine.

The counterpart of ``repro.core.pricing`` for the subjects this package
prices so far:

    price(bundle, grid)                          # TraceBundle
    price(cb, grid, plan=ExecPlan("torch"))      # CompiledBundle
    price(cb, grid, plan="numpy")                # the host
    price([bundle_a, bundle_b], grid)            # sequence of bundles
    price({"prefill": cb1, "decode": cb2}, grid) # mapping -> names
    price(cb, adaptive_sample(...),              # streaming top-k
          plan="distributed:topk=64,refine=2")

``scenarios`` is any :class:`~repro_torch.core.sweep.ScenarioSet` —
``ParamGrid.product`` / ``sample`` / ``zip`` / ``concat``, an
:class:`~repro_torch.core.adaptive.ArraySet`, or a plain iterable of
``ModelParams`` — and ``plan`` an :class:`~repro_torch.core.execplan.
ExecPlan` or its string form.  The default plan is the fused CUDA kernel on
``"cuda"``; it raises when no CUDA device is present.
"""
from __future__ import annotations

from collections.abc import Mapping

from .execplan import ExecPlan
from .params import ModelParams
from .sweep import (CompiledBundle, MultiSweepResult, ParamGrid, SweepResult,
                    _sweep_plan, _sweep_plan_many, compile_bundle)
from .traces import TraceBundle

_ADVISOR = ("HLO text, compiled artifacts and serve engines are priced "
            "through the advisor, which is not ported yet")


def _lower(obj) -> TraceBundle | CompiledBundle:
    """One pricing subject as a (compiled) bundle; other subjects of the
    reference's ``price`` raise ``TypeError``."""
    if isinstance(obj, (TraceBundle, CompiledBundle)):
        return obj
    if isinstance(obj, str) or hasattr(obj, "as_text") \
            or hasattr(obj, "compiled_steps"):
        raise TypeError(f"cannot price a {type(obj).__name__}: {_ADVISOR}")
    raise TypeError(
        f"cannot price a {type(obj).__name__}: expected a TraceBundle, "
        "CompiledBundle, or a sequence/mapping of those")


def _as_scenarios(scenarios):
    """Accept any ScenarioSet; a plain iterable of ``ModelParams`` is
    wrapped via ``ParamGrid.from_params``."""
    if hasattr(scenarios, "view") and hasattr(scenarios, "labels"):
        return scenarios
    if isinstance(scenarios, ModelParams):
        return ParamGrid.from_params([scenarios])
    try:
        return ParamGrid.from_params(scenarios)
    except TypeError:
        raise TypeError(
            f"scenarios must be a ScenarioSet (e.g. a ParamGrid) or an "
            f"iterable of ModelParams, got {type(scenarios).__name__}"
        ) from None


def price(subject, scenarios, plan: ExecPlan | str | None = None,
          names=None, *, mpi_transfer=None,
          free_transfer=None) -> SweepResult | MultiSweepResult:
    """Price ``subject`` under every scenario of ``scenarios``, executed
    under ``plan``.

    A ``TraceBundle`` or ``CompiledBundle`` gives a ``SweepResult``; a
    sequence or mapping of them gives a ``MultiSweepResult`` (one batched
    evaluation of a super-bundle), labelled by ``names`` (a mapping's keys
    by default; for a mapping ``names`` selects and orders the keys).  A
    STREAMING plan (``"distributed:..."``) returns its
    :class:`~repro_torch.core.sweep.TopKSweepResult` and prices single
    subjects only.  ``mpi_transfer`` / ``free_transfer`` are explicit
    transfer-model overrides (see ``sweep_run``).  HLO text, compiled
    artifacts and serve engines raise ``TypeError``: they come with the
    advisor.
    """
    if isinstance(plan, str):
        plan = ExecPlan.parse(plan)
    grid = _as_scenarios(scenarios)
    if isinstance(subject, (TraceBundle, CompiledBundle)):
        if names is not None:
            raise ValueError("names= labels multi-subject pricing; this "
                             "subject prices to a single SweepResult")
        cb = subject if isinstance(subject, CompiledBundle) \
            else compile_bundle(subject)
        return _sweep_plan(cb, grid, plan, mpi_transfer, free_transfer)

    if isinstance(subject, str) or hasattr(subject, "as_text") \
            or hasattr(subject, "compiled_steps") \
            or not hasattr(subject, "__iter__"):
        return _lower(subject)                       # raises the TypeError
    if isinstance(subject, Mapping):
        keys = tuple(names) if names is not None else tuple(subject)
        items = [subject[k] for k in keys]
        names = keys
    else:
        items = list(subject)
    bundles = [_lower(it) for it in items]
    return _sweep_plan_many(bundles, grid, plan, names,
                            mpi_transfer, free_transfer)
