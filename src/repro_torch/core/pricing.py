"""``price()`` — the front door of the pricing engine.

The counterpart of ``repro.core.pricing`` for the subjects this package
prices so far:

    price(bundle, grid)                          # TraceBundle
    price(cb, grid, plan=ExecPlan("torch"))      # CompiledBundle
    price(cb, grid, plan="numpy")                # the host

``scenarios`` is any :class:`~repro_torch.core.sweep.ScenarioSet` —
``ParamGrid.product`` / ``sample`` / ``zip`` / ``concat`` or a plain
iterable of ``ModelParams`` — and ``plan`` an
:class:`~repro_torch.core.execplan.ExecPlan` or its string form.  The
default plan is the fused CUDA kernel on ``"cuda"``; it raises when no CUDA
device is present.
"""
from __future__ import annotations

from .execplan import ExecPlan
from .params import ModelParams
from .sweep import (CompiledBundle, ParamGrid, SweepResult, _sweep_plan,
                    compile_bundle)
from .traces import TraceBundle


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


def price(subject, scenarios, plan: ExecPlan | str | None = None, *,
          mpi_transfer=None, free_transfer=None) -> SweepResult:
    """Price ``subject`` (a ``TraceBundle`` or ``CompiledBundle``) under
    every scenario of ``scenarios``, executed under ``plan``.

    ``mpi_transfer`` / ``free_transfer`` are explicit transfer-model
    overrides (see ``sweep_run``).  Other subjects of the reference's
    ``price`` raise ``TypeError``: sequences and mappings of bundles come
    with the multi-bundle sweep, HLO text, compiled artifacts and serve
    engines with the advisor.
    """
    if isinstance(plan, str):
        plan = ExecPlan.parse(plan)
    if isinstance(subject, TraceBundle):
        subject = compile_bundle(subject)
    if not isinstance(subject, CompiledBundle):
        if isinstance(subject, str) or hasattr(subject, "as_text") \
                or hasattr(subject, "compiled_steps"):
            later = ("HLO text, compiled artifacts and serve engines are "
                     "priced through the advisor, which is not ported yet")
        elif hasattr(subject, "__iter__"):
            later = ("sequences and mappings of bundles are priced by the "
                     "multi-bundle sweep, which is not ported yet")
        else:
            later = "expected a TraceBundle or CompiledBundle"
        raise TypeError(f"cannot price a {type(subject).__name__}: {later}")
    return _sweep_plan(subject, _as_scenarios(scenarios), plan,
                       mpi_transfer, free_transfer)
