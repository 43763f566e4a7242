"""``price()`` — the front door of the pricing engine.

The counterpart of ``repro.core.pricing``:

    price(bundle, grid)                          # TraceBundle
    price(cb, grid, plan=ExecPlan("torch"))      # CompiledBundle
    price(cb, grid, plan="numpy")                # the host
    price(hlo_text, grid)                        # HLO text (advisor path)
    price(capture(step, x), grid)                # a captured PyTorch step
    price(compiled, grid)                        # .as_text() + .cost_analysis()
    price([bundle_a, bundle_b], grid)            # sequence of subjects
    price({"prefill@32": s1, "decode": s2},      # mapping -> names
          grid)
    price(engine, grid)                          # serve engine (its
                                                 #   compiled_steps())
    price(cb, adaptive_sample(...),              # streaming top-k
          plan="distributed:topk=64,refine=2")

``scenarios`` is any :class:`~repro_torch.core.sweep.ScenarioSet` —
``ParamGrid.product`` / ``sample`` / ``zip`` / ``concat``, an
:class:`~repro_torch.core.adaptive.ArraySet`, or a plain iterable of
``ModelParams`` — and ``plan`` an :class:`~repro_torch.core.execplan.
ExecPlan` or its string form.  The default plan is the fused CUDA kernel on
``"cuda"``; it raises when no CUDA device is present.

Subjects that are not trace bundles are lowered through a ``CommAdvisor``
(``advisor=`` overrides the default one, whose params and spec are the JAX
package's defaults): ``advisor.synthesize_bundle`` turns HLO text, captured
steps (``core.graph.CapturedStep``) and compiled artifacts into the model's
input bundle.
"""
from __future__ import annotations

from collections.abc import Mapping

from .execplan import ExecPlan
from .params import ModelParams
from .sweep import (CompiledBundle, MultiSweepResult, ParamGrid, SweepResult,
                    _sweep_plan, _sweep_plan_many, compile_bundle)
from .traces import TraceBundle


def _is_program(obj) -> bool:
    """HLO text, a captured step (``.collectives()`` and ``.cost()``), or a
    compiled artifact (``.as_text()``)."""
    return isinstance(obj, str) or hasattr(obj, "as_text") \
        or (hasattr(obj, "collectives") and hasattr(obj, "cost"))


def _lower(obj, get_advisor) -> TraceBundle | CompiledBundle:
    """Lower ONE pricing subject to a (compiled) bundle."""
    if isinstance(obj, (TraceBundle, CompiledBundle)):
        return obj
    if _is_program(obj):
        from .advisor import lower_subject
        adv = get_advisor()
        return lower_subject(obj, adv.params, adv.spec)
    raise TypeError(
        f"cannot price a {type(obj).__name__}: expected a TraceBundle, "
        "CompiledBundle, HLO text, a captured step with .collectives() and "
        ".cost(), a compiled artifact with .as_text(), a sequence/mapping "
        "of those, or a serve engine with .compiled_steps()")


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
          names=None, *, mpi_transfer=None, free_transfer=None,
          advisor=None) -> SweepResult | MultiSweepResult:
    """Price ``subject`` under every scenario of ``scenarios``, executed
    under ``plan``.

    A single subject (a ``TraceBundle``, ``CompiledBundle``, HLO text, a
    captured step or a compiled artifact) gives a ``SweepResult``; a
    sequence or mapping of them, or a serve engine (priced through its
    ``compiled_steps()``), gives a ``MultiSweepResult`` (one batched
    evaluation of a super-bundle), labelled by ``names`` (a mapping's keys
    by default; for a mapping ``names`` selects and orders the keys).  A
    STREAMING plan (``"distributed:..."``) returns its
    :class:`~repro_torch.core.sweep.TopKSweepResult` and prices single
    subjects only.  ``mpi_transfer`` / ``free_transfer`` are explicit
    transfer-model overrides (see ``sweep_run``); ``advisor`` is the
    ``CommAdvisor`` whose params and spec lower program subjects
    (``CommAdvisor()`` by default).
    """
    if isinstance(plan, str):
        plan = ExecPlan.parse(plan)
    grid = _as_scenarios(scenarios)

    _cache = [advisor]

    def get_advisor():
        if _cache[0] is None:
            from .advisor import CommAdvisor
            _cache[0] = CommAdvisor()
        return _cache[0]

    if isinstance(subject, (TraceBundle, CompiledBundle)) \
            or _is_program(subject):
        if names is not None:
            raise ValueError("names= labels multi-subject pricing; this "
                             "subject prices to a single SweepResult")
        cb = _lower(subject, get_advisor)
        if isinstance(cb, TraceBundle):
            cb = compile_bundle(cb)
        return _sweep_plan(cb, grid, plan, mpi_transfer, free_transfer)

    if hasattr(subject, "compiled_steps"):           # serve engine
        subject = subject.compiled_steps()
    if isinstance(subject, Mapping):
        keys = tuple(names) if names is not None else tuple(subject)
        items = [subject[k] for k in keys]
        names = keys
    elif hasattr(subject, "__iter__"):
        items = list(subject)
    else:
        return _lower(subject, get_advisor)          # raises the TypeError
    bundles = [_lower(it, get_advisor) for it in items]
    return _sweep_plan_many(bundles, grid, plan, names,
                            mpi_transfer, free_transfer)
