"""CommAdvisor — the paper's per-call model applied to compiled programs.

The paper scores each *MPI receive call site*: Hockney transfer + post-
receive buffer loads (message-based) vs a 2-atomic handshake + direct
remote loads (message-free).  For a compiled program the call sites are its
collectives:

  message-based := the collective as compiled — ring transfer over the
                   chip-to-chip links, then the consumer streams the result
                   from LOCAL memory.
  message-free  := a handshake and a remote copy into a pooled window (the
                   halo-exchange kernel) — no bulk transfer; the consumer
                   streams the operand from REMOTE memory at CXL-class
                   latency.

Mapping choices (those of the JAX package's ``repro.core.advisor``):
  * transfer bytes  = ring wire bytes of the collective (receive direction);
  * the consumer's loads are synthesized as first-touch streaming samples at
    vector-unit granularity (a compiled collective's operand is touched
    exactly once);
  * whole-program characterization comes from the roofline terms of the
    same program (the PAPI-counters role).

The subjects are HLO text with its cost dict (the JAX package's compiled
programs, parsed by the port's own ``core.hlo``), a ``core.graph``
``CapturedStep``, or anything with ``.collectives()`` and ``.cost()``.
Each front end feeds one shared body, :func:`bundle_from_collectives`,
which does the JAX package's arithmetic.  The advisor's methods take
``plan=`` only, as the port's ``price`` does.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np

from .execplan import ExecPlan
from .hlo import (CollectiveOp, RooflineTerms, loop_corrected_cost,
                  parse_collectives)
from .params import TPU_V5E, ModelParams, TpuSpec
from .predictor import RunPrediction, predict_run
from .pricing import price
from .sweep import MultiSweepResult, ParamGrid, SweepResult
from .traces import (CommRecord, CounterSet, DataSource, LoadSample,
                     TraceBundle)


def _remote_read_bytes(op: CollectiveOp) -> float:
    """Bytes the consumer must load from remote memory in the message-free
    formulation (one execution)."""
    if op.kind == "all-reduce":
        return op.wire_bytes / 2.0          # read remote partials once
    return op.wire_bytes


def bundle_from_collectives(colls, flops: float, hbm_bytes: float,
                            params: ModelParams, spec: TpuSpec = TPU_V5E,
                            min_group: int = 2) -> TraceBundle:
    """The model's input bundle from a program's collectives and its
    (loop-corrected) flops and memory bytes: the shared body of every
    :func:`synthesize_bundle` source.  Collectives of a group smaller than
    ``min_group`` are not call sites; their bytes still count in
    ``meta["wire_bytes"]`` and the roofline."""
    wire = sum(op.total_wire_bytes for op in colls)
    terms = RooflineTerms(flops=flops, hbm_bytes=hbm_bytes, wire_bytes=wire,
                          spec=spec)
    wall_ns = max(terms.step_time_s, 1e-12) * 1e9

    granule = params.avg_load_bytes
    bundle = TraceBundle(sampling_period=1.0,
                         meta={"flops": flops, "hbm_bytes": hbm_bytes,
                               "wire_bytes": wire, "wall_ns": wall_ns})
    # PAPI-analog counters: a statically scheduled step streams its memory
    # traffic; vector loads all reach the backing memory.
    n_loads = hbm_bytes / granule
    bundle.counters = CounterSet(
        ld_ins=n_loads, l1_ldm=n_loads, l3_ldm=n_loads,
        tot_cyc=wall_ns * params.cpu_freq_ghz,
        imc_reads=hbm_bytes / 64.0,
        wall_time_ns=wall_ns)

    for i, op in enumerate(colls):
        if op.group_size < min_group:
            continue
        cid = f"{op.kind}@{op.computation}#{i}"
        site = bundle.call(cid)
        site.accesses_per_element = 1.0      # collective operands stream once
        site.loads_per_line = 1.0            # vector granule ~ cache line
        site.comms.append(CommRecord(
            call_id=cid, bytes=int(op.wire_bytes),
            count=max(1, int(round(op.multiplier)))))
        n_granules = _remote_read_bytes(op) * op.multiplier / granule
        if n_granules > 0:
            site.samples.append(LoadSample(
                call_id=cid, lat_ns=params.mem_lat_ns,
                source=DataSource.DRAM, weight=n_granules))
        site.meta = {"kind": op.kind, "group": op.group_size,
                     "multiplier": op.multiplier,
                     "result_bytes": op.result_bytes}
    return bundle


def _program(subject, cost: dict | None = None) -> tuple:
    """(collectives, flops, memory bytes) of one subject: HLO text (with
    ``cost``, the compiled artifact's cost analysis, as the fallback of
    ``loop_corrected_cost``), or anything with ``.collectives()`` and
    ``.cost()`` (a ``CapturedStep``)."""
    if isinstance(subject, str):
        flops, hbm = loop_corrected_cost(cost or {}, subject)
        return parse_collectives(subject), flops, hbm
    if hasattr(subject, "collectives") and hasattr(subject, "cost"):
        c = subject.cost()
        return (list(subject.collectives()), float(c.get("flops", 0.0)),
                float(c.get("bytes accessed", 0.0)))
    raise TypeError(f"cannot synthesize a bundle from a "
                    f"{type(subject).__name__}: expected HLO text or an "
                    "object with .collectives() and .cost()")


def synthesize_bundle(subject, cost: dict | None = None,
                      params: ModelParams | None = None,
                      spec: TpuSpec = TPU_V5E,
                      min_group: int = 2) -> TraceBundle:
    """Build the model's input bundle from a compiled program: HLO text
    plus its cost dict, a ``CapturedStep``, or anything with
    ``.collectives()`` and ``.cost()`` (``cost`` is for HLO text only)."""
    colls, flops, hbm = _program(subject, cost)
    return bundle_from_collectives(colls, flops, hbm,
                                   params or ModelParams.tpu_v5e_ici(), spec,
                                   min_group)


def normalize_cost_analysis(compiled) -> dict:
    """``compiled.cost_analysis()`` as a plain dict, possibly empty: the
    port's copy of ``repro.compat.normalize_cost_analysis``, the one place
    the raw call belongs (JAX returns a dict, a list of one dict per
    partition, or None; a raising backend gives ``{}`` and a warning)."""
    try:
        cost = compiled.cost_analysis()  # repro: noqa[compat-drift]
    except Exception as e:
        warnings.warn(f"cost_analysis() failed ({e!r}); proceeding with "
                      "empty cost data", RuntimeWarning)
        return {}
    if cost is None:
        return {}
    if isinstance(cost, (list, tuple)):
        if not cost:
            return {}
        cost = cost[0]
    return dict(cost)


def _text_and_cost(compiled) -> tuple:
    """(HLO text, cost dict) of a compiled artifact."""
    return compiled.as_text(), normalize_cost_analysis(compiled)


def lower_subject(obj, params: ModelParams, spec: TpuSpec) -> TraceBundle:
    """One program subject of ``price`` as a bundle: HLO text, an object
    with ``.collectives()`` and ``.cost()``, or a compiled artifact with
    ``.as_text()`` (and ``.cost_analysis()``)."""
    if isinstance(obj, str) or (hasattr(obj, "collectives")
                                and hasattr(obj, "cost")):
        return synthesize_bundle(obj, None, params, spec)
    if hasattr(obj, "as_text"):
        text, cost = _text_and_cost(obj)
        return synthesize_bundle(text, cost, params, spec)
    raise TypeError(f"cannot price a {type(obj).__name__}")


@dataclass
class AdvisorReport:
    run: RunPrediction
    terms: RooflineTerms
    collectives: list = field(default_factory=list)

    def summary_rows(self) -> list:
        rows = []
        for cid, c in sorted(self.run.calls.items(),
                             key=lambda kv: -kv[1].gain_ns):
            rows.append({
                "call": cid,
                "t_message_us": c.t_mpi_ns / 1e3,
                "t_free_us": c.t_cxl_ns / 1e3,
                "gain_us": c.gain_ns / 1e3,
                "speedup": c.speedup,
                "verdict": "message-free" if c.gain_ns > 0 else "message-based",
            })
        return rows

    @property
    def step_gain_us(self) -> float:
        return sum(max(0.0, c.gain_ns) for c in self.run.calls.values()) / 1e3


class CommAdvisor:
    """Scores every collective of a compiled program (the paper's questions
    1-3 at per-collective granularity).  The defaults are the JAX
    package's: ``ModelParams.tpu_v5e_ici()`` and ``TPU_V5E``."""

    def __init__(self, params: ModelParams | None = None,
                 spec: TpuSpec = TPU_V5E):
        self.params = params or ModelParams.tpu_v5e_ici()
        self.spec = spec

    def analyze_text(self, text, cost: dict | None = None) -> AdvisorReport:
        """The scalar per-call prediction of one program (HLO text, or a
        ``CapturedStep``) under this advisor's params."""
        colls, flops, hbm = _program(text, cost)
        bundle = bundle_from_collectives(colls, flops, hbm, self.params,
                                         self.spec)
        run = predict_run(bundle, self.params)
        terms = RooflineTerms(flops=flops, hbm_bytes=hbm,
                              wire_bytes=bundle.meta["wire_bytes"],
                              spec=self.spec)
        run.baseline_runtime_ns = bundle.meta["wall_ns"]
        return AdvisorReport(run=run, terms=terms, collectives=colls)

    def analyze_compiled(self, compiled) -> AdvisorReport:
        """:meth:`analyze_text` of a compiled artifact (``.as_text()`` and
        ``.cost_analysis()``) or a ``CapturedStep``."""
        if hasattr(compiled, "collectives") and hasattr(compiled, "cost"):
            return self.analyze_text(compiled)
        return self.analyze_text(*_text_and_cost(compiled))

    # ------------------------------------------------------------- sweeps
    def default_grid(self, n_lat: int = 8, n_atomic: int = 8) -> ParamGrid:
        """Latency-band grid around this advisor's params: remote-access
        latency x handshake latency at 0.5x..3x — the 2-3x band the CXL
        pooling evaluations report."""
        p = self.params
        return ParamGrid.product(
            p,
            cxl_lat_ns=[float(v) for v in
                        np.linspace(0.5 * p.cxl_lat_ns, 3.0 * p.cxl_lat_ns,
                                    n_lat)],
            cxl_atomic_lat_ns=[float(v) for v in
                               np.linspace(0.5 * p.cxl_atomic_lat_ns,
                                           3.0 * p.cxl_atomic_lat_ns,
                                           n_atomic)])

    def _grid(self, grid):
        return grid if grid is not None else self.default_grid()

    def sweep_text(self, text: str, grid: ParamGrid | None = None,
                   cost: dict | None = None,
                   plan: ExecPlan | str | None = None) -> SweepResult:
        """Score every collective of HLO text under a whole scenario grid
        in one pass: the bundle with THIS advisor's params, priced under
        ``plan``."""
        bundle = synthesize_bundle(text, cost, self.params, self.spec)
        return price(bundle, self._grid(grid), plan=plan)

    def sweep(self, compiled, grid: ParamGrid | None = None,
              plan: ExecPlan | str | None = None) -> SweepResult:
        """``price(compiled, grid)`` with this advisor's params (the
        batched analog of :meth:`analyze_compiled`)."""
        return price(compiled, self._grid(grid), plan=plan, advisor=self)

    # ------------------------------------------------- multi-step sweeps
    def sweep_text_many(self, texts, grid: ParamGrid | None = None,
                        costs=None, names=None,
                        plan: ExecPlan | str | None = None
                        ) -> MultiSweepResult:
        """Score the collectives of MANY HLO programs under one grid in a
        single batched evaluation (one super-bundle, one pricing pass).

        ``texts`` may be a ``{name: hlo_text}`` dict (an explicit ``names``
        selects and reorders entries) or a plain sequence; ``costs`` aligns
        with it — a sequence matches ``texts`` positionally, a dict is keyed
        by step name (``None`` entries mean no cost analysis)."""
        if isinstance(texts, dict):
            if names is None:
                names = tuple(texts)
            texts = [texts[n] for n in names]
        else:
            texts = list(texts)
        if costs is None:
            costs = [None] * len(texts)
        elif isinstance(costs, dict):
            if names is None:
                raise ValueError("costs given as a dict need named steps "
                                 "(a texts dict or an explicit names=)")
            costs = [costs.get(n) for n in names]
        bundles = [synthesize_bundle(t, c, self.params, self.spec)
                   for t, c in zip(texts, costs)]
        return price(bundles, self._grid(grid), plan=plan, names=names)

    def sweep_many(self, compiled_steps, grid: ParamGrid | None = None,
                   names=None, plan: ExecPlan | str | None = None
                   ) -> MultiSweepResult:
        """``price(compiled_steps, grid)`` with this advisor's params:
        ``compiled_steps`` is a ``{name: step}`` dict (a serving engine's
        prefill buckets and decode step) or a sequence of steps."""
        return price(compiled_steps, self._grid(grid), plan=plan,
                     names=names, advisor=self)

    def sweep_serve(self, engine, grid: ParamGrid | None = None,
                    plan: ExecPlan | str | None = None,
                    **compile_kwargs) -> MultiSweepResult:
        """Price a serving deployment's collectives under the grid in one
        batched call: the engine's steps (``engine.compiled_steps()``,
        captured once) priced together."""
        return price(engine.compiled_steps(**compile_kwargs),
                     self._grid(grid), plan=plan, advisor=self)
