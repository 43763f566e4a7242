"""repro_torch.core — the paper's performance model for message-free
(CXL.mem-style) vs message-based (MPI-style) communication, in PyTorch.

The counterpart of ``repro.core``: the pricing path, and the advisor that
applies it to compiled programs:

    price(subject, scenarios, plan=ExecPlan(...))

where ``subject`` is a :class:`TraceBundle` / :class:`CompiledBundle`, HLO
text, a captured PyTorch step (``graph.capture``), a compiled artifact, or
a sequence / ``{name: step}`` mapping of them or a serve engine (a
:class:`MultiSweepResult`),
``scenarios`` any :class:`ScenarioSet` (a :class:`ParamGrid`, or an
:class:`ArraySet` from :func:`adaptive_sample`) and :class:`ExecPlan`
carries the execution config (backend, scenario chunking, device,
precision, and the streaming ``"distributed"`` backend's shards, top-k and
refinement rounds).  ``predict_run`` is the scalar per-call path.
"""
from .params import (H100, H100Spec, ModelParams, PAPER_PRESETS, TPU_V5E,
                     Thresholds, TpuSpec)
from .traces import (CallSite, CommRecord, CounterSet, DataSource,
                     LoadSample, TraceBundle)
from .characterization import (ALL_CATEGORIES, FIRST_LOAD_CATEGORIES,
                               Category, Characterization, Metrics,
                               normalize, quadratic_weight, raw_weights)
from .transfer import (HockneyTransfer, LogGPTransfer, MessageFreeTransfer,
                       SiteTraffic, TRANSFER_MODELS)
from .access import access_cxl_ns, access_mpi_ns, prefetch_hit_fraction
from .predictor import CallPrediction, RunPrediction, predict_call, predict_run
from .execplan import (ExecPlan, is_streaming, known_backends,
                       register_backend, resolve_backend)
from .sweep import (CATEGORICAL_AXES, CompiledBundle, MultiSweepResult,
                    ParamGrid, ScenarioSet, SweepAggregates, SweepResult,
                    TopKSweepResult, compile_bundle,
                    compiled_bundle_from_arrays, concat_bundles, sweep_run,
                    sweep_run_many)
from .adaptive import ArraySet, adaptive_sample, as_array_set
from .pricing import price
from .sweep_kernel import (MATRIX_FIELDS, SPEEDUP_HIST_EDGES, price_grid,
                           price_grid_fused, price_grid_numpy,
                           price_grid_torch)
from . import analytic, graph, hlo
from .advisor import AdvisorReport, CommAdvisor, synthesize_bundle
from .graph import CapturedStep, capture

__all__ = [
    "ModelParams", "Thresholds", "TpuSpec", "TPU_V5E", "H100Spec", "H100",
    "PAPER_PRESETS",
    "LoadSample", "CommRecord", "CounterSet", "CallSite", "TraceBundle",
    "DataSource", "Category", "Characterization", "Metrics",
    "quadratic_weight", "raw_weights", "normalize",
    "FIRST_LOAD_CATEGORIES", "ALL_CATEGORIES",
    "HockneyTransfer", "MessageFreeTransfer", "LogGPTransfer",
    "SiteTraffic", "TRANSFER_MODELS",
    "access_mpi_ns", "access_cxl_ns", "prefetch_hit_fraction",
    "CallPrediction", "RunPrediction", "predict_call", "predict_run",
    "ExecPlan", "is_streaming", "known_backends", "register_backend",
    "resolve_backend",
    "price", "ScenarioSet", "CATEGORICAL_AXES", "CompiledBundle",
    "MultiSweepResult", "ParamGrid", "SweepResult", "SweepAggregates",
    "TopKSweepResult", "compile_bundle", "compiled_bundle_from_arrays",
    "concat_bundles", "sweep_run", "sweep_run_many",
    "ArraySet", "adaptive_sample", "as_array_set",
    "MATRIX_FIELDS", "SPEEDUP_HIST_EDGES", "price_grid", "price_grid_numpy",
    "price_grid_torch", "price_grid_fused",
    "analytic", "graph", "hlo", "AdvisorReport", "CommAdvisor",
    "synthesize_bundle", "CapturedStep", "capture",
]
