"""repro_torch.core — the paper's performance model for message-free
(CXL.mem-style) vs message-based (MPI-style) communication, in PyTorch.

The counterpart of ``repro.core`` for the pricing path:

    price(subject, scenarios, plan=ExecPlan(...))

where ``subject`` is a :class:`TraceBundle` / :class:`CompiledBundle` or a
sequence / ``{name: bundle}`` mapping of them (a :class:`MultiSweepResult`),
``scenarios`` any :class:`ScenarioSet` (a :class:`ParamGrid`, or an
:class:`ArraySet` from :func:`adaptive_sample`) and :class:`ExecPlan`
carries the execution config (backend, scenario chunking, device,
precision, and the streaming ``"distributed"`` backend's shards, top-k and
refinement rounds).  ``predict_run`` is the scalar per-call path.
"""
from .params import ModelParams, PAPER_PRESETS, Thresholds
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

__all__ = [
    "ModelParams", "Thresholds", "PAPER_PRESETS",
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
]
