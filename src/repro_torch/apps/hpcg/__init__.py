"""HPCG (paper Sec. V-D): the memsim access-stream spec, the
model-vs-reference validation, and the distributed PCG with both
communication backends (``torch_impl``)."""
from .spec import HpcgConfig, build_spec, halo_calls
from .validation import HpcgRow, overhead_breakdown, run_validation

__all__ = ["HpcgConfig", "build_spec", "halo_calls", "run_validation",
           "overhead_breakdown", "HpcgRow"]
