"""2D heat-transfer stencil (paper Sec. V-C): the memsim access-stream spec,
the model-vs-reference validation, and the distributed program with both
communication backends (``torch_impl``)."""
from .spec import HALO_CALLS, NS_CALLS, WE_CALLS, StencilConfig, build_spec
from .validation import (ValidationRow, multinode_prediction,
                         overhead_breakdown, run_validation)

__all__ = ["StencilConfig", "build_spec", "HALO_CALLS", "NS_CALLS",
           "WE_CALLS", "run_validation", "overhead_breakdown",
           "multinode_prediction", "ValidationRow"]
