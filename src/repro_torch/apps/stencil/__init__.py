"""2D heat-transfer stencil (paper Sec. V-C): the memsim access-stream spec.

The validation pipeline (``repro.apps.stencil.validation``) is not ported
yet; only the spec that ``memsim.collect`` turns into a bundle is.
"""
from .spec import HALO_CALLS, NS_CALLS, WE_CALLS, StencilConfig, build_spec

__all__ = ["StencilConfig", "build_spec", "HALO_CALLS", "NS_CALLS",
           "WE_CALLS"]
