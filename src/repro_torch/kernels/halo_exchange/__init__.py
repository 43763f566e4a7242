"""Message-free ring halo exchange (CUDA, sm_90a).

``ops`` holds the wrapper and HPCG's dispatcher (CPU tensors to the
shared-window emulation or the plain version in ``ref``, CUDA tensors to the
kernel on the route ``ops.route_for`` picks), ``halo_exchange`` builds and
launches ``csrc/halo_exchange.cu``.
"""
from .ops import (CLUSTER_MAX, ROUTES, exchange_planes_1d,
                  exchange_planes_1d_oracle, ring_halo_exchange, route_for)
from .ref import (ring_exchange_collective, ring_exchange_ref,
                  ring_halo_exchange_ref)

__all__ = ["CLUSTER_MAX", "ROUTES", "exchange_planes_1d",
           "exchange_planes_1d_oracle", "ring_halo_exchange", "route_for",
           "ring_exchange_ref", "ring_exchange_collective",
           "ring_halo_exchange_ref"]
