"""Counters of the halo exchanges, as ``parallel.transport`` counts its
collectives.

``exchanges`` counts the calls and ``exchange_bytes`` the bytes of the
strips or planes a call returns, summed over ranks, each per ``(call,
backend)``: ``call`` is ``"halos_2d"`` or ``"planes_1d"``, ``backend``
``"message_based"`` or ``"message_free"``.  Each exchange counts itself
where it returns: ``comm.message_based``, ``comm.message_free`` and the
CUDA branch of ``kernels.halo_exchange.ops.exchange_planes_1d`` (its CPU
branch is ``comm.message_free``'s, which counts).  Counting is always on;
a call on fake tensors (a capture, ``core.graph``) moves nothing and
counts nothing.
"""
from __future__ import annotations

from collections import Counter

from torch._subclasses.fake_tensor import FakeTensor

#: Calls per (call, backend) in this process.
exchanges: Counter = Counter()
#: Bytes returned per (call, backend) in this process, over all ranks.
exchange_bytes: Counter = Counter()


def count(call: str, backend: str, received) -> None:
    """Count one exchange that returned the tensors ``received``."""
    if any(isinstance(t, FakeTensor) for t in received):
        return
    key = (call, backend)
    exchanges[key] += 1
    exchange_bytes[key] += sum(t.numel() * t.element_size()
                               for t in received)


def snapshot() -> tuple:
    """The counters as they stand, for :func:`since`."""
    return Counter(exchanges), Counter(exchange_bytes)


def since(before: tuple) -> dict:
    """``{(call, backend): (calls, bytes)}`` counted since ``before``
    (:func:`snapshot`)."""
    calls, nbytes = exchanges - before[0], exchange_bytes - before[1]
    return {key: (calls[key], nbytes[key]) for key in calls | nbytes}
