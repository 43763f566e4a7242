"""Wrappers of the message-free halo exchange, and its dispatcher.

``exchange_planes_1d`` is HPCG's message-free exchange.  For CPU tensors it
is exactly ``comm.message_free.exchange_planes_1d`` (the shared-window
emulation, what the JAX package runs on every backend but its own chip).
For CUDA tensors it is the CUDA kernel of ``csrc/halo_exchange.cu``, which
writes each rank's boundary planes straight into its neighbours' receive
windows under a two-phase handshake (what the JAX dispatcher does on the TPU).
The exchanged planes are copies either way, so the two give bit-identical
results.  There is no fallback: a CUDA tensor launches the kernel or
raises.

``ring_halo_exchange.launches`` counts the kernel's launches and
``ring_halo_exchange.route_launches`` each route's (plain integers; callers
may reset them).  The checked exchange is the custom op
``repro_torch::ring_halo_exchange``, so a captured step
(``core.graph.capture``) holds the kernel as one node; a captured call
launches and counts nothing.  The route, the unit width and the chunking are chosen
here before the launch, by the pure functions :func:`route_for`,
:func:`vector_ok` and :func:`chunk_count`.
"""
from __future__ import annotations

import math

import torch

from ...comm import counters, message_free
from .. import _plan
from . import halo_exchange as _cuda
from .ref import ring_exchange_collective, ring_halo_exchange_ref

_FLOATS = (torch.float32, torch.float64)
#: Threads per CTA in ``csrc/halo_exchange.cu``: a CTA moves at least one
#: unit per thread of each strip.
THREADS = 256
#: Largest ring of the ``"cluster"`` route: a portable cluster holds 8 CTAs.
CLUSTER_MAX = 8
ROUTES = ("cluster", "flags")

#: SM count and the flags route's co-resident CTA limit per device index
#: (the latter per (index, dtype, vec)); handshake flags per (device
#: index, stream, n, chunks) as ``[flags, epoch]``.  Launches on one stream
#: run in order, so one flag buffer per stream is never shared by two
#: launches at once.
_SMS: dict = {}
_MAX_CTAS: dict = {}
_FLAGS: dict = {}
#: 8-byte flags per 128-byte line: each flag has a line of its own.
_FLAG_STRIDE = 16


def route_for(n: int) -> str:
    """The handshake route for a ring of ``n`` ranks: one cluster of ``n``
    CTAs per chunk up to :data:`CLUSTER_MAX`, global flags beyond."""
    return "cluster" if n <= CLUSTER_MAX else "flags"


def vector_ok(p: int, itemsize: int, strides, addresses) -> bool:
    """Whether the exchange can move 16-byte units: the strip length (so
    every window row), every rank stride (elements) and every base address
    are 16-byte multiples."""
    return (p * itemsize % 16 == 0
            and all(s * itemsize % 16 == 0 for s in strides)
            and all(a % 16 == 0 for a in addresses))


def chunk_count(n: int, units: int, sms: int, max_ctas: int | None = None
                ) -> int:
    """CTAs per rank for a strip of ``units`` units: at most one per
    :data:`THREADS` units, and ``n x chunks`` within one wave of ``sms``
    SMs (at least one chunk).  ``max_ctas`` (the flags route) caps the grid
    at the CTAs the card holds resident at once."""
    chunks = max(1, min(math.ceil(units / THREADS), sms // n))
    if max_ctas is not None:
        if max_ctas < n:
            raise RuntimeError(f"ring_halo_exchange: {n} ranks need {n} "
                               f"CTAs resident at once; the card holds "
                               f"{max_ctas}")
        chunks = min(chunks, max_ctas // n)
    return chunks


def plan(n: int, units: int, route: str, sms: int,
         max_ctas: int | None = None) -> _plan.LaunchPlan:
    """The launch ``halo_exchange_plan_*`` computes for ``n`` ranks of
    ``units`` units a strip on ``route``, with :func:`chunk_count`'s chunks
    for ``sms`` SMs (and, on the flags route, ``max_ctas`` co-resident
    CTAs, which the card reports): ``n x chunks`` CTAs of :data:`THREADS`
    on grid x, one cluster of ``n`` per chunk or one cooperative grid."""
    chunks = chunk_count(n, units, sms,
                         max_ctas if route == "flags" else None)
    kernel = {"cluster": "halo_cluster_kernel",
              "flags": "halo_flags_kernel"}[route]
    static = (("mbarriers", 16),) if route == "cluster" else ()
    return _plan.LaunchPlan(
        kernel, _plan.dim3(n * chunks), _plan.dim3(THREADS),
        cluster=_plan.dim3(n if route == "cluster" else 1),
        cooperative=route == "flags",
        static_smem=sum(b for _, b in static),
        buffers=tuple((name, b, "static") for name, b in static))


def case_max_ctas(case: dict) -> int:
    """Co-resident CTAs of an analysis case: an H100's 132 SMs x 8 CTAs of
    256 threads unless the case says."""
    return case.get("max_ctas", case.get("sms", 132) * 2048 // THREADS)


def case_units(case: dict) -> int:
    """Units a strip of an analysis case moves: 16-byte ones where the
    plane is a 16-byte multiple (contiguous blocks, aligned), else
    elements."""
    p = math.prod(case["plane"])
    size = 8 if case["dtype"] == "float64" else 4
    return p * size // 16 if p * size % 16 == 0 else p


def case_plan(case: dict) -> _plan.LaunchPlan:
    """The plan of an analysis case (``analysis.kernelcheck``): ``n``
    ranks, one ``plane`` a strip, ``dtype``, an optional ``route``."""
    return plan(case["n"], case_units(case),
                case.get("route") or route_for(case["n"]),
                case.get("sms", 132), case_max_ctas(case))


def _case_tiles(case: dict, p: _plan.LaunchPlan, cta) -> dict:
    """CTA x is chunk c of rank r (``r = x % n`` on the cluster route,
    where a cluster's rank is its CTA rank, ``r = x / chunks`` on the
    flags route); it writes its chunk of the left neighbour's
    ``from_next`` and the right neighbour's ``from_prev``."""
    n, units = case["n"], case_units(case)
    chunks = p.grid[0] // n
    if p.cluster[0] > 1 or not p.cooperative:
        c, r = divmod(cta[0], n)
    else:
        r, c = divmod(cta[0], chunks)
    size = -(-units // chunks)
    span = (c * size, min(c * size + size, units))
    left, right = (r - 1) % n, (r + 1) % n
    return {"recv_hi": [((left, left + 1), span)],
            "recv_lo": [((right, right + 1), span)]}


def _make_dataflow():
    from ...analysis.dataflow import DataflowContract
    return DataflowContract(
        ("parallel",) * 3, case_plan,
        lambda c: {name: (c["n"], case_units(c))
                   for name in ("recv_lo", "recv_hi")}, _case_tiles)


DATAFLOW = _make_dataflow()


def _rank_strip_contiguous(t: torch.Tensor) -> bool:
    return t[0].is_contiguous() if t.shape[0] else True


def _sms(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _max_ctas(dev: torch.device, dtype, vec: bool) -> int:
    key = (dev.index, dtype, vec)
    if key not in _MAX_CTAS:
        _MAX_CTAS[key] = _cuda.max_ctas(dtype, vec)
    return _MAX_CTAS[key]


def ring_halo_exchange(strip_lo: torch.Tensor, strip_hi: torch.Tensor,
                       route: str | None = None):
    """Message-free ring exchange over stacked ranks.

    ``strip_lo`` / ``strip_hi``: ``(n, ...)`` float32/float64, each rank's
    low and high boundary strip (a rank's strip contiguous, any stride
    between ranks, so ``blocks[:, 0]`` is read in place).  Returns
    (from_prev, from_next), contiguous ``(n, ...)``: ``from_prev[r] =
    strip_hi[r - 1]``, ``from_next[r] = strip_lo[r + 1]`` on a ring.
    ``route`` picks the kernel's handshake (``"cluster"`` for n <=
    :data:`CLUSTER_MAX`, or ``"flags"``); by default :func:`route_for`.
    """
    if strip_lo.shape != strip_hi.shape or strip_lo.dtype != strip_hi.dtype \
            or strip_lo.device != strip_hi.device:
        raise ValueError("strip_lo and strip_hi must share shape, dtype and "
                         f"device; got {tuple(strip_lo.shape)} "
                         f"{strip_lo.dtype} {strip_lo.device} and "
                         f"{tuple(strip_hi.shape)} {strip_hi.dtype} "
                         f"{strip_hi.device}")
    if strip_lo.ndim < 1:
        raise ValueError("strips need a leading rank axis")
    n = strip_lo.shape[0]
    route = route_for(n) if route is None else route
    if route not in ROUTES or (route == "cluster" and n > CLUSTER_MAX):
        raise ValueError(f"no route {route!r} for {n} ranks: \"cluster\" "
                         f"takes up to {CLUSTER_MAX}, \"flags\" any")
    dev = strip_lo.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if dev.type == "cuda":
        if strip_lo.dtype not in _FLOATS:
            raise ValueError(f"ring_halo_exchange takes float32/float64, got "
                             f"{strip_lo.dtype}")
        if not (_rank_strip_contiguous(strip_lo)
                and _rank_strip_contiguous(strip_hi)):
            raise ValueError("each rank's strip must be contiguous")
    return ring_halo_exchange_op(strip_lo, strip_hi, route)


@torch.library.custom_op("repro_torch::ring_halo_exchange", mutates_args=())
def ring_halo_exchange_op(strip_lo: torch.Tensor, strip_hi: torch.Tensor,
                          route: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The checked exchange as one op: the plain version on the CPU, the
    kernel on the card.  A capture records it as one node (its fake
    version gives the shapes only, and launches and counts nothing)."""
    dev = strip_lo.device
    if dev.type == "cpu":
        return ring_halo_exchange_ref(strip_lo, strip_hi)
    n = strip_lo.shape[0]
    recv_lo = torch.empty(strip_lo.shape, dtype=strip_lo.dtype, device=dev)
    recv_hi = torch.empty_like(recv_lo)
    p = recv_lo[0].numel() if n else 0
    if n == 0 or p == 0:
        return recv_lo, recv_hi
    size = strip_lo.element_size()
    vec = vector_ok(p, size, (strip_lo.stride(0), strip_hi.stride(0)),
                    (strip_lo.data_ptr(), strip_hi.data_ptr()))
    units = p * size // 16 if vec else p
    with torch.cuda.device(dev):
        flags, epoch = None, 0
        if route == "cluster":
            chunks = chunk_count(n, units, _sms(dev))
        else:
            chunks = chunk_count(n, units, _sms(dev),
                                 _max_ctas(dev, strip_lo.dtype, vec))
            stream = torch.cuda.current_stream(dev).cuda_stream
            key = (dev.index, stream, n, chunks)
            if key not in _FLAGS:
                _FLAGS[key] = [torch.zeros(2 * n * chunks * _FLAG_STRIDE,
                                           dtype=torch.int64, device=dev), 0]
            state = _FLAGS[key]
            state[1] += 1
            flags, epoch = state
        _cuda.launch(strip_lo, strip_hi, recv_lo, recv_hi, route, vec,
                     chunks, flags, epoch)
    ring_halo_exchange.launches += 1
    ring_halo_exchange.route_launches[route] += 1
    return recv_lo, recv_hi


@ring_halo_exchange_op.register_fake
def _(strip_lo, strip_hi, route):
    return strip_lo.new_empty(strip_lo.shape), strip_lo.new_empty(
        strip_lo.shape)


ring_halo_exchange.launches = 0
ring_halo_exchange.route_launches = {r: 0 for r in ROUTES}


def exchange_planes_1d(blocks: torch.Tensor):
    """(below, above) boundary planes from the ring neighbours, each
    ``(n, 1, ...)`` for ``blocks`` of ``(n, nz, ...)``: the drop-in
    message-free counterpart of ``comm.message_based.exchange_planes_1d``.
    Counted in ``comm.counters`` once: here on the card, by
    ``comm.message_free`` on the CPU.
    """
    if blocks.device.type == "cpu":
        return message_free.exchange_planes_1d(blocks)
    from_prev, from_next = ring_halo_exchange(blocks[:, 0], blocks[:, -1])
    planes = from_prev[:, None], from_next[:, None]
    counters.count("planes_1d", "message_free", planes)
    return planes


def exchange_planes_1d_oracle(blocks: torch.Tensor):
    """ppermute-style reference with the same signature (for validation)."""
    lo, hi = blocks[:, :1], blocks[:, -1:]
    from_prev, from_next = ring_exchange_collective((hi, lo))
    # from_prev carries the left neighbour's hi plane; from_next the right
    # neighbour's lo plane.
    return from_prev[0], from_next[1]
