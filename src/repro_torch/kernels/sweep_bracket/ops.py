"""Public wrappers of the sweep-bracket kernels.

Each wrapper keeps the reference's contract (``repro.kernels.sweep_bracket
.ops``): sample groups of any length, zero-``w`` padding, and an empty
scenario or segment axis returning zeros without a launch.  For CPU tensors
it runs the plain version in ``ref``; for CUDA tensors it launches the CUDA
kernel or raises — it never falls back.  ``<wrapper>.launches`` counts the
kernel launches (a plain integer; callers may reset it).

The kernels walk samples in CSR form.  :func:`csr_group` turns a packed
``(lat, w, seg)`` group into that form once — offsets per segment, a
stable permutation only where the ids are not already non-decreasing, and
the samples in site order packed as ``(lat, w)`` pairs for the bracket
kernel — so a caller that prices many grids (``CompiledBundle.tensors``)
prepares it once and passes the :class:`CsrGroup` instead of the triple.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode

from .. import _plan
from . import sweep_bracket as _cuda
from .ref import bracket_segsum_ref, segment_sum_ref

BRACKET_NAMES = ("hit_degraded", "lfb_mem", "lfb_half", "miss_congested")
_FLOATS = (torch.float32, torch.float64)
_MAX_SEG = 65535      # segsum_kernel puts the segment on grid axis y
#: Bytes of (lat, w) pairs, over the three groups, that the bracket kernel
#: keeps whole in shared memory (``kResidentBytes`` in csrc); a larger
#: bundle takes its tiled path.
RESIDENT_BYTES = 48 * 1024


#: ``bracket_kernel``'s shape (``csrc/sweep_bracket.cu``): threads per
#: CTA, scenarios a CTA's tile, bytes of the stage's two buffers, pairs a
#: window of the tiled path, most sites whose metadata is copied to shared
#: memory; ``segsum_kernel``'s threads per CTA.
THREADS, TILE, STAGE_BYTES, WINDOW, META_SITES = 128, 512, 32 * 1024, 512, 256
SEGSUM_THREADS = 128


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def plan(S: int, n_seg: int, n_pairs: int, resident: bool, itemsize: int,
         sms: int, occ: int) -> _plan.LaunchPlan:
    """The launch ``sweep_bracket_plan_*`` computes for ``S`` scenarios,
    ``n_seg`` sites and ``n_pairs`` (lat, w) pairs over the three groups,
    in floats of ``itemsize`` bytes: a persistent grid of at most ``occ``
    CTAs on each of ``sms`` SMs (both of which the card reports) over
    the scenario tiles; dynamic shared memory for the stage, the sites'
    metadata and the pairs (``resident``) or a window of them."""
    pair = 2 * itemsize
    cs = min(n_seg, STAGE_BYTES // (2 * TILE * itemsize))
    meta = 3 * (_align16((n_seg + 1) * 4) + _align16(n_seg * pair)) \
        if n_seg <= META_SITES else 0
    bufs = (("stage (2 chunks of sums)", 2 * TILE * cs * itemsize),
            ("site offsets and bounds", meta),
            ("pairs" if resident else "window",
             (n_pairs if resident else WINDOW) * pair))
    tiles = -(-S // TILE)
    return _plan.LaunchPlan(
        "bracket_kernel", _plan.dim3(min(tiles, max(1, occ) * sms)),
        _plan.dim3(THREADS), sum(b for _, b in bufs),
        buffers=tuple((n, b, "dynamic") for n, b in bufs))


def segsum_plan(rows: int, n_seg: int) -> _plan.LaunchPlan:
    """The launch ``segsum_plan_*`` computes: a thread a row, the segment
    on grid y."""
    return _plan.LaunchPlan("segsum_kernel",
                            _plan.dim3(-(-rows // SEGSUM_THREADS), n_seg),
                            _plan.dim3(SEGSUM_THREADS))


def occupancy_estimate(smem: int, threads: int = THREADS) -> int:
    """CTAs an H100 SM holds at ``smem`` dynamic bytes a CTA, from its
    2,048 threads, 32 CTAs and 228 KB of shared memory (1 KB of it
    reserved per CTA), registers aside: the analysis tier's stand-in for
    what ``sweep_bracket_attrs_*`` reads on the card."""
    return max(1, min(2048 // threads, 32, 233_472 // (smem + 1024)))


def case_plan(case: dict) -> _plan.LaunchPlan:
    """The plan of an analysis case (``analysis.kernelcheck``): ``S``
    scenarios, ``n_seg`` sites, ``n_max`` samples in each of the three
    groups, ``dtype``; ``sms`` and ``occ`` default to an H100's."""
    itemsize = 8 if case["dtype"] == "float64" else 4
    n_pairs = 3 * (case["n_max"] + case["n_max"] % 2)
    resident = n_pairs * 2 * itemsize <= RESIDENT_BYTES
    sms = case.get("sms", 132)
    args = (case["S"], case["n_seg"], n_pairs, resident, itemsize, sms)
    occ = case.get("occ") or occupancy_estimate(plan(*args, 1).smem)
    return plan(*args, occ)


def _case_outputs(case: dict) -> dict:
    return {name: (case["S"], case["n_seg"]) for name in BRACKET_NAMES}


def _case_tiles(case: dict, p: _plan.LaunchPlan, cta) -> dict:
    """What CTA ``cta`` writes: the rows of every ``TILE``-scenario tile
    its stride loop takes (``tile = blockIdx.x; tile += gridDim.x``),
    every site of each of the four outputs."""
    S, n_seg = case["S"], case["n_seg"]
    rows = [((t * TILE, min((t + 1) * TILE, S)), (0, n_seg))
            for t in range(cta[0], -(-S // TILE), p.grid[0])]
    return {name: rows for name in BRACKET_NAMES}


def segsum_case_plan(case: dict) -> _plan.LaunchPlan:
    """The plan of an analysis case: ``rows`` x ``n`` -> ``n_seg``."""
    return segsum_plan(case["rows"], case["n_seg"])


def _segsum_tiles(case: dict, p: _plan.LaunchPlan, cta) -> dict:
    """A thread a row of CTA x's rows, at segment ``blockIdx.y``."""
    r0 = cta[0] * SEGSUM_THREADS
    return {"out": [((r0, min(r0 + SEGSUM_THREADS, case["rows"])),
                     (cta[1], cta[1] + 1))]}


def _make_dataflow():
    from ...analysis.dataflow import DataflowContract
    par = ("parallel",) * 3
    return (DataflowContract(par, case_plan, _case_outputs, _case_tiles),
            DataflowContract(par, segsum_case_plan,
                             lambda c: {"out": (c["rows"], c["n_seg"])},
                             _segsum_tiles))


DATAFLOW, SEGSUM_DATAFLOW = _make_dataflow()


class CsrGroup(NamedTuple):
    """A packed sample group in the kernels' CSR form."""

    lat: torch.Tensor               # (n,)
    w: torch.Tensor                 # (n,)
    seg: torch.Tensor               # (n,) int64 ids (the plain version's input)
    offsets: torch.Tensor           # (n_seg + 1,) int32
    perm: torch.Tensor | None       # (n,) int32 stable sort of seg, or None
    pairs: torch.Tensor             # (n + n % 2, 2): (lat, w) in site order
    bounds: torch.Tensor            # (n_seg, 2): (min, max) lat per site


def _csr(seg: torch.Tensor, n_seg: int):
    """CSR offsets (and a stable permutation for unsorted ids) of ``seg``."""
    seg = seg.to(torch.int64)
    n = seg.numel()
    if n and (int(seg.min()) < 0 or int(seg.max()) >= n_seg):
        raise ValueError(f"segment ids must lie in [0, {n_seg})")
    if n >= 2**31:
        raise ValueError(f"{n} samples exceed the kernels' int32 indexing")
    counts = torch.bincount(seg, minlength=n_seg)
    offsets = torch.zeros(n_seg + 1, dtype=torch.int64, device=seg.device)
    offsets[1:] = torch.cumsum(counts, 0)
    ordered = n < 2 or bool((seg[1:] >= seg[:-1]).all())
    perm = None if ordered else \
        torch.argsort(seg, stable=True).to(torch.int32)
    return seg, offsets.to(torch.int32), perm


def csr_group(lat, w, seg, n_seg: int) -> CsrGroup:
    """Prepare one ``(lat, w, seg)`` group for the kernels (on ``lat``'s
    device)."""
    lat = torch.as_tensor(lat)
    w = torch.as_tensor(w, device=lat.device)
    seg = torch.as_tensor(seg, device=lat.device)
    if not (lat.ndim == w.ndim == seg.ndim == 1
            and lat.shape == w.shape == seg.shape):
        raise ValueError("a group is three 1-D tensors of one length, got "
                         f"{tuple(lat.shape)}, {tuple(w.shape)}, "
                         f"{tuple(seg.shape)}")
    seg, offsets, perm = _csr(seg, n_seg)
    return CsrGroup(lat.contiguous(), w.contiguous(), seg, offsets, perm,
                    site_pairs(lat, w, perm), site_bounds(lat, seg, n_seg))


def site_pairs(lat: torch.Tensor, w: torch.Tensor,
               perm: torch.Tensor | None) -> torch.Tensor:
    """The samples in site order, ``(lat[perm], w[perm])`` row by row, in a
    fresh ``(n + n % 2, 2)`` tensor of ``lat``'s dtype: an even row count,
    so that every group's pairs are a whole number of 16-byte units (the
    padding row is never read)."""
    n = lat.numel()
    pairs = lat.new_zeros((n + n % 2, 2))
    if perm is None:
        pairs[:n, 0], pairs[:n, 1] = lat, w
    else:
        idx = perm.long()
        pairs[:n, 0], pairs[:n, 1] = lat[idx], w[idx]
    return pairs


def site_bounds(lat: torch.Tensor, seg: torch.Tensor,
                n_seg: int) -> torch.Tensor:
    """``(n_seg, 2)``: each site's least and greatest ``lat`` (``+inf`` and
    ``-inf`` for a site without samples).  The bracket kernel reads them to
    skip the per-term test where a site's terms all fall on one side."""
    inf = torch.full((n_seg,), float("inf"), dtype=lat.dtype,
                     device=lat.device)
    lo = inf.scatter_reduce(0, seg, lat, "amin")
    hi = (-inf).scatter_reduce(0, seg, lat, "amax")
    return torch.stack([lo, hi], 1)


def bracket_resident(groups) -> bool:
    """Whether the bracket kernel keeps the groups' pairs whole in shared
    memory (else it stages each site's pairs in tiles)."""
    return sum(g.pairs.numel() * g.pairs.element_size()
               for g in groups) <= RESIDENT_BYTES


def _as_group(g, n_seg: int) -> CsrGroup:
    if isinstance(g, CsrGroup):
        if g.offsets.numel() != n_seg + 1 or g.bounds.shape != (n_seg, 2):
            raise ValueError(f"CsrGroup prepared for "
                             f"{g.offsets.numel() - 1} segments, not {n_seg}")
        return g
    return csr_group(*g, n_seg)


def _check_cuda(t: torch.Tensor, dev: torch.device, dtype, what: str):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dtype} tensor on "
                         f"{dev}, got {t.dtype} on {t.device}")


def fused_bracket_segsum(hit, lfb, miss, delta, cxl_lat, n_seg: int) -> dict:
    """The four scenario-dependent bracket aggregates, fused.

    ``hit`` / ``lfb`` / ``miss``: ``(lat, w, seg)`` triples (1-D, any
    lengths) or prepared :class:`CsrGroup`\\ s; ``delta`` / ``cxl_lat``:
    per-scenario ``(S,)`` or ``(S, 1)`` float32/float64 tensors;
    ``n_seg``: number of call-sites.  Returns ``{name: (S, n_seg)}`` for
    ``hit_degraded``, ``lfb_mem``, ``lfb_half`` and ``miss_congested`` in
    ``delta``'s dtype.  Under a capture (fake tensors, or any dispatch
    mode) the checked call is the custom op
    ``repro_torch::fused_bracket_segsum``, so a captured step holds the
    kernel as one node.
    """
    delta = delta.reshape(-1)
    cxl_lat = cxl_lat.reshape(-1)
    if delta.dtype not in _FLOATS or cxl_lat.shape != delta.shape:
        raise ValueError("delta and cxl_lat must be float32/float64 tensors "
                         "with one value per scenario")
    groups = [_as_group(g, n_seg) for g in (hit, lfb, miss)]
    dev, dt = delta.device, delta.dtype
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if dev.type == "cuda":
        if n_seg > _MAX_SEG:
            raise ValueError(f"n_seg={n_seg} exceeds {_MAX_SEG}")
        delta, cxl_lat = delta.contiguous(), cxl_lat.contiguous()
        _check_cuda(cxl_lat, dev, dt, "cxl_lat")
        for name, g in zip(("hit", "lfb", "miss"), groups):
            _check_cuda(g.lat, dev, dt, name + " lat")
            _check_cuda(g.w, dev, dt, name + " w")
            _check_cuda(g.offsets, dev, torch.int32, name + " offsets")
            _check_cuda(g.pairs, dev, dt, name + " pairs")
            _check_cuda(g.bounds, dev, dt, name + " bounds")
            if g.pairs.shape != (g.lat.numel() + g.lat.numel() % 2, 2):
                raise ValueError(f"{name} pairs: expected an (n + n % 2, 2) "
                                 f"tensor from csr_group, got "
                                 f"{tuple(g.pairs.shape)}")
    args = (*([getattr(g, f) for g in groups]
              for f in ("lat", "w", "seg", "pairs", "offsets", "bounds")),
            delta, cxl_lat, n_seg, bracket_resident(groups))
    # Outside a capture the op's body runs as a plain call: through the
    # op's own dispatch (its autograd and aliasing checks over 18 tensors)
    # a small call took about 50 us longer, and price() of 262,144
    # scenarios 25-32 ms against 12-17 ms (python -m
    # repro_torch.launch.wall_times, NVIDIA H100 80GB HBM3 at 700 W).
    traced = isinstance(delta, FakeTensor) \
        or _get_current_dispatch_mode() is not None
    outs = (fused_bracket_segsum_op if traced else _bracket_body)(*args)
    return dict(zip(BRACKET_NAMES, outs))


def _bracket_body(lat: list[torch.Tensor], w: list[torch.Tensor],
                  seg: list[torch.Tensor], pairs: list[torch.Tensor],
                  offsets: list[torch.Tensor], bounds: list[torch.Tensor],
                  delta: torch.Tensor, cxl_lat: torch.Tensor, n_seg: int,
                  resident: bool) -> list[torch.Tensor]:
    """The checked call, each argument a list over the (hit, lfb, miss)
    groups: the plain version on the CPU, the kernel on the card.  As the
    op ``repro_torch::fused_bracket_segsum`` a capture records it as one
    node (its fake version gives the shapes only, and launches and counts
    nothing)."""
    if delta.device.type == "cpu":
        out = bracket_segsum_ref(*zip(lat, w, seg), delta, cxl_lat, n_seg)
        return [out[k] for k in BRACKET_NAMES]
    s = delta.shape[0]
    if s == 0 or n_seg == 0:
        return [delta.new_zeros((s, n_seg)) for _ in BRACKET_NAMES]
    for name, p in zip(("hit", "lfb", "miss"), pairs):
        if p.data_ptr() % 16:
            raise ValueError(f"{name} pairs: expected a 16-byte aligned "
                             "tensor from csr_group")
    outs = [torch.empty((s, n_seg), dtype=delta.dtype, device=delta.device)
            for _ in BRACKET_NAMES]
    with torch.cuda.device(delta.device):
        _cuda.launch_bracket(list(zip(pairs, offsets, bounds)), delta,
                             cxl_lat, n_seg, resident, outs)
    fused_bracket_segsum.launches += 1
    return outs


fused_bracket_segsum_op = torch.library.custom_op(
    "repro_torch::fused_bracket_segsum", mutates_args=())(_bracket_body)


@fused_bracket_segsum_op.register_fake
def _(lat, w, seg, pairs, offsets, bounds, delta, cxl_lat, n_seg, resident):
    return [delta.new_empty((delta.shape[0], n_seg)) for _ in BRACKET_NAMES]


fused_bracket_segsum.launches = 0


def segment_sum(x, seg_ids, n_seg: int) -> torch.Tensor:
    """Segment sum: ``x (..., n)`` + ids ``(n,)`` in ``[0, n_seg)``, sorted
    or not -> ``(..., n_seg)``; empty segments sum to zero."""
    lead, n = x.shape[:-1], x.shape[-1]
    seg, offsets, perm = _csr(torch.as_tensor(seg_ids, device=x.device),
                              n_seg)
    if seg.numel() != n:
        raise ValueError(f"{seg.numel()} ids for {n} columns")
    if x.device.type == "cpu":
        return segment_sum_ref(x, seg, n_seg)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _FLOATS:
        raise ValueError(f"segment_sum takes float32/float64, got {x.dtype}")
    rows = math.prod(lead)
    if rows == 0 or n_seg == 0 or n == 0:
        return x.new_zeros(lead + (n_seg,))
    if n_seg > _MAX_SEG or rows >= 2**31:
        raise ValueError(f"shape ({rows}, {n}) -> {n_seg} segments is "
                         "beyond the kernel's grid")
    x2 = x.reshape(rows, n).contiguous()
    out = torch.empty((rows, n_seg), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _cuda.launch_segsum(x2, offsets, perm, n_seg, out)
    segment_sum.launches += 1
    return out.reshape(lead + (n_seg,))


segment_sum.launches = 0
