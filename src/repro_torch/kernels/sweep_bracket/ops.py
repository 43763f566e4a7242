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

from . import sweep_bracket as _cuda
from .ref import bracket_segsum_ref, segment_sum_ref

BRACKET_NAMES = ("hit_degraded", "lfb_mem", "lfb_half", "miss_congested")
_FLOATS = (torch.float32, torch.float64)
_MAX_SEG = 65535      # segsum_kernel puts the segment on grid axis y
#: Bytes of (lat, w) pairs, over the three groups, that the bracket kernel
#: keeps whole in shared memory (``kResidentBytes`` in csrc); a larger
#: bundle takes its tiled path.
RESIDENT_BYTES = 48 * 1024


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
    ``delta``'s dtype.
    """
    delta = delta.reshape(-1)
    cxl_lat = cxl_lat.reshape(-1)
    if delta.dtype not in _FLOATS or cxl_lat.shape != delta.shape:
        raise ValueError("delta and cxl_lat must be float32/float64 tensors "
                         "with one value per scenario")
    groups = [_as_group(g, n_seg) for g in (hit, lfb, miss)]
    s = delta.shape[0]
    if delta.device.type == "cpu":
        return bracket_segsum_ref(*[(g.lat, g.w, g.seg) for g in groups],
                                  delta, cxl_lat, n_seg)
    if delta.device.type != "cuda":
        raise ValueError(f"no kernel for device {delta.device}")
    if s == 0 or n_seg == 0:
        return {k: delta.new_zeros((s, n_seg)) for k in BRACKET_NAMES}
    if n_seg > _MAX_SEG:
        raise ValueError(f"n_seg={n_seg} exceeds {_MAX_SEG}")
    dev, dt = delta.device, delta.dtype
    delta, cxl_lat = delta.contiguous(), cxl_lat.contiguous()
    _check_cuda(cxl_lat, dev, dt, "cxl_lat")
    args = []
    for name, g in zip(("hit", "lfb", "miss"), groups):
        _check_cuda(g.lat, dev, dt, name + " lat")
        _check_cuda(g.w, dev, dt, name + " w")
        _check_cuda(g.offsets, dev, torch.int32, name + " offsets")
        _check_cuda(g.pairs, dev, dt, name + " pairs")
        _check_cuda(g.bounds, dev, dt, name + " bounds")
        if g.pairs.shape != (g.lat.numel() + g.lat.numel() % 2, 2) \
                or g.pairs.data_ptr() % 16:
            raise ValueError(f"{name} pairs: expected a 16-byte aligned "
                             f"(n + n % 2, 2) tensor from csr_group, got "
                             f"{tuple(g.pairs.shape)}")
        args.append((g.pairs, g.offsets, g.bounds))
    outs = [torch.empty((s, n_seg), dtype=dt, device=dev)
            for _ in BRACKET_NAMES]
    with torch.cuda.device(dev):
        _cuda.launch_bracket(args, delta, cxl_lat, n_seg,
                             bracket_resident(groups), outs)
    fused_bracket_segsum.launches += 1
    return dict(zip(BRACKET_NAMES, outs))


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
