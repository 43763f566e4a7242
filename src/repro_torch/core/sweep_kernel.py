"""Backend-pluggable grid pricing for the scenario sweep (PyTorch).

The counterpart of ``repro.core.sweep_kernel``.  ``price_grid(cb, view)``
is the one body of the sweep: characterization weights -> bracket terms
(segment sums over the packed samples) -> ``category_bracket`` /
``combine_categories`` / ``unpack_blend`` -> transfer models.  It runs on
the device the view lives on, in the view's float dtype (float64 unless a
plan asks for float32), under three executors:

  * :func:`price_grid_numpy` — on the host; the segment sums are
    ``np.add.reduceat`` over the packed samples, as in the reference's
    NumPy backend.
  * :func:`price_grid_torch` — unfused: the four ``(S, n_samples)``
    bracket terms are materialized on the device, then reduced with
    ``index_add_`` (the reference left this reduction to
    ``jax.ops.segment_sum``).
  * :func:`price_grid_fused` — the four scenario-dependent bracket sums
    come from the CUDA kernel in ``repro_torch.kernels.sweep_bracket``
    (the counterpart of the reference's Pallas executor): terms are
    computed and reduced per site in registers, so the ``(S, n_samples)``
    intermediates never exist.

The physics is written once, in ``access`` / ``characterization`` /
``transfer``; the fused kernel is the one deliberate restatement of the
scenario-dependent bracket terms, and its parity with the unfused path is
pinned by the tests and by ``chip_smoke.py``.

Scenario-dependent inputs arrive through the ``view`` (``ParamGrid.view()``
moved to the device with ``.to``): every numeric ``ModelParams`` field as an
``(S, 1)`` (or, unvaried in an ``ArraySet``, ``(1, 1)``) float tensor,
threshold pairs as lower/upper tensors, and for the categorical
transfer-model axes a tuple of candidate models plus an integer code
selecting one per scenario.  The bundle's constants come from
``cb.tensors(device, dtype)``, uploaded once per device and dtype and
cached on the bundle.

:func:`price_topk_chunk` is the streaming backend's step: one chunk priced
by the fused executor, then reduced on its device to per-shard top-k
candidates and exact aggregates.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.sweep_bracket import fused_bracket_segsum, segment_sum
from .access import (BracketTerms, category_bracket, combine_categories,
                     unpack_blend)
from .characterization import ALL_CATEGORIES, Characterization

#: The ``(n_scenarios, n_calls)`` component matrices a sweep produces, in
#: ``SweepResult`` field order; ``price_grid`` returns a dict with exactly
#: these keys.
MATRIX_FIELDS = ("t_transfer_mpi_ns", "t_transfer_cxl_ns",
                 "t_access_mpi_ns", "t_access_cxl_ns")

#: Speedup histogram bin edges of ``SweepAggregates`` and the streaming
#: reducer: bucket ``j = searchsorted(edges, sp, side="right")``, giving
#: ``len(edges) + 1`` bins — ``j = 0`` is the ``sp < edges[0]`` underflow,
#: ``j = len(edges)`` the ``sp >= edges[-1]`` overflow.
SPEEDUP_HIST_EDGES = np.linspace(0.0, 2.0, 41)

#: Scenario-axis chunk the streaming ``"distributed"`` backend prices at a
#: time: each chunk's ``(chunk, n_calls)`` matrices stay a few MB.
DIST_CHUNK_DEFAULT = 65536


# --------------------------------------------------------------------------
# Segment sums (per-site reductions over the packed sample axis)
# --------------------------------------------------------------------------

def _segment_sum_np(x: np.ndarray, starts: np.ndarray,
                    counts: np.ndarray) -> np.ndarray:
    """Row-wise per-site sums of packed sample terms.

    ``np.add.reduceat`` returns ``x[start]`` (not 0) for empty segments, so
    empties are masked out explicitly.
    """
    n = x.shape[-1]
    n_seg = len(starts)
    if n == 0 or n_seg == 0:
        return np.zeros(x.shape[:-1] + (n_seg,), dtype=x.dtype)
    # pad one zero so a start index of ``n`` (empty trailing segment) is
    # valid WITHOUT clipping — clipping would shorten the previous segment
    pad = np.zeros(x.shape[:-1] + (1,), dtype=x.dtype)
    out = np.add.reduceat(np.concatenate([x, pad], axis=-1), starts, axis=-1)
    return np.where(counts > 0, out, np.zeros((), dtype=x.dtype))


def _segment_sum(x: torch.Tensor, starts, counts, seg_ids, n_seg: int,
                 impl: str = "index_add") -> torch.Tensor:
    """``x``'s LAST axis is the packed-sample axis; the result replaces it
    with an ``n_seg`` per-site axis.

    ``impl``: ``"reduceat"`` (host NumPy over ``starts`` / ``counts``),
    ``"index_add"`` (``index_add_`` over ``seg_ids``, any device) or
    ``"kernel"`` (the CUDA segment-sum kernel on CUDA tensors, its plain
    version on CPU ones).
    """
    if impl == "reduceat":
        return torch.from_numpy(_segment_sum_np(x.numpy(), starts, counts))
    if impl == "kernel":
        return segment_sum(x, seg_ids, n_seg)
    if impl != "index_add":
        raise ValueError(f"unknown segment-sum impl {impl!r}")
    out = x.new_zeros(x.shape[:-1] + (n_seg,))
    return out.index_add_(-1, seg_ids, x)


# --------------------------------------------------------------------------
# The pricing body
# --------------------------------------------------------------------------

def _select_transfer(models, code, traffic):
    """Per-scenario transfer time: evaluate every candidate model (fields
    broadcast ``(S, 1)``) and select by the scenario's integer code."""
    t = models[0].transfer_from_traffic(traffic)
    for k in range(1, len(models)):
        t = torch.where(code == k, models[k].transfer_from_traffic(traffic), t)
    return t


def _bracket_seg_terms(cb, delta, cxl_lat, impl: str = "index_add") -> dict:
    """The four scenario-dependent bracket aggregates — the unfused path:
    one ``(S, n_samples)`` term per bracket, materialized then
    segment-summed to ``(S, n_calls)``.  :func:`price_grid_fused` swaps
    this stage for the fused kernel via the ``bracket_terms=`` seam."""
    t = cb.tensors(delta.device, delta.dtype)
    zero = delta.new_zeros(())

    def seg(x, grp):
        return _segment_sum(x, getattr(cb, grp + "_starts"),
                            getattr(cb, grp + "_counts"),
                            getattr(t, grp + "_seg"), cb.n_calls, impl)

    return {
        "hit_degraded": seg(t.hit_w * torch.maximum(t.hit_lat + delta, zero),
                            "hit"),
        "lfb_mem": seg(t.lfb_w * torch.maximum(t.lfb_lat + delta, zero),
                       "lfb"),
        "lfb_half": seg(t.lfb_w * torch.maximum(t.lfb_lat + delta / 2.0,
                                                zero), "lfb"),
        "miss_congested": seg(t.miss_w * torch.maximum(cxl_lat,
                                                       t.miss_lat + delta),
                              "miss"),
    }


def price_grid(cb, view, bracket_terms=None) -> dict:
    """Price one compiled bundle under every scenario of ``view``, on the
    device the view's tensors live on.

    ``bracket_terms`` (default :func:`_bracket_seg_terms`) supplies the
    four scenario-dependent bracket aggregates as ``fn(cb, delta, cxl_lat)
    -> {name: (S, n_calls)}`` — the seam the fused kernel plugs into.

    The view's float dtype is the pricing dtype: the bundle's constants
    come from ``cb.tensors`` on the view's device in that dtype (per-call
    counters and sampling period of a super-bundle included).

    Returns ``{field: tensor}`` for :data:`MATRIX_FIELDS`; each broadcasts
    to ``(n_scenarios, n_calls)`` (executors normalize shapes).
    """
    v = view
    t = cb.tensors(v.mem_lat_ns.device, v.mem_lat_ns.dtype)

    # -- characterization (same code path as the scalar predictor) ----------
    ch = Characterization.from_counters(t.counters, v)   # (S, 1) or (S, C)
    f_first = 1.0 / t.accesses_per_element.clamp(min=1.0)        # (C,)
    weights = {c: f_first * ch.first[c] + (1.0 - f_first) * ch.subsequent[c]
               for c in ALL_CATEGORIES}                          # (S, C)

    # -- access model: Eq. 5 baseline + Eq. 6-10 re-pricing ------------------
    cxl_lat = v.cxl_lat_ns
    delta = cxl_lat - v.mem_lat_ns                               # (S, 1)
    segd = (bracket_terms or _bracket_seg_terms)(cb, delta, cxl_lat)

    terms = BracketTerms(
        hit=t.hit_wl_sum,
        hit_degraded=segd["hit_degraded"],
        lfb_plain=t.lfb_wl_sum,
        lfb_mem=segd["lfb_mem"],
        lfb_half=segd["lfb_half"],
        miss_flat=cxl_lat * t.miss_w_sum,
        miss_congested=segd["miss_congested"])

    brackets = {c: category_bracket(c, terms, t.prefetch_frac)
                for c in ALL_CATEGORIES}
    t_cxl = combine_categories(brackets, weights, v)             # (S, C)
    t_ddr = combine_categories({c: t.total_wl for c in ALL_CATEGORIES},
                               weights, v)
    t_cxl = unpack_blend(t_cxl, t_ddr, f_first, t.unpack)

    # -- transfer model (shared transfer_from_traffic core) ------------------
    return {
        "t_transfer_mpi_ns": _select_transfer(
            v.mpi_transfer_models, v.mpi_transfer_code, t.traffic),
        "t_transfer_cxl_ns": _select_transfer(
            v.free_transfer_models, v.free_transfer_code, t.traffic),
        "t_access_mpi_ns": t_ddr * t.sampling_period,
        "t_access_cxl_ns": t_cxl * t.sampling_period,
    }


# --------------------------------------------------------------------------
# Executors: ``fn(cb, device_view) -> {field: tensor}``
# --------------------------------------------------------------------------

def price_grid_numpy(cb, view) -> dict:
    """Host pricing with ``np.add.reduceat`` segment sums (``view`` on the
    CPU)."""
    if view.mem_lat_ns.device.type != "cpu":
        raise ValueError("the numpy executor prices on the host; give it "
                         "a CPU view")
    return price_grid(cb, view, bracket_terms=lambda cb_, d, x:
                      _bracket_seg_terms(cb_, d, x, impl="reduceat"))


def price_grid_torch(cb, view) -> dict:
    """Unfused pricing: materialized ``(S, n_samples)`` terms reduced with
    ``index_add_``, on the view's device."""
    return price_grid(cb, view)


def price_grid_fused(cb, view) -> dict:
    """Pricing with the fused bracket/segment-sum kernel (its plain version
    when the view is on the CPU).  The bundle's groups enter in the CSR form
    cached by ``cb.tensors``."""
    def bracket_terms(cb_, delta, cxl_lat):
        g = cb_.tensors(delta.device, delta.dtype).groups
        return fused_bracket_segsum(g["hit"], g["lfb"], g["miss"], delta,
                                    cxl_lat, cb_.n_calls)

    return price_grid(cb, view, bracket_terms=bracket_terms)


# --------------------------------------------------------------------------
# The streaming reducer (one padded chunk -> per-shard top-k + aggregates)
# --------------------------------------------------------------------------

def _top_rows(key: torch.Tensor, k: int) -> torch.Tensor:
    """Per shard, the positions of the ``k`` largest ``key`` values, best
    first, ties toward the lower position (a stable sort: ``torch.topk``
    gives no tie order)."""
    return torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]


def price_topk_chunk(cb, view, valid, idx, k: int,
                     n_devices: int = 1) -> dict:
    """Price ONE padded scenario chunk and reduce it on its device to
    per-shard candidates and exact aggregates — the inner step of the
    streaming ``"distributed"`` backend.

    ``view`` is a device view (``_ParamArrays.to``) whose scenario-axis
    leaves hold ``n_pad`` rows, ``n_pad % n_devices == 0``; ``valid`` is
    the ``(n_pad,)`` bool mask of real rows and ``idx`` their ``(n_pad,)``
    global scenario indices.  The chunk is priced by
    :func:`price_grid_fused` (one bracket-kernel launch on CUDA, its plain
    version on the CPU); the ``n_pad`` rows are then split into
    ``n_devices`` shards of ``n_pad / n_devices`` rows, stacked along a
    leading axis, and each is reduced on the device.  Only ``O(n_devices x
    (k + n_calls))`` values come back to the host.

    Returns NumPy arrays with a leading shard axis: ``top_val`` /
    ``top_idx`` / ``top_ok`` ``(n_dev, k)`` — each shard's best predicted
    speedups (masked rows ``-inf``, ``ok=False``), their global indices
    and validity; ``front_val`` / ``front_idx`` / ``front_ok`` — the
    scenarios closest to speedup 1.0 (ordered by ``-|sp - 1|``;
    ``front_val`` is the speedup); ``count`` / ``sp_sum`` / ``sp_min`` /
    ``sp_max`` ``(n_dev,)``; ``hist`` ``(n_dev, len(SPEEDUP_HIST_EDGES) +
    1)`` exact bucket counts; ``n_beneficial`` / ``gain_sum`` ``(n_dev,
    n_calls)``.
    """
    return {name: val.cpu().numpy() for name, val in
            topk_chunk_tensors(cb, view, valid, idx, k, n_devices).items()}


def topk_chunk_tensors(cb, view, valid, idx, k: int,
                       n_devices: int = 1) -> dict:
    """:func:`price_topk_chunk`'s outputs as tensors on the view's device
    (the multi-rank sweep gathers them there)."""
    dev = view.mem_lat_ns.device
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    n_pad, n_dev = valid.shape[0], int(n_devices)
    if n_pad == 0 or n_dev < 1 or n_pad % n_dev:
        raise ValueError(f"chunk of {n_pad} padded scenarios does not "
                         f"shard evenly over {n_dev} devices")
    n_loc = n_pad // n_dev
    k_local = min(int(k), n_loc)
    if k_local < 1:
        raise ValueError(f"topk must be >= 1, got {k}")
    C = cb.n_calls

    mats = price_grid_fused(cb, view)
    gain = ((mats["t_transfer_mpi_ns"] + mats["t_access_mpi_ns"])
            - (mats["t_transfer_cxl_ns"] + mats["t_access_cxl_ns"]))
    gain = gain.expand(n_pad, C).reshape(n_dev, n_loc, C)
    base = cb.baseline_runtime_ns
    sp = base / (base - gain.sum(dim=-1))                  # (n_dev, n_loc)
    ok = valid.reshape(n_dev, n_loc)
    gidx = idx.reshape(n_dev, n_loc)
    inf = torch.tensor(float("inf"), dtype=sp.dtype, device=dev)

    spv = torch.where(ok, sp, -inf)
    pos = _top_rows(spv, k_local)
    fpos = _top_rows(torch.where(ok, -(sp - 1.0).abs(), -inf), k_local)
    edges = torch.as_tensor(SPEEDUP_HIST_EDGES, dtype=sp.dtype, device=dev)
    n_hist = len(SPEEDUP_HIST_EDGES) + 1
    # one bincount over every shard: shard j's buckets at j * n_hist, the
    # masked rows in one extra bin past the end, dropped
    bucket = torch.searchsorted(edges, sp, right=True) \
        + n_hist * torch.arange(n_dev, device=dev)[:, None]
    bucket = torch.where(ok, bucket, n_dev * n_hist)
    hist = torch.bincount(bucket.reshape(-1),
                          minlength=n_dev * n_hist + 1)[:-1]
    okc = ok[..., None]
    out = {
        "top_val": spv.gather(1, pos),
        "top_idx": gidx.gather(1, pos),
        "top_ok": ok.gather(1, pos),
        "front_val": sp.gather(1, fpos),
        "front_idx": gidx.gather(1, fpos),
        "front_ok": ok.gather(1, fpos),
        "count": ok.sum(dim=1),
        "sp_sum": torch.where(ok, sp, 0.0).sum(dim=1),
        "sp_min": torch.where(ok, sp, inf).amin(dim=1),
        "sp_max": spv.amax(dim=1),
        "hist": hist.reshape(n_dev, n_hist),
        "n_beneficial": ((gain > 0) & okc).sum(dim=1),
        "gain_sum": torch.where(okc, gain, 0.0).sum(dim=1),
    }
    return out
