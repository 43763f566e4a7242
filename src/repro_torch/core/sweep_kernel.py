"""Backend-pluggable grid pricing for the scenario sweep (PyTorch).

The counterpart of ``repro.core.sweep_kernel``.  ``price_grid(cb, view)``
is the one body of the sweep: characterization weights -> bracket terms
(segment sums over the packed samples) -> ``category_bracket`` /
``combine_categories`` / ``unpack_blend`` -> transfer models.  It runs on
the device the view lives on, in float64, under three executors:

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
``(S, 1)`` float64 tensor, threshold pairs as lower/upper tensors, and for
the categorical transfer-model axes a tuple of candidate models plus an
``(S, 1)`` integer code selecting one per scenario.  The bundle's constants
come from ``cb.tensors(device)``, uploaded once per device and cached on the
bundle.
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

#: Speedup histogram bin edges of ``SweepAggregates``: bucket
#: ``j = searchsorted(edges, sp, side="right")``, ``len(edges) + 1`` bins.
SPEEDUP_HIST_EDGES = np.linspace(0.0, 2.0, 41)


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
    t = cb.tensors(delta.device)
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

    Returns ``{field: tensor}`` for :data:`MATRIX_FIELDS`; each broadcasts
    to ``(n_scenarios, n_calls)`` (executors normalize shapes).
    """
    v = view
    t = cb.tensors(v.mem_lat_ns.device)

    # -- characterization (same code path as the scalar predictor) ----------
    ch = Characterization.from_counters(cb.counters, v)          # (S, 1)
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
        "t_access_mpi_ns": t_ddr * cb.sampling_period,
        "t_access_cxl_ns": t_cxl * cb.sampling_period,
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
        g = cb_.tensors(delta.device).groups
        return fused_bracket_segsum(g["hit"], g["lfb"], g["miss"], delta,
                                    cxl_lat, cb_.n_calls)

    return price_grid(cb, view, bracket_terms=bracket_terms)
