"""Data-access overhead models (paper Sec. IV-C).

The MPI scenario (Eq. 5) replays observed sample latencies; the CXL scenario
re-prices each sample according to its *data source* with a per-category
bracket formula (Eq. 6-10).  Equation 7 (MBW) is printed incompletely in the
paper; it is reconstructed from the surrounding prose: like CBW (Eq. 8) but
with LFB samples treated pessimistically as memory-origin (the MLAT LFB
bracket).

All formulas scale the sampled latencies by the sampling ``rate`` (one sample
represents ``rate`` loads) and divide by a load-parallelism factor —
``LPF_LAT`` for the latency-limited categories, ``LPF_BW`` for the
bandwidth-limited and Compute categories (Fig. 2).

The PyTorch counterpart of ``repro.core.access``.  The bracket formulas live
in ONE place — ``BracketTerms`` + ``category_bracket`` +
``combine_categories`` — shared by the scalar per-call path below (0-d
float64 tensors and Python floats) and the sweep
(``repro_torch.core.sweep_kernel``, ``(n_scenarios, n_sites)`` float64
tensors on the pricing device).  The combinations are plain arithmetic and
broadcast either way.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .characterization import ALL_CATEGORIES, Category, Characterization
from .params import ModelParams
from .traces import CallSite, DataSource


def _lpf(cat: Category, p) -> float:
    if cat in (Category.MLAT, Category.CLAT):
        return p.lpf_lat
    return p.lpf_bw   # MBW, CBW, Compute (Sec. IV-C e)


@dataclass
class SampleArrays:
    """Vectorized view of a call-site's samples (host float64 tensors)."""

    lat: torch.Tensor      # ns
    weight: torch.Tensor
    is_hit: torch.Tensor   # L1/L2/L3
    is_lfb: torch.Tensor
    is_miss: torch.Tensor  # DRAM

    @staticmethod
    def of(samples) -> "SampleArrays":
        f64 = lambda v: torch.tensor(v, dtype=torch.float64)
        mask = lambda pred: torch.tensor([pred(s.source) for s in samples],
                                         dtype=torch.bool)
        return SampleArrays(
            lat=f64([s.lat_ns for s in samples]),
            weight=f64([s.weight for s in samples]),
            is_hit=mask(lambda src: src.is_cache_hit),
            is_lfb=mask(lambda src: src is DataSource.LFB),
            is_miss=mask(lambda src: src is DataSource.DRAM))


@dataclass(frozen=True)
class BracketTerms:
    """The seven weighted-sum aggregates entering Eq. 6-10.

    In the scalar per-call path each field is a float (one call-site, one
    scenario); in the sweep each is an ``(n_scenarios, n_sites)`` tensor
    (or ``(n_sites,)`` for the scenario-independent ones).
    """

    hit: object            # Σ w·lat over cache hits (scenario-independent)
    hit_degraded: object   # Σ w·max(lat+Δ, 0) over hits
    lfb_plain: object      # Σ w·lat over LFB (scenario-independent)
    lfb_mem: object        # Σ w·max(lat+Δ, 0) over LFB
    lfb_half: object       # Σ w·max(lat+Δ/2, 0) over LFB
    miss_flat: object      # Σ w over misses · CXL_LAT
    miss_congested: object # Σ w·max(CXL_LAT, lat+Δ) over misses


def bracket_terms(a: SampleArrays, p) -> BracketTerms:
    """Scalar-scenario aggregates for one call-site (Δ = CXL_LAT − MEM_LAT)."""
    delta = p.cxl_lat_ns - p.mem_lat_ns
    w, lat = a.weight, a.lat
    h, l, m = a.is_hit, a.is_lfb, a.is_miss
    wsum = lambda x: float(torch.sum(x))
    return BracketTerms(
        hit=wsum(w[h] * lat[h]),
        hit_degraded=wsum(w[h] * (lat[h] + delta).clamp(min=0.0)),
        lfb_plain=wsum(w[l] * lat[l]),
        lfb_mem=wsum(w[l] * (lat[l] + delta).clamp(min=0.0)),
        lfb_half=wsum(w[l] * (lat[l] + delta / 2.0).clamp(min=0.0)),
        miss_flat=wsum(w[m]) * p.cxl_lat_ns,
        miss_congested=wsum(w[m] * (lat[m] + delta).clamp(min=p.cxl_lat_ns)))


def category_bracket(cat: Category, t: BracketTerms, prefetch_hit_frac):
    """One category's bracket (the *undivided* sum; caller applies rate/LPF).

    ``prefetch_hit_frac`` is the fraction of cache hits that were
    prefetched (footnote 20) — those degrade to memory-origin timing when
    the buffer moves to CXL.
    """
    pf = prefetch_hit_frac
    hit_split = (1.0 - pf) * t.hit + pf * t.hit_degraded

    if cat is Category.MLAT:        # Eq. 6 — optimistic prefetch, pessimistic LFB
        return t.hit + t.lfb_mem + t.miss_flat
    if cat is Category.MBW:         # Eq. 7 (reconstructed) — both pessimistic
        return hit_split + t.lfb_mem + t.miss_congested
    if cat is Category.CBW:         # Eq. 8 — LFB optimistic (cache-origin)
        return hit_split + t.lfb_plain + t.miss_congested
    if cat is Category.CLAT:        # Eq. 9 — all cache-side optimistic
        return t.hit + t.lfb_plain + t.miss_flat
    if cat is Category.COMPUTE:     # Eq. 10 — LFB averaged between origins
        return t.hit + t.lfb_half + t.miss_flat
    raise ValueError(cat)


def combine_categories(brackets: dict, weights: dict, p):
    """Category-weighted, LPF-divided sum — the outer Σ of Eq. 5-10."""
    return sum(weights[c] * brackets[c] / _lpf(c, p) for c in ALL_CATEGORIES)


def unpack_blend(t_cxl, t_ddr, first_load_frac, unpack: torch.Tensor):
    """Sec. IV-C unpack mode (HPCG): only 1/n of each sample is priced as a
    CXL access (the streaming unpack copy touches each element once); the
    remaining (n-1)/n hit DDR exactly as in the MPI baseline.  ``unpack``
    is a ``torch.bool`` tensor (0-d for one site, ``(n_sites,)`` in the
    sweep)."""
    return torch.where(unpack, first_load_frac * t_cxl
                       + (1.0 - first_load_frac) * t_ddr, t_cxl)


def prefetch_hit_fraction(site: CallSite) -> float:
    """Footnote 20: one load per cache line is not a demand hit."""
    lpl = max(1.0, site.loads_per_line)
    return min(1.0, 1.0 / lpl)


def access_mpi_ns(site: CallSite, ch: Characterization, p: ModelParams) -> float:
    """Eq. 5 — observed latencies, category-blended load-parallelism factor."""
    a = SampleArrays.of(site.samples)
    total_lat = float(torch.sum(a.weight * a.lat))
    weights = ch.blended(site.accesses_per_element)
    return float(combine_categories(
        {c: total_lat for c in ALL_CATEGORIES}, weights, p))


def access_cxl_ns(site: CallSite, ch: Characterization, p: ModelParams) -> float:
    """Eq. 6-10 — re-priced latencies, weighted across categories.

    The 1/n first-load vs (n-1)/n subsequent-load split of Sec. IV-B2 enters
    through the blended weights (the bracket formulas are linear in samples,
    so splitting each sample is equivalent to blending the weight sets).
    """
    a = SampleArrays.of(site.samples)
    weights = ch.blended(site.accesses_per_element)
    pf = prefetch_hit_fraction(site)
    t = bracket_terms(a, p)

    t_cxl = combine_categories(
        {c: category_bracket(c, t, pf) for c in ALL_CATEGORIES}, weights, p)

    f = 1.0 / max(1.0, site.accesses_per_element)
    total_lat = float(torch.sum(a.weight * a.lat))
    t_ddr = combine_categories(
        {c: total_lat for c in ALL_CATEGORIES}, weights, p)
    return float(unpack_blend(t_cxl, t_ddr, f,
                              torch.tensor(bool(site.unpack))))


def scale_by_rate(t_ns: float, sampling_period: float) -> float:
    """One sample represents ``sampling_period`` loads."""
    return t_ns * sampling_period
