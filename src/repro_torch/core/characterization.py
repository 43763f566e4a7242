"""Application characterization (paper Sec. IV-B).

Classifies the whole-application memory behaviour into five categories —
memory-bandwidth (MBW), memory-latency (MLAT), cache-bandwidth (CBW),
cache-latency (CLAT) and Compute — each weighted in [0, 1] with all weights
summing to 1.  Metrics come from the PAPI counter analog (``CounterSet``).

The PyTorch counterpart of ``repro.core.characterization``.  The weights are
tensors: 0-d float64 in the scalar per-call path, ``(n_scenarios, 1)`` (or
``(n_scenarios, n_calls)`` when the counters are per-call columns) in the
sweep, on whatever device and in whatever float dtype the swept parameters
live.  Python-scalar operands of ``clamp`` / ``maximum`` / ``where`` are
lifted with :func:`as_float` onto the device and dtype of the tensors they
meet, float64 when they meet none (``torch.as_tensor(0.5)`` alone would be
float32, and ``torch.maximum`` takes no scalar operand).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from .params import CACHE_LINE_BYTES, ModelParams
from .traces import CounterSet


class Category(enum.Enum):
    MBW = "mbw"
    MLAT = "mlat"
    CBW = "cbw"
    CLAT = "clat"
    COMPUTE = "compute"


#: Categories considered for the *first* load of freshly received data
#: (Sec. IV-B2 case 1): a guaranteed memory/CXL read, so cache categories
#: are not relevant.
FIRST_LOAD_CATEGORIES = (Category.MBW, Category.MLAT, Category.COMPUTE)
ALL_CATEGORIES = tuple(Category)


def as_float(*xs) -> tuple:
    """Each operand as a tensor on the device and in the float dtype of the
    first floating tensor among them (float64 on the CPU when there is
    none: the scalar path)."""
    first = next((x for x in xs if isinstance(x, torch.Tensor)
                  and x.is_floating_point()), None)
    dev = first.device if first is not None else torch.device("cpu")
    dtype = first.dtype if first is not None else torch.float64
    return tuple(torch.as_tensor(x, dtype=dtype, device=dev) for x in xs)


def _at_least(x, lo: float):
    """``max(x, lo)`` for a Python number, elementwise for a tensor or a
    NumPy array (per-call counters of a multi-bundle sweep)."""
    if isinstance(x, torch.Tensor):
        return x.clamp(min=lo)
    if isinstance(x, np.ndarray):
        return np.maximum(x, lo)
    return max(x, lo)


def quadratic_weight(val, lower, upper) -> torch.Tensor:
    """Paper Eq. 3: 0 below ``lower``, 1 above ``upper``, quadratic between.

    Operands may be Python numbers or float tensors (broadcasting); the
    result is a tensor in the tensors' dtype (float64 for numbers alone).
    """
    val, lower, upper = as_float(val, lower, upper)
    t = ((val - lower) / (upper - lower)).clamp(0.0, 1.0)
    return t * t


@dataclass(frozen=True)
class Metrics:
    """Raw characterization metrics derived from counters."""

    mem_throughput_frac: object   # achieved DRAM BW / peak DRAM BW
    l3_miss_frac: object          # L3 LD misses / all LDs
    l1_throughput_frac: object    # L1 load throughput / L1 BW
    l2_throughput_frac: object    # L2 fill throughput / L2 BW
    l2_reach_frac: object         # LDs that reach L2 / all LDs

    @staticmethod
    def from_counters(c: CounterSet, p: ModelParams) -> "Metrics":
        """Map PAPI counters to the five metrics (Sec. IV-B1).

        * MBW: average on-socket memory throughput — IMC read lines x 64 B
          over wall time, as a fraction of the benchmarked peak.
        * MLAT: PAPI_L3_LDM / PAPI_LD_INS.
        * CBW: L1 load throughput (LD_INS x avg load width) and L2 fill
          throughput (L1_LDM x line) as fractions of the respective cache BW.
        * CLAT: fraction of LDs that reach L2 = PAPI_L1_LDM / PAPI_LD_INS.

        The counters are Python numbers (one run) or per-call tensors (a
        multi-bundle sweep); ``p``'s fields are Python numbers (scalar
        path) or tensors (sweep), and every expression is elementwise, so
        all of them flow through identically.
        """
        wall = _at_least(c.wall_time_ns, 1e-9)
        lds = _at_least(c.ld_ins, 1.0)
        mem_bytes = c.imc_reads * CACHE_LINE_BYTES
        return Metrics(
            mem_throughput_frac=(mem_bytes / wall) / p.peak_mem_bw_Bpns,
            l3_miss_frac=c.l3_ldm / lds,
            l1_throughput_frac=(c.ld_ins * p.avg_load_bytes / wall) / p.l1_bw_Bpns,
            l2_throughput_frac=(c.l1_ldm * CACHE_LINE_BYTES / wall) / p.l2_bw_Bpns,
            l2_reach_frac=c.l1_ldm / lds,
        )


def raw_weights(m: Metrics, p: ModelParams) -> dict:
    """Threshold-ramped weights with the paper's subtraction rules applied.

    MLAT deducts MBW (Sec. IV-B1); CLAT deducts MBW + MLAT + CBW (Eq. 4);
    both clamp at 0.  CBW is the max of the L1 and L2 ramps.  All math is
    elementwise, so metric/threshold tensors (one entry per sweep scenario)
    flow through unchanged.
    """
    w_mbw = quadratic_weight(m.mem_throughput_frac, p.thr_mbw.lower,
                             p.thr_mbw.upper)
    w_mlat = quadratic_weight(m.l3_miss_frac, p.thr_mlat.lower,
                              p.thr_mlat.upper)
    w_mlat = (w_mlat - w_mbw).clamp(min=0.0)
    w_cbw = torch.maximum(
        quadratic_weight(m.l1_throughput_frac, p.thr_cbw.lower,
                         p.thr_cbw.upper),
        quadratic_weight(m.l2_throughput_frac, p.thr_cbw.lower,
                         p.thr_cbw.upper))
    w_clat = quadratic_weight(m.l2_reach_frac, p.thr_clat.lower,
                              p.thr_clat.upper)
    w_clat = (w_clat - (w_mbw + w_mlat + w_cbw)).clamp(min=0.0)
    return {Category.MBW: w_mbw, Category.MLAT: w_mlat,
            Category.CBW: w_cbw, Category.CLAT: w_clat}


def normalize(weights: dict, p: ModelParams,
              categories=ALL_CATEGORIES) -> dict:
    """Normalize to sum 1 with the Compute remainder rule (footnote 17).

    If the non-Compute weights sum to less than 1, Compute takes the
    remainder up to ``compute_max_weight``; any excess is split equally
    among the other categories.  If they sum to more than 1, each is
    divided by the sum (Compute = 0).
    """
    cats = [c for c in categories if c is not Category.COMPUTE]
    vals = as_float(*(weights.get(c, 0.0) for c in cats))
    w = {c: v.clamp(min=0.0) for c, v in zip(cats, vals)}
    s = sum(w.values())
    over = s >= 1.0
    safe = torch.where(over, s, torch.ones_like(s))  # no 0/0 in the dead branch
    rem = (1.0 - s).clamp(min=0.0)
    rem, cap = as_float(rem, p.compute_max_weight)
    compute = torch.where(over, torch.zeros_like(s), torch.minimum(rem, cap))
    excess = rem - compute
    out = {c: torch.where(over, w[c] / safe, w[c] + excess / len(cats))
           for c in cats}
    out[Category.COMPUTE] = compute
    # make absent categories explicit zeros
    for c in ALL_CATEGORIES:
        out.setdefault(c, 0.0)
    return out


@dataclass(frozen=True)
class Characterization:
    """The two normalized weight sets of Sec. IV-B2."""

    first: dict       # Category -> weight; only MBW/MLAT/Compute non-zero
    subsequent: dict  # Category -> weight; all five categories
    metrics: Metrics

    @staticmethod
    def from_counters(c: CounterSet, p: ModelParams) -> "Characterization":
        m = Metrics.from_counters(c, p)
        raw = raw_weights(m, p)
        first = normalize({k: v for k, v in raw.items()
                           if k in FIRST_LOAD_CATEGORIES}, p,
                          categories=FIRST_LOAD_CATEGORIES)
        subsequent = normalize(raw, p, categories=ALL_CATEGORIES)
        return Characterization(first=first, subsequent=subsequent, metrics=m)

    def blended(self, accesses_per_element: float) -> dict:
        """1/n first-load + (n-1)/n subsequent-load blend (Sec. IV-B2)."""
        n = max(1.0, accesses_per_element)
        f = 1.0 / n
        return {c: f * self.first.get(c, 0.0)
                + (1.0 - f) * self.subsequent.get(c, 0.0)
                for c in ALL_CATEGORIES}
