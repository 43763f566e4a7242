"""Scenario-sweep engine: grids, bundle compilation, and result views.

The counterpart of ``repro.core.sweep``.  A ``TraceBundle`` is compiled ONCE
into packed flat arrays, and an entire grid of scenarios is priced through
the backend-pluggable executors of ``sweep_kernel``:

    cb     = compile_bundle(bundle)
    grid   = ParamGrid.sample(ModelParams.multinode(), 262144, seed=0,
                              cxl_lat_ns=(250, 700),
                              cxl_atomic_lat_ns=(300, 800))
    result = price(cb, grid)                          # fused kernel, CUDA
    result = price(cb, grid, plan=ExecPlan("torch"))  # unfused, CUDA
    result = price(cb, grid, plan="numpy")            # the host
    result.predicted_speedup()                        # per-scenario view

    multi = price([cb_a, cb_b], grid)                 # MANY bundles, ONE pass
    multi["bundle1"].predicted_speedup()              # per-bundle SweepResult
    multi.predicted_speedup(weights={"bundle1": 8})   # deployment-level mix

Division of labour, as in the reference:

  * THIS module owns the data model — ``ParamGrid`` (factorial
    :meth:`ParamGrid.product`, Latin-hypercube / uniform
    :meth:`ParamGrid.sample`, paired :meth:`ParamGrid.zip`, union
    :meth:`ParamGrid.concat`, numeric axes over any ``ModelParams`` field
    plus the categorical ``mpi_transfer=`` / ``free_transfer=`` axes),
    ``compile_bundle`` / ``CompiledBundle`` / ``concat_bundles``, the
    results (``SweepResult``, ``MultiSweepResult``, ``TopKSweepResult``)
    and the execution cores ``_sweep_plan`` / ``_sweep_plan_many`` that
    ``price`` drives.  The array-backed ``ArraySet`` and the streaming
    executor live in ``adaptive``.
  * ``execplan`` owns HOW a sweep executes (``ExecPlan``, the backend
    registry).
  * ``sweep_kernel.price_grid`` owns the evaluation.

Scenario sets and views are built on the host with NumPy (the scenario
draws use ``np.random.default_rng``, so a grid is identical to the
reference's for the same seed); ``_ParamArrays.to`` moves a view to the
pricing device in the plan's float dtype.  Results come back to the host
as float64 NumPy matrices.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from ..kernels.sweep_bracket import csr_group
from .access import SampleArrays, prefetch_hit_fraction
from .execplan import ExecPlan, is_streaming, resolve_backend
from .params import ModelParams, Thresholds
from .predictor import CallPrediction
from .sweep_kernel import MATRIX_FIELDS, SPEEDUP_HIST_EDGES
from .traces import CounterSet, TraceBundle
from .transfer import TRANSFER_MODELS, SiteTraffic


# --------------------------------------------------------------------------
# Parameter grids
# --------------------------------------------------------------------------

#: Categorical grid axes (not ``ModelParams`` fields): axis name -> the
#: default transfer-model name used when the axis is not swept.  Values must
#: be keys of ``transfer.TRANSFER_MODELS``.
CATEGORICAL_AXES = {"mpi_transfer": "hockney",
                    "free_transfer": "message_free"}


class _ThresholdView:
    """lower/upper pairs stacked across scenarios (no Thresholds validation —
    arrays have no single truth value)."""

    def __init__(self, lower, upper):
        self.lower = lower
        self.upper = upper


class _ParamArrays:
    """Duck-typed ``ModelParams`` whose every field is an ``(S, 1)`` array.

    The characterization / access / transfer code only does arithmetic on
    the fields, so this view flows through the exact same functions the
    scalar path uses.  On top of the numeric fields it carries the
    categorical transfer-model axes: per side a tuple of candidate models
    (each built from these same ``(S, 1)`` fields) and an ``(S, 1)``
    integer code selecting one candidate per scenario.

    Built on the host with NumPy arrays — from ``ModelParams`` points, or
    from columns with :meth:`from_columns`; :meth:`to` gives the same view
    with float / int32 tensors on a device.
    """

    def __init__(self, params, cat=None):
        for f in dataclasses.fields(ModelParams):
            vals = [getattr(p, f.name) for p in params]
            if isinstance(vals[0], Thresholds):
                setattr(self, f.name, _ThresholdView(
                    np.array([t.lower for t in vals])[:, None],
                    np.array([t.upper for t in vals])[:, None]))
            else:
                setattr(self, f.name, np.array(vals, dtype=np.float64)[:, None])
        cat = cat or {}
        for axis, default in CATEGORICAL_AXES.items():
            names = cat.get(axis) or (default,) * len(params)
            cands = tuple(dict.fromkeys(names))   # order of first appearance
            idx = {n: k for k, n in enumerate(cands)}
            code = np.array([idx[n] for n in names], dtype=np.int32)[:, None]
            setattr(self, axis + "_code", code)
            setattr(self, axis + "_models",
                    tuple(TRANSFER_MODELS[n](self) for n in cands))

    @classmethod
    def from_columns(cls, base: ModelParams, n: int, columns,
                     cat=None) -> "_ParamArrays":
        """A view over ``n`` scenarios from COLUMN ARRAYS instead of ``n``
        ``ModelParams`` instances (what :class:`~repro_torch.core.adaptive.
        ArraySet` builds).

        Varied numeric fields come from ``columns`` (``{field: (n,)
        array}``) as ``(n, 1)``; every other field broadcasts from ``base``
        as ``(1, 1)``.  ``cat`` maps a categorical axis to ``(codes,
        choices)``: an ``(n,)`` integer column into the static ``choices``
        tuple.  ``mem_lat_ns`` is always full length: it carries the
        scenario count that ``_slice`` and ``_pad`` read.
        """
        self = object.__new__(cls)
        for f in dataclasses.fields(ModelParams):
            v = getattr(base, f.name)
            if f.name in columns:
                col = np.asarray(columns[f.name], dtype=np.float64)
                setattr(self, f.name, col.reshape(n, 1))
            elif isinstance(v, Thresholds):
                setattr(self, f.name, _ThresholdView(
                    np.array([[v.lower]], dtype=np.float64),
                    np.array([[v.upper]], dtype=np.float64)))
            else:
                setattr(self, f.name, np.array([[v]], dtype=np.float64))
        if self.mem_lat_ns.shape[0] != n:
            self.mem_lat_ns = np.full((n, 1), float(base.mem_lat_ns))
        cat = cat or {}
        for axis, default in CATEGORICAL_AXES.items():
            if axis in cat:
                codes, choices = cat[axis]
                code = np.asarray(codes, dtype=np.int32).reshape(n, 1)
                choices = tuple(choices)
            else:
                code, choices = np.zeros((1, 1), dtype=np.int32), (default,)
            setattr(self, axis + "_code", code)
            setattr(self, axis + "_models",
                    tuple(TRANSFER_MODELS[nm](self) for nm in choices))
        return self

    def _map(self, fn) -> "_ParamArrays":
        out = object.__new__(_ParamArrays)
        out.__dict__.update(
            {k: _map_leaves(v, fn) for k, v in self.__dict__.items()})
        return out

    def _slice(self, sl: slice) -> "_ParamArrays":
        """The scenarios ``sl`` (arrays without the scenario axis pass)."""
        n = self.mem_lat_ns.shape[0]
        return self._map(lambda a: a[sl] if a.ndim >= 1 and a.shape[0] == n
                         else a)

    def _pad(self, n_pad: int) -> "_ParamArrays":
        """Edge-pad every host leaf that carries the scenario axis up to
        ``n_pad`` scenarios: the padded rows are copies of the last
        scenario, which the streaming executor masks out of every
        reduction."""
        n = self.mem_lat_ns.shape[0]
        if n_pad <= n:
            return self
        if n == 0:
            raise ValueError("cannot pad an empty view (0 scenarios)")
        return self._map(lambda a: pad_to_multiple(a, n_pad)
                         if a.ndim >= 1 and a.shape[0] == n else a)

    def to(self, device, dtype=torch.float64) -> "_ParamArrays":
        """The view with every array leaf as a tensor on ``device``: float
        fields in ``dtype``, the int32 codes as they are.  A leaf shared by
        several fields — a transfer model's field is the view's own array —
        is copied once."""
        device = torch.device(device)
        memo = {}

        def move(a):
            key = id(a)
            if key not in memo:
                floating = a.dtype.is_floating_point \
                    if isinstance(a, torch.Tensor) else a.dtype.kind == "f"
                memo[key] = (a, torch.as_tensor(
                    a, device=device, dtype=dtype if floating else None))
            return memo[key][1]

        return self._map(move)


def padded_size(n: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` that holds ``n`` rows (minimum
    one row per shard, so a shard is never zero-sized)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return max(1, -(-n // n_shards)) * n_shards


def pad_to_multiple(a, n_pad: int, axis: int = 0):
    """Edge-pad ``a`` along ``axis`` up to ``n_pad`` rows (no-op when
    already long enough).  Edge mode keeps padding rows finite and
    physically plausible, so masked lanes never poison a reduction with
    NaN or inf."""
    a = np.asarray(a)
    k = n_pad - a.shape[axis]
    if k <= 0:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, k)
    return np.pad(a, pad, mode="edge")


def _map_leaves(val, fn):
    """Apply ``fn`` to every array leaf of a view component: arrays and
    tensors, threshold views, candidate-model tuples, and transfer models
    whose fields are arrays.  Scalars (e.g. an explicit override model with
    float fields) pass through."""
    if isinstance(val, (np.ndarray, torch.Tensor)):
        return fn(val)
    if isinstance(val, _ThresholdView):
        return _ThresholdView(_map_leaves(val.lower, fn),
                              _map_leaves(val.upper, fn))
    if isinstance(val, tuple):
        return tuple(_map_leaves(v, fn) for v in val)
    if dataclasses.is_dataclass(val) and not isinstance(val, type):
        return dataclasses.replace(val, **{
            f.name: _map_leaves(getattr(val, f.name), fn)
            for f in dataclasses.fields(val)})
    return val


@runtime_checkable
class ScenarioSet(Protocol):
    """What the pricing engine needs from a scenario source:
    ``__len__()`` (the scenario count ``S``), ``view()`` (the host
    ``(S, 1)``-array parameter view, supporting ``._slice`` and ``.to``)
    and ``labels()`` (one dict per scenario naming the varied axes)."""

    def __len__(self) -> int: ...

    def view(self): ...

    def labels(self) -> list: ...


def _axis_values(name: str, vals, valid) -> list:
    """Normalize + validate one grid-axis value list: unknown fields and
    EMPTY axes raise immediately."""
    if name not in valid and name not in CATEGORICAL_AXES:
        raise ValueError(f"unknown ModelParams field: {name!r}")
    vals = list(vals)
    if not vals:
        raise ValueError(f"empty axis {name!r}: it would yield a "
                         "0-scenario grid; drop the axis or give it values")
    if name in CATEGORICAL_AXES:
        for v in vals:
            if v not in TRANSFER_MODELS:
                raise ValueError(
                    f"unknown transfer model {v!r} for axis {name!r}; "
                    f"known: {sorted(TRANSFER_MODELS)}")
    return vals


@dataclass(frozen=True)
class ParamGrid:
    """An ordered collection of scenarios (``ModelParams`` points) — the
    canonical :class:`ScenarioSet`.

    ``axes`` records the varied fields when built via :meth:`product`;
    ``cat`` holds the per-scenario assignment of each categorical axis;
    ``rows`` holds explicit per-scenario labels for the non-factorial
    constructors (:meth:`sample` / :meth:`zip` / :meth:`concat`).
    """

    params: tuple
    axes: tuple = ()          # ((axis_name, (values...)), ...)
    cat: tuple = ()           # ((axis_name, (per-scenario name, ...)), ...)
    rows: tuple = ()          # per-scenario ((axis_name, value), ...) pairs
    ranges: tuple = ()        # ((axis, (lo, hi) | (choices...)), ...) from
    #                           sample()

    @staticmethod
    def from_params(params) -> "ParamGrid":
        return ParamGrid(params=tuple(params))

    @staticmethod
    def product(base: ModelParams | None = None, **axes) -> "ParamGrid":
        """Cartesian grid over ``ModelParams`` fields and the categorical
        transfer-model axes.  Later axes vary fastest (C order)."""
        base = base or ModelParams()
        valid = {f.name for f in dataclasses.fields(ModelParams)}
        cols = {n: _axis_values(n, v, valid) for n, v in axes.items()}
        cat_names = [n for n in cols if n in CATEGORICAL_AXES]
        points, cat_cols = [], {n: [] for n in cat_names}
        for combo in itertools.product(*cols.values()):
            d = dict(zip(cols, combo))
            for n in cat_names:
                cat_cols[n].append(d.pop(n))
            points.append(base.replace(**d))
        return ParamGrid(params=tuple(points),
                         axes=tuple((n, tuple(v)) for n, v in cols.items()),
                         cat=tuple((n, tuple(cat_cols[n]))
                                   for n in cat_names))

    @staticmethod
    def sample(base: ModelParams | None = None, n: int = 16, *,
               seed: int = 0, method: str = "lhs",
               **ranges) -> "ParamGrid":
        """``n`` scenarios sampled from axis RANGES: numeric axes take a
        ``(lo, hi)`` pair, categorical axes a list of model names.
        ``method="lhs"`` (default) stratifies each axis Latin-hypercube
        style, ``"uniform"`` draws i.i.d.  The draws come from
        ``np.random.default_rng(seed)`` in the reference's order, so the
        scenarios are identical to ``repro.core.ParamGrid.sample``'s."""
        base = base or ModelParams()
        if n < 1:
            raise ValueError(f"sample needs n >= 1, got {n}")
        if method not in ("lhs", "uniform"):
            raise ValueError(f"unknown sample method {method!r}; "
                             "use 'lhs' or 'uniform'")
        if not ranges:
            raise ValueError("sample needs at least one axis range")
        valid = {f.name for f in dataclasses.fields(ModelParams)}
        rng = np.random.default_rng(seed)
        num_cols, cat_cols = {}, {}
        for name, spec in ranges.items():
            vals = _axis_values(name, spec, valid)
            if name in CATEGORICAL_AXES:
                if method == "lhs":     # near-even coverage, then shuffled
                    idx = np.tile(np.arange(len(vals)),
                                  -(-n // len(vals)))[:n]
                    rng.shuffle(idx)
                else:
                    idx = rng.integers(0, len(vals), size=n)
                cat_cols[name] = [vals[int(k)] for k in idx]
                continue
            if len(vals) != 2:
                raise ValueError(f"axis {name!r}: numeric sample ranges "
                                 f"are (lo, hi) pairs, got {spec!r}")
            lo, hi = float(vals[0]), float(vals[1])
            if not hi >= lo:
                raise ValueError(f"axis {name!r}: lo ({lo}) must not "
                                 f"exceed hi ({hi})")
            if method == "lhs":         # one draw per 1/n stratum, permuted
                u = (rng.permutation(n) + rng.uniform(size=n)) / n
            else:
                u = rng.uniform(size=n)
            num_cols[name] = lo + u * (hi - lo)
        points, rows = [], []
        for i in range(n):
            d = {k: float(col[i]) for k, col in num_cols.items()}
            points.append(base.replace(**d))
            lab = dict(d)
            lab.update({k: col[i] for k, col in cat_cols.items()})
            rows.append(tuple(lab.items()))
        recorded = tuple(
            (name, (float(spec[0]), float(spec[1]))
             if name not in CATEGORICAL_AXES else tuple(spec))
            for name, spec in ranges.items())
        return ParamGrid(params=tuple(points),
                         cat=tuple((k, tuple(col))
                                   for k, col in cat_cols.items()),
                         rows=tuple(rows), ranges=recorded)

    @staticmethod
    def zip(base: ModelParams | None = None, **axes) -> "ParamGrid":
        """PAIRED axes: scenario ``i`` takes element ``i`` of every axis
        (all axes must share one length)."""
        base = base or ModelParams()
        if not axes:
            raise ValueError("zip needs at least one axis")
        valid = {f.name for f in dataclasses.fields(ModelParams)}
        cols = {n: _axis_values(n, v, valid) for n, v in axes.items()}
        lengths = {n: len(v) for n, v in cols.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"zip axes must share one length, got "
                             f"{lengths}")
        length = next(iter(lengths.values()))
        cat_names = [n for n in cols if n in CATEGORICAL_AXES]
        points, rows = [], []
        for i in range(length):
            d = {n: cols[n][i] for n in cols}
            lab = dict(d)
            for cn in cat_names:
                d.pop(cn)
            points.append(base.replace(**d))
            rows.append(tuple(lab.items()))
        return ParamGrid(params=tuple(points),
                         cat=tuple((cn, tuple(cols[cn]))
                                   for cn in cat_names),
                         rows=tuple(rows))

    @staticmethod
    def concat(*grids) -> "ParamGrid":
        """Union of scenario sets, back-to-back in order.  Grids that do not
        sweep a union categorical axis are filled with its default."""
        if len(grids) == 1 and not isinstance(grids[0], ParamGrid):
            grids = tuple(grids[0])             # concat(iterable_of_grids)
        if not grids:
            raise ValueError("concat needs at least one grid")
        cat_names = []
        for g in grids:
            for name, _ in g.cat:
                if name not in cat_names:
                    cat_names.append(name)
        cat = []
        for name in cat_names:
            col = []
            for g in grids:
                per = dict(g.cat).get(name)
                col.extend(per if per is not None
                           else (CATEGORICAL_AXES[name],) * len(g))
            cat.append((name, tuple(col)))
        rows = []
        for g in grids:
            filled = {name: CATEGORICAL_AXES[name] for name in cat_names
                      if name not in dict(g.cat)}
            rows.extend(tuple({**filled, **lab}.items())
                        for lab in g.labels())
        return ParamGrid(params=tuple(p for g in grids for p in g.params),
                         cat=tuple(cat), rows=tuple(rows))

    @property
    def shape(self) -> tuple:
        return tuple(len(v) for _, v in self.axes) if self.axes \
            else (len(self.params),)

    def labels(self) -> list:
        """Per-scenario dict of the varied axes (empty dicts for a bare
        ``from_params`` collection)."""
        if self.rows:
            return [dict(r) for r in self.rows]
        if not self.axes:
            return [{} for _ in self.params]
        names = [n for n, _ in self.axes]
        return [dict(zip(names, combo)) for combo in
                itertools.product(*(v for _, v in self.axes))]

    def label_at(self, i: int) -> dict:
        """``labels()[i]`` without materializing all ``S`` label dicts."""
        if self.rows:
            return dict(self.rows[i])
        if not self.axes:
            return {}
        names = [n for n, _ in self.axes]
        vals, rem = [], int(i)
        for _, axis_vals in reversed(self.axes):     # later axes fastest
            rem, j = divmod(rem, len(axis_vals))
            vals.append(axis_vals[j])
        return dict(zip(names, reversed(vals)))

    def subset(self, indices) -> "ParamGrid":
        """The scenarios at ``indices``, in that order, as a new row-labeled
        grid."""
        idx = [int(i) for i in np.asarray(indices).ravel()]
        return ParamGrid(
            params=tuple(self.params[i] for i in idx),
            cat=tuple((name, tuple(col[i] for i in idx))
                      for name, col in self.cat),
            rows=tuple(tuple(self.label_at(i).items()) for i in idx),
            ranges=self.ranges)

    def refine(self, points, n: int, *, seed: int = 0,
               shrink: float = 0.25):
        """``n`` new scenarios re-sampled around ``points`` (label dicts,
        e.g. ``[grid.label_at(i) for i in frontier]``) within the ranges
        recorded by :meth:`sample`, as an array-backed
        :class:`~repro_torch.core.adaptive.ArraySet` (see
        ``ArraySet.refine``)."""
        from .adaptive import as_array_set
        return as_array_set(self).refine(points, n, seed=seed,
                                         shrink=shrink)

    def view(self) -> _ParamArrays:
        return _ParamArrays(self.params, dict(self.cat))

    def __len__(self) -> int:
        return len(self.params)


# --------------------------------------------------------------------------
# Bundle compilation: TraceBundle -> packed flat arrays
# --------------------------------------------------------------------------

def _pack_group(per_site_lat, per_site_w):
    """Concatenate per-site sample vectors; return (lat, w, starts, counts)."""
    counts = np.array([len(v) for v in per_site_lat], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]) if len(counts) \
        else np.zeros(0, np.int64)
    lat = np.concatenate(per_site_lat) if per_site_lat else np.zeros(0)
    w = np.concatenate(per_site_w) if per_site_w else np.zeros(0)
    return lat, w, starts.astype(np.int64), counts


_GROUPS = ("hit", "lfb", "miss")
#: Per-site (n_calls,) float64 columns uploaded by ``CompiledBundle.tensors``.
_SITE_COLUMNS = ("hit_wl_sum", "lfb_wl_sum", "miss_w_sum", "total_wl",
                 "accesses_per_element", "prefetch_frac")


@dataclass(frozen=True)
class BundleTensors:
    """A compiled bundle's constants on one device (see
    :meth:`CompiledBundle.tensors`)."""

    hit_lat: torch.Tensor; hit_w: torch.Tensor; hit_seg: torch.Tensor
    lfb_lat: torch.Tensor; lfb_w: torch.Tensor; lfb_seg: torch.Tensor
    miss_lat: torch.Tensor; miss_w: torch.Tensor; miss_seg: torch.Tensor
    hit_wl_sum: torch.Tensor
    lfb_wl_sum: torch.Tensor
    miss_w_sum: torch.Tensor
    total_wl: torch.Tensor
    accesses_per_element: torch.Tensor
    prefetch_frac: torch.Tensor
    unpack: torch.Tensor        # bool
    traffic: SiteTraffic        # fields are (n_calls,) tensors
    groups: dict                # "hit" | "lfb" | "miss" -> ops.CsrGroup
    counters: CounterSet        # the bundle's; per-call arrays as tensors
    sampling_period: object     # float, or an (n_calls,) tensor


@dataclass(frozen=True)
class CompiledBundle:
    """A ``TraceBundle`` lowered to flat arrays, scenario-independent parts
    pre-reduced.  Compile once, sweep many.

    Each packed sample group carries both segmentation encodings: starts /
    counts for the reduceat-based host executor and per-sample segment ids
    (``*_seg``) for the scatter-style and kernel executors.
    """

    call_ids: tuple
    # packed per-source-class samples (site-major, original order kept)
    hit_lat: np.ndarray; hit_w: np.ndarray
    hit_starts: np.ndarray; hit_counts: np.ndarray; hit_seg: np.ndarray
    lfb_lat: np.ndarray; lfb_w: np.ndarray
    lfb_starts: np.ndarray; lfb_counts: np.ndarray; lfb_seg: np.ndarray
    miss_lat: np.ndarray; miss_w: np.ndarray
    miss_starts: np.ndarray; miss_counts: np.ndarray; miss_seg: np.ndarray
    # scenario-independent per-site reductions, all shape (n_calls,)
    hit_wl_sum: np.ndarray      # Σ w·lat over cache hits
    lfb_wl_sum: np.ndarray      # Σ w·lat over LFB
    miss_w_sum: np.ndarray      # Σ w over DRAM misses
    total_wl: np.ndarray        # Σ w·lat over ALL samples (Eq. 5)
    # per-site comm aggregates / metadata
    traffic: SiteTraffic        # fields are (n_calls,) arrays
    buffer_bytes: np.ndarray
    accesses_per_element: np.ndarray
    prefetch_frac: np.ndarray
    unpack: np.ndarray          # bool
    counters: object            # CounterSet: whole-run numbers, or per-call
    #                             (n_calls,) arrays in a super-bundle
    sampling_period: object     # float, or (n_calls,) in a super-bundle
    baseline_runtime_ns: float

    @property
    def n_calls(self) -> int:
        return len(self.call_ids)

    def _cache(self, name: str) -> dict:
        cache = self.__dict__.get(name)
        if cache is None:
            cache = {}
            object.__setattr__(self, name, cache)
        return cache

    def padded_groups(self, multiple: int = 128) -> dict:
        """The packed sample groups in one shared zero-padded length (a
        multiple of ``multiple``): ``{"hit" | "lfb" | "miss": (lat, w,
        seg)}``.  Padding rows carry ``w == 0`` (they contribute exactly
        zero to every bracket) and ``seg == 0``.  Cached per ``multiple``.
        The fused kernel does not need the padding; the layout is kept for
        callers of the reference's contract."""
        cache = self._cache("_padded_groups")
        out = cache.get(multiple)
        if out is None:
            n = max(len(self.hit_lat), len(self.lfb_lat),
                    len(self.miss_lat), 1)
            n_pad = -(-n // multiple) * multiple

            def pad(grp):
                lat = getattr(self, grp + "_lat")
                w = getattr(self, grp + "_w")
                seg = getattr(self, grp + "_seg")
                k = n_pad - len(lat)
                return (np.pad(lat, (0, k)), np.pad(w, (0, k)),
                        np.pad(seg, (0, k)).astype(np.int32))

            out = {grp: pad(grp) for grp in _GROUPS}
            cache[multiple] = out
        return out

    def tensors(self, device, dtype=torch.float64) -> BundleTensors:
        """The bundle's arrays as tensors on ``device`` — uploaded once per
        (device, dtype) and cached on the bundle, so pricing many grids
        uploads the bundle once.  Includes each sample group in the fused
        kernel's CSR form (offsets, and a stable permutation only where the
        ids are unsorted).  Counters and the sampling period stay Python
        numbers where they are scalars; the per-call arrays of a
        :func:`concat_bundles` super-bundle come as tensors."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        cache = self._cache("_tensors")
        key = (device, dtype)
        out = cache.get(key)
        if out is None:
            f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                          device=device)
            kw = {}
            for grp in _GROUPS:
                kw[grp + "_lat"] = f(getattr(self, grp + "_lat"))
                kw[grp + "_w"] = f(getattr(self, grp + "_w"))
                kw[grp + "_seg"] = torch.as_tensor(
                    getattr(self, grp + "_seg"), dtype=torch.long,
                    device=device)
            kw.update({k: f(getattr(self, k)) for k in _SITE_COLUMNS})
            kw["unpack"] = torch.as_tensor(self.unpack, dtype=torch.bool,
                                           device=device)
            kw["traffic"] = SiteTraffic(
                n_msgs=f(self.traffic.n_msgs),
                total_bytes=f(self.traffic.total_bytes),
                gap_bytes=f(self.traffic.gap_bytes))
            kw["groups"] = {
                grp: csr_group(kw[grp + "_lat"], kw[grp + "_w"],
                               kw[grp + "_seg"], self.n_calls)
                for grp in _GROUPS}
            per_call = lambda v: f(v) if isinstance(v, np.ndarray) else v
            kw["counters"] = dataclasses.replace(self.counters, **{
                fld.name: per_call(getattr(self.counters, fld.name))
                for fld in dataclasses.fields(self.counters)})
            kw["sampling_period"] = per_call(self.sampling_period)
            out = BundleTensors(**kw)
            cache[key] = out
        return out


def _compiled(call_ids, groups, site, traffic, counters, sampling_period,
              baseline_runtime_ns) -> CompiledBundle:
    """Assemble a ``CompiledBundle`` from packed ``(lat, w, starts, counts)``
    groups and per-site columns (segment ids derived from the counts)."""
    seg = lambda counts: np.repeat(np.arange(len(counts), dtype=np.int32),
                                   counts)
    kw = {}
    for grp, (lat, w, starts, counts) in groups.items():
        kw.update({grp + "_lat": lat, grp + "_w": w, grp + "_starts": starts,
                   grp + "_counts": counts, grp + "_seg": seg(counts)})
    return CompiledBundle(call_ids=tuple(call_ids), **kw, **site,
                          traffic=traffic, counters=counters,
                          sampling_period=sampling_period,
                          baseline_runtime_ns=baseline_runtime_ns)


def compile_bundle(bundle: TraceBundle) -> CompiledBundle:
    """Lower a bundle to packed arrays (site order = dict insertion order,
    matching ``predict_run``)."""
    call_ids, groups = [], {g: ([], []) for g in _GROUPS}
    cols = {k: [] for k in ("hit_wl_sum", "lfb_wl_sum", "miss_w_sum",
                            "total_wl", "buffer_bytes",
                            "accesses_per_element", "prefetch_frac",
                            "unpack")}
    n_msgs, total_bytes, gap_bytes = [], [], []

    for cid, site in bundle.call_sites.items():
        call_ids.append(cid)
        a = SampleArrays.of(site.samples)
        lat, w = a.lat.numpy(), a.weight.numpy()
        masks = {"hit": a.is_hit.numpy(), "lfb": a.is_lfb.numpy(),
                 "miss": a.is_miss.numpy()}
        for key, mask in masks.items():
            groups[key][0].append(lat[mask])
            groups[key][1].append(w[mask])
        h, l, m = masks["hit"], masks["lfb"], masks["miss"]
        cols["hit_wl_sum"].append(float(np.sum(w[h] * lat[h])))
        cols["lfb_wl_sum"].append(float(np.sum(w[l] * lat[l])))
        cols["miss_w_sum"].append(float(np.sum(w[m])))
        cols["total_wl"].append(float(np.sum(w * lat)))
        t = SiteTraffic.of(site)
        n_msgs.append(t.n_msgs)
        total_bytes.append(t.total_bytes)
        gap_bytes.append(t.gap_bytes)
        cols["buffer_bytes"].append(
            max((c.bytes for c in site.comms), default=0))
        cols["accesses_per_element"].append(site.accesses_per_element)
        cols["prefetch_frac"].append(prefetch_hit_fraction(site))
        cols["unpack"].append(bool(site.unpack))

    arr = lambda v: np.asarray(v, dtype=np.float64)
    site = {k: arr(v) for k, v in cols.items() if k != "unpack"}
    site["unpack"] = np.asarray(cols["unpack"], dtype=bool)
    return _compiled(
        call_ids, {g: _pack_group(*groups[g]) for g in _GROUPS}, site,
        SiteTraffic(n_msgs=arr(n_msgs), total_bytes=arr(total_bytes),
                    gap_bytes=arr(gap_bytes)),
        bundle.counters, bundle.sampling_period,
        bundle.counters.wall_time_ns)


def compiled_bundle_from_arrays(fields: dict, *, counters: CounterSet,
                                sampling_period: float,
                                call_ids) -> CompiledBundle:
    """Build the port's ``CompiledBundle`` from another compiled bundle's
    NumPy fields — e.g. those of a ``repro.core.CompiledBundle`` — so both
    packages can price one identical compiled bundle.

    ``fields`` holds ``<grp>_lat`` / ``<grp>_w`` / ``<grp>_counts`` for the
    ``hit`` / ``lfb`` / ``miss`` groups, the per-site columns
    (``hit_wl_sum``, ``lfb_wl_sum``, ``miss_w_sum``, ``total_wl``,
    ``buffer_bytes``, ``accesses_per_element``, ``prefetch_frac``,
    ``unpack``) and the traffic columns ``n_msgs`` / ``total_bytes`` /
    ``gap_bytes``.  Starts and segment ids are derived from the counts.
    """
    call_ids = tuple(call_ids)
    groups = {}
    for grp in _GROUPS:
        counts = np.asarray(fields[grp + "_counts"], dtype=np.int64)
        if len(counts) != len(call_ids):
            raise ValueError(f"{grp}_counts has {len(counts)} entries for "
                             f"{len(call_ids)} call-sites")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(
            np.int64) if len(counts) else np.zeros(0, np.int64)
        groups[grp] = (np.asarray(fields[grp + "_lat"], dtype=np.float64),
                       np.asarray(fields[grp + "_w"], dtype=np.float64),
                       starts, counts)
    arr = lambda k: np.asarray(fields[k], dtype=np.float64)
    site = {k: arr(k) for k in _SITE_COLUMNS + ("buffer_bytes",)}
    site["unpack"] = np.asarray(fields["unpack"], dtype=bool)
    traffic = SiteTraffic(n_msgs=arr("n_msgs"),
                          total_bytes=arr("total_bytes"),
                          gap_bytes=arr("gap_bytes"))
    return _compiled(call_ids, groups, site, traffic, counters,
                     float(sampling_period), counters.wall_time_ns)


# --------------------------------------------------------------------------
# The sweep
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SweepResult:
    """``(n_scenarios, n_calls)`` float64 component matrices + per-scenario
    views.

    Mirrors ``RunPrediction``'s three paper questions, batched:
      1. per-call verdicts        -> :attr:`gain_ns` / :meth:`beneficial_mask`
      2. where to invest first    -> :meth:`ranked_call_indices`
      3. limited CXL capacity     -> :meth:`prioritize_for_capacity`
    plus the application-level projection (:meth:`predicted_speedup`).
    """

    grid: ParamGrid
    compiled: CompiledBundle
    t_transfer_mpi_ns: np.ndarray
    t_transfer_cxl_ns: np.ndarray
    t_access_mpi_ns: np.ndarray
    t_access_cxl_ns: np.ndarray

    # -- per-call matrices ---------------------------------------------------
    @property
    def call_ids(self) -> tuple:
        return self.compiled.call_ids

    @property
    def t_mpi_ns(self) -> np.ndarray:
        return self.t_transfer_mpi_ns + self.t_access_mpi_ns

    @property
    def t_cxl_ns(self) -> np.ndarray:
        return self.t_transfer_cxl_ns + self.t_access_cxl_ns

    @property
    def gain_ns(self) -> np.ndarray:
        """Positive = switching this call to message-free saves time."""
        return self.t_mpi_ns - self.t_cxl_ns

    @property
    def speedup(self) -> np.ndarray:
        """Per-call ``t_mpi / t_cxl``.  A zero-traffic call (both times 0)
        reports 1.0; ``t_cxl == 0 < t_mpi`` reports ``inf``."""
        t_cxl, t_mpi = self.t_cxl_ns, self.t_mpi_ns
        return np.where(t_cxl > 0, t_mpi / np.where(t_cxl > 0, t_cxl, 1.0),
                        np.where(t_mpi > 0, np.inf, 1.0))

    def beneficial_mask(self) -> np.ndarray:
        return self.gain_ns > 0

    def n_beneficial(self) -> np.ndarray:
        return self.beneficial_mask().sum(axis=1)

    def ranked_call_indices(self) -> np.ndarray:
        """Per scenario, call indices sorted by descending gain (question 2)."""
        return np.argsort(-self.gain_ns, axis=1, kind="stable")

    # -- question 3: limited CXL capacity ------------------------------------
    def prioritize_for_capacity(self, capacity_bytes: int):
        """Greedy gain-per-byte knapsack per scenario (an over-budget buffer
        is skipped, later smaller ones may still fit).

        Returns ``(chosen (S, C) bool, used_bytes (S,))``.
        """
        gain = self.gain_ns
        buf = self.compiled.buffer_bytes
        gpb = gain / np.maximum(1, buf)
        S, C = gain.shape
        order = np.argsort(-gpb, axis=1, kind="stable")
        rows = np.arange(S)
        chosen = np.zeros((S, C), dtype=bool)
        used = np.zeros(S, dtype=np.float64)
        for j in range(C):
            idx = order[:, j]
            fits = (gain[rows, idx] > 0) & (used + buf[idx] <= capacity_bytes)
            chosen[rows, idx] |= fits
            used = used + np.where(fits, buf[idx], 0.0)
        return chosen, used

    # -- application-level projection ----------------------------------------
    def _selection(self, replaced=None) -> np.ndarray:
        if replaced is None:
            return np.ones(self.compiled.n_calls, dtype=bool)
        replaced = set(replaced)
        return np.array([cid in replaced for cid in self.call_ids], dtype=bool)

    def predicted_runtime_ns(self, replaced=None) -> np.ndarray:
        """(S,) baseline wall time with the selected calls swapped."""
        sel = self._selection(replaced)
        return self.compiled.baseline_runtime_ns \
            - (self.gain_ns * sel).sum(axis=1)

    def predicted_speedup(self, replaced=None) -> np.ndarray:
        """(S,) application-level speedup per scenario (empty for an empty
        grid)."""
        return self.compiled.baseline_runtime_ns \
            / self.predicted_runtime_ns(replaced)

    def best_scenario(self, replaced=None) -> int:
        if len(self.grid) == 0:
            raise ValueError("best_scenario() on an empty grid: the sweep "
                             "has 0 scenarios, so there is no argmax")
        return int(np.argmax(self.predicted_speedup(replaced)))

    def topk(self, k: int, replaced=None) -> np.ndarray:
        """Indices of the ``min(k, S)`` best scenarios by predicted
        speedup, best first, ties broken toward the LOWER index."""
        sp = self.predicted_speedup(replaced)
        order = np.lexsort((np.arange(len(sp)), -sp))
        return order[:min(int(k), len(sp))]

    # -- parity / inspection helpers ----------------------------------------
    def scenario_calls(self, i: int) -> dict:
        """Row ``i`` as ``call_id -> CallPrediction`` (scalar-path parity)."""
        cb = self.compiled
        out = {}
        for j, cid in enumerate(cb.call_ids):
            out[cid] = CallPrediction(
                call_id=cid,
                t_transfer_mpi_ns=float(self.t_transfer_mpi_ns[i, j]),
                t_transfer_cxl_ns=float(self.t_transfer_cxl_ns[i, j]),
                t_access_mpi_ns=float(self.t_access_mpi_ns[i, j]),
                t_access_cxl_ns=float(self.t_access_cxl_ns[i, j]),
                transfer_bytes=int(cb.traffic.total_bytes[j]),
                buffer_bytes=int(cb.buffer_bytes[j]))
        return out

    def summary_rows(self, replaced=None) -> list:
        """One dict per scenario: varied params (numeric AND categorical
        transfer-model axes) + aggregates."""
        speed = self.predicted_speedup(replaced)
        nben = self.n_beneficial()
        gain = np.maximum(0.0, self.gain_ns).sum(axis=1)
        rows = []
        for i, lab in enumerate(self.grid.labels()):
            rows.append({**lab,
                         "predicted_speedup": float(speed[i]),
                         "n_beneficial": int(nben[i]),
                         "total_positive_gain_us": float(gain[i]) / 1e3})
        return rows


@dataclass(frozen=True)
class SweepAggregates:
    """Exact whole-sweep reductions of a :class:`SweepResult`: speedup
    count / mean / min / max, the ``SPEEDUP_HIST_EDGES`` histogram
    (``len(edges) + 1`` bins including underflow and overflow), and
    per-call beneficial counts and summed gains."""

    count: int
    speedup_mean: float
    speedup_min: float
    speedup_max: float
    hist: np.ndarray
    n_beneficial: np.ndarray
    gain_sum: np.ndarray

    @staticmethod
    def from_result(res: SweepResult, replaced=None) -> "SweepAggregates":
        sp = res.predicted_speedup(replaced)
        hist = np.bincount(
            np.searchsorted(SPEEDUP_HIST_EDGES, sp, side="right"),
            minlength=len(SPEEDUP_HIST_EDGES) + 1).astype(np.int64)
        gain = res.gain_ns
        return SweepAggregates(
            count=len(sp),
            speedup_mean=float(sp.mean()) if len(sp) else 0.0,
            speedup_min=float(sp.min()) if len(sp) else np.inf,
            speedup_max=float(sp.max()) if len(sp) else -np.inf,
            hist=hist,
            n_beneficial=(gain > 0).sum(axis=0).astype(np.int64),
            gain_sum=gain.sum(axis=0, dtype=np.float64))


@dataclass(frozen=True)
class TopKSweepResult:
    """What a STREAMING sweep returns: the ``k`` best scenarios with full
    per-call detail, plus exact whole-sweep aggregates — never the
    ``(S, n_calls)`` matrices.

    ``indices`` are global scenario indices into ``scenarios`` (the full
    set evaluated, refined rounds included), best speedup first with ties
    toward the lower index — the order ``SweepResult.topk`` gives.
    ``result`` is an exact matrix-backend re-evaluation of exactly those
    scenarios (``result.grid == scenarios.subset(indices)``).
    ``shard_rows`` is the peak per-shard scenario-row allocation the
    streaming pass needed.
    """

    scenarios: object
    indices: np.ndarray
    speedups: np.ndarray
    result: SweepResult
    aggregates: SweepAggregates
    plan: object
    shard_rows: int

    def __len__(self) -> int:
        return len(self.indices)

    def labels(self) -> list:
        """Varied-axis labels of the surviving scenarios, best first."""
        return self.result.grid.labels()

    def summary_rows(self, replaced=None) -> list:
        return self.result.summary_rows(replaced)

    def best_scenario(self) -> int:
        """Global index of the best scenario in :attr:`scenarios`."""
        if len(self.indices) == 0:
            raise ValueError("best_scenario() on an empty sweep")
        return int(self.indices[0])


def _chunk_slices(n: int, chunk: int):
    for lo in range(0, n, chunk):
        yield slice(lo, min(lo + chunk, n))


def _scenario_view(grid, mpi_transfer=None, free_transfer=None):
    """The host view of a :class:`ScenarioSet` with the explicit
    transfer-model overrides applied."""
    v = grid.view()
    S = len(grid)
    swept = dict(getattr(grid, "cat", ()) or ())
    for side, model in (("mpi_transfer", mpi_transfer),
                        ("free_transfer", free_transfer)):
        if model is None:
            continue
        if side in swept:
            raise ValueError(
                f"{side} is both a categorical grid axis and an explicit "
                f"transfer-model override; use one or the other")
        setattr(v, side + "_models", (model,))
        setattr(v, side + "_code", np.zeros((S, 1), dtype=np.int32))
    return v


def _finalize(part: dict, s: int, c: int, lo: int = 0,
              hi: int | None = None) -> dict:
    """One executor output (device tensors, merely broadcastable to
    ``(s, c)``) as float64 host matrices of its columns ``lo:hi``, cut on
    the device before the copy."""
    out = {}
    for f in MATRIX_FIELDS:
        t = torch.as_tensor(part[f], dtype=torch.float64)
        out[f] = t.expand(s, c)[:, lo:hi].contiguous().cpu().numpy()
    return out


def _resolve(plan: ExecPlan | None):
    """``(plan, executor)``; a plan whose device is CUDA raises here when
    no CUDA device is present, even for an empty sweep."""
    plan = plan if plan is not None else ExecPlan()
    run = resolve_backend(plan.backend)
    if plan.backend != "numpy":
        plan.torch_device()
    return plan, run


def _matrices(cb: CompiledBundle, grid, plan: ExecPlan, run, cols,
              mpi_transfer=None, free_transfer=None) -> list:
    """Price ``grid`` with the matrix executor ``run``; one dict of host
    ``(S, hi - lo)`` matrices per column range ``(lo, hi)`` of ``cols``.
    Scenario-axis chunking is bit-identical (every row is computed
    independently)."""
    S, C = len(grid), cb.n_calls
    if S == 0 or C == 0:
        return [{f: np.zeros((S, hi - lo)) for f in MATRIX_FIELDS}
                for lo, hi in cols]
    v = _scenario_view(grid, mpi_transfer, free_transfer)
    chunk = plan.chunk_scenarios
    if chunk is None or chunk >= S:
        part = run(cb, v, plan)
        return [_finalize(part, S, C, lo, hi) for lo, hi in cols]
    out = [{f: np.empty((S, hi - lo), dtype=np.float64)
            for f in MATRIX_FIELDS} for lo, hi in cols]
    for sl in _chunk_slices(S, chunk):
        part = run(cb, v._slice(sl), plan)
        for mats, (lo, hi) in zip(out, cols):
            for f, m in _finalize(part, sl.stop - sl.start, C, lo,
                                  hi).items():
                mats[f][sl] = m
    return out


def _sweep_plan(cb: CompiledBundle, grid, plan: ExecPlan | None,
                mpi_transfer=None, free_transfer=None) -> SweepResult:
    """The execution core behind ``price()``: one compiled bundle, one
    :class:`ScenarioSet`, one :class:`ExecPlan`.  A MATRIX backend gives a
    full :class:`SweepResult`; a STREAMING backend (``is_streaming``) owns
    its whole execution and returns its own result (a
    :class:`TopKSweepResult`)."""
    plan, run = _resolve(plan)
    if is_streaming(plan.backend):
        return run(cb, grid, plan, mpi_transfer, free_transfer)
    mats, = _matrices(cb, grid, plan, run, [(0, cb.n_calls)], mpi_transfer,
                      free_transfer)
    return SweepResult(grid=grid, compiled=cb, **mats)


def sweep_run(bundle, grid: ParamGrid, mpi_transfer=None, free_transfer=None,
              plan: ExecPlan | str | None = None) -> SweepResult:
    """Evaluate every scenario of ``grid`` against one bundle
    (``TraceBundle`` or ``CompiledBundle``) — a thin wrapper over the
    ``price()`` core.  ``mpi_transfer`` / ``free_transfer`` override the
    Hockney / two-atomic models with an explicit model instance (fields
    scalars or ``(S, 1)`` arrays); to mix models WITHIN the grid use the
    categorical axes instead."""
    if isinstance(plan, str):
        plan = ExecPlan.parse(plan)
    cb = bundle if isinstance(bundle, CompiledBundle) else compile_bundle(bundle)
    return _sweep_plan(cb, grid, plan, mpi_transfer, free_transfer)


# --------------------------------------------------------------------------
# Multi-bundle sweeps: many compiled bundles, one batched evaluation
# --------------------------------------------------------------------------

def concat_bundles(bundles) -> CompiledBundle:
    """Pack several ``CompiledBundle``\\ s into ONE super-bundle.

    The packed sample groups are concatenated with their segment ids /
    starts offset by the running call count, so one bracket pass prices
    every call-site of every bundle.  Per-bundle scalars that enter the
    pricing — the counter set and the sampling period — become
    ``(n_calls,)`` arrays (each bundle's value repeated over its
    call-sites); the pricing is elementwise in them, so each column prices
    exactly as it does in a per-bundle run.  ``baseline_runtime_ns`` is
    the SUM of the parts.
    """
    bundles = list(bundles)
    if not bundles:
        raise ValueError("concat_bundles needs at least one bundle")
    reps = np.array([cb.n_calls for cb in bundles], dtype=np.int64)

    def rep_counter(field):
        vals = np.array([getattr(cb.counters, field) for cb in bundles],
                        dtype=np.float64)
        return np.repeat(vals, reps)

    def cat(field, dtype=None):
        out = np.concatenate([getattr(cb, field) for cb in bundles])
        return out.astype(dtype) if dtype is not None else out

    call_off = np.cumsum([0] + [cb.n_calls for cb in bundles[:-1]])
    groups = {}
    for grp in _GROUPS:
        samp_off = np.cumsum([0] + [len(getattr(cb, grp + "_lat"))
                                    for cb in bundles[:-1]])
        groups.update({
            grp + "_lat": cat(grp + "_lat"), grp + "_w": cat(grp + "_w"),
            grp + "_counts": cat(grp + "_counts", np.int64),
            grp + "_starts": np.concatenate(
                [getattr(cb, grp + "_starts") + off
                 for cb, off in zip(bundles, samp_off)]).astype(np.int64),
            grp + "_seg": np.concatenate(
                [getattr(cb, grp + "_seg") + np.int32(off)
                 for cb, off in zip(bundles, call_off)]).astype(np.int32)})
    counters = CounterSet(**{f.name: rep_counter(f.name)
                             for f in dataclasses.fields(CounterSet)})
    return CompiledBundle(
        call_ids=tuple(cid for cb in bundles for cid in cb.call_ids),
        **groups,
        **{k: cat(k) for k in ("hit_wl_sum", "lfb_wl_sum", "miss_w_sum",
                               "total_wl", "buffer_bytes",
                               "accesses_per_element", "prefetch_frac")},
        unpack=cat("unpack", bool),
        traffic=SiteTraffic(**{
            k: np.concatenate([getattr(cb.traffic, k) for cb in bundles])
            for k in ("n_msgs", "total_bytes", "gap_bytes")}),
        counters=counters,
        sampling_period=np.repeat(
            np.array([cb.sampling_period for cb in bundles],
                     dtype=np.float64), reps),
        baseline_runtime_ns=float(sum(cb.baseline_runtime_ns
                                      for cb in bundles)))


@dataclass(frozen=True)
class MultiSweepResult:
    """Per-bundle ``SweepResult``\\ s priced in ONE batched evaluation.

    ``sweep_run_many`` packs every bundle into a super-bundle, prices it
    under the grid, then splits the component matrices back per bundle, so
    ``result[i]`` carries what ``sweep_run(bundle_i, grid)`` would (same
    backend) while the kernel ran once.  ``names`` labels the bundles.
    """

    grid: ParamGrid
    results: tuple          # one SweepResult per bundle, input order
    names: tuple = ()

    def __post_init__(self):
        if not self.names:
            object.__setattr__(
                self, "names",
                tuple(f"bundle{i}" for i in range(len(self.results))))

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self):
        return iter(self.results)

    def __getitem__(self, key) -> SweepResult:
        if isinstance(key, str):
            return self.results[self.names.index(key)]
        return self.results[key]

    # -- deployment-level aggregates -----------------------------------------
    def predicted_runtime_ns(self, weights=None, replaced=None) -> np.ndarray:
        """(S,) deployment wall time: each bundle's predicted runtime,
        weighted by how often that step runs (``weights``, default 1
        each)."""
        w = self._weights(weights)
        out = np.zeros(len(self.grid), dtype=np.float64)
        for wi, r in zip(w, self.results):
            out = out + wi * r.predicted_runtime_ns(replaced)
        return out

    def predicted_speedup(self, weights=None, replaced=None) -> np.ndarray:
        """(S,) deployment speedup = Σ w·baseline / Σ w·predicted (ones
        when there are no bundles)."""
        w = self._weights(weights)
        base = sum(wi * r.compiled.baseline_runtime_ns
                   for wi, r in zip(w, self.results))
        if not self.results or base == 0.0:
            return np.ones(len(self.grid), dtype=np.float64)
        return base / self.predicted_runtime_ns(weights, replaced)

    def best_scenario(self, weights=None, replaced=None) -> int:
        if len(self.grid) == 0:
            raise ValueError("best_scenario() on an empty grid: the sweep "
                             "has 0 scenarios, so there is no argmax")
        return int(np.argmax(self.predicted_speedup(weights, replaced)))

    def n_beneficial(self) -> np.ndarray:
        """(S,) beneficial call-sites across the whole deployment."""
        out = np.zeros(len(self.grid), dtype=np.int64)
        for r in self.results:
            out = out + r.n_beneficial()
        return out

    def summary_rows(self, weights=None, replaced=None) -> list:
        """One dict per scenario: varied axes + per-bundle and deployment
        speedups."""
        speed = self.predicted_speedup(weights, replaced)
        nben = self.n_beneficial()
        per = {n: r.predicted_speedup(replaced)
               for n, r in zip(self.names, self.results)}
        rows = []
        for i, lab in enumerate(self.grid.labels()):
            row = {**lab, "predicted_speedup": float(speed[i]),
                   "n_beneficial": int(nben[i])}
            for n in self.names:
                row[f"speedup[{n}]"] = float(per[n][i])
            rows.append(row)
        return rows

    def _weights(self, weights) -> list:
        if weights is None:
            return [1.0] * len(self.results)
        if hasattr(weights, "step_weights"):
            # anything reporting its observed step mix (a serve engine)
            weights = weights.step_weights()
        if isinstance(weights, dict):
            return [float(weights.get(n, 1.0)) for n in self.names]
        w = list(weights)
        if len(w) != len(self.results):
            raise ValueError(f"{len(w)} weights for {len(self.results)} "
                             "bundles")
        return [float(v) for v in w]


def _sweep_plan_many(bundles, grid, plan: ExecPlan | None, names=None,
                     mpi_transfer=None, free_transfer=None
                     ) -> MultiSweepResult:
    """Multi-bundle execution core: pack every bundle into one
    offset-segment-id super-bundle (:func:`concat_bundles`), price it with
    ONE backend invocation, and split the matrices per bundle on the
    pricing device, before they are copied to the host."""
    if plan is not None and is_streaming(plan.backend):
        raise ValueError(
            f"backend {plan.backend!r} is a streaming reducer and returns "
            "no per-bundle matrices to split; price each bundle "
            "separately, or pass a matrix backend (see known_backends())")
    cbs = [b if isinstance(b, CompiledBundle) else compile_bundle(b)
           for b in bundles]
    names = tuple(names) if names is not None else ()
    if names and len(names) != len(cbs):
        raise ValueError(f"{len(names)} names for {len(cbs)} bundles")
    if not cbs:
        return MultiSweepResult(grid=grid, results=(), names=names)

    plan, run = _resolve(plan)
    ends = np.cumsum([0] + [cb.n_calls for cb in cbs]).tolist()
    parts = _matrices(concat_bundles(cbs), grid, plan, run,
                      list(zip(ends[:-1], ends[1:])), mpi_transfer,
                      free_transfer)
    return MultiSweepResult(
        grid=grid, names=names,
        results=tuple(SweepResult(grid=grid, compiled=cb, **mats)
                      for cb, mats in zip(cbs, parts)))


def sweep_run_many(bundles, grid: ParamGrid, names=None, mpi_transfer=None,
                   free_transfer=None,
                   plan: ExecPlan | str | None = None) -> MultiSweepResult:
    """Price MANY bundles (``TraceBundle`` or ``CompiledBundle``, mixed
    freely) under one scenario grid in one batched evaluation — a thin
    wrapper over the ``price()`` multi-bundle core."""
    if isinstance(plan, str):
        plan = ExecPlan.parse(plan)
    return _sweep_plan_many(bundles, grid, plan, names,
                            mpi_transfer, free_transfer)
