"""Array-backed scenario sets and the streaming ``"distributed"`` sweep.

The counterpart of ``repro.core.adaptive``:

  * :class:`ArraySet` — a :class:`~repro_torch.core.sweep.ScenarioSet`
    backed by COLUMN ARRAYS instead of per-scenario ``ModelParams``, so a
    million-scenario design costs a few float columns and its host view a
    few reshapes.  :func:`adaptive_sample` builds one from the same
    ``np.random.default_rng`` stream as ``ParamGrid.sample`` (same base,
    seed and ranges: the same scenarios), and :meth:`ArraySet.refine`
    re-samples new scenarios around frontier points within the recorded
    axis ranges.
  * :func:`run_distributed` — the streaming executor behind
    ``ExecPlan("distributed")``: price fixed-size padded chunks with the
    fused kernel and reduce each ON THE DEVICE to per-shard top-k
    candidates plus exact aggregates
    (:func:`~repro_torch.core.sweep_kernel.price_topk_chunk`), so the full
    ``(S, n_calls)`` matrices never exist.  With ``plan.refine > 0`` it
    adds adaptive rounds re-sampled around the current speedup frontier,
    then re-evaluates the survivors exactly.  Inside an initialized
    ``torch.distributed`` process group each rank prices its own shard of
    every chunk on its device, and the shards' candidates and aggregates
    are all-gathered, so every rank returns the same result.

Everything here but the chunk reduction is host-side NumPy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import transport
from .execplan import ExecPlan
from .params import ModelParams
from .sweep import (CATEGORICAL_AXES, ParamGrid, SweepAggregates,
                    TopKSweepResult, _axis_values, _chunk_slices,
                    _ParamArrays, _scenario_view, _sweep_plan, padded_size)
from .sweep_kernel import (DIST_CHUNK_DEFAULT, SPEEDUP_HIST_EDGES,
                           price_topk_chunk, topk_chunk_tensors)


@dataclasses.dataclass(frozen=True)
class ArraySet:
    """Array-backed :class:`~repro_torch.core.sweep.ScenarioSet`.

    ``columns`` holds the varied NUMERIC fields as ``{field: (n,)
    float64}``; every unvaried field broadcasts from ``base``.  ``cat``
    holds the categorical transfer-model axes as ``{axis: (codes,
    choices)}`` — an ``(n,)`` integer column into the static ``choices``
    tuple.  ``ranges`` records what each varied axis may span (``(lo,
    hi)`` numeric, the choices tuple categorical): the envelope
    :meth:`refine` re-samples within.
    """

    base: ModelParams
    n: int
    columns: dict
    cat: dict
    ranges: dict

    def __len__(self) -> int:
        return self.n

    def view(self) -> _ParamArrays:
        return _ParamArrays.from_columns(self.base, self.n, self.columns,
                                         self.cat)

    def labels(self) -> list:
        return [self.label_at(i) for i in range(self.n)]

    def label_at(self, i: int) -> dict:
        lab = {k: float(col[i]) for k, col in self.columns.items()}
        for axis, (codes, choices) in self.cat.items():
            lab[axis] = choices[int(codes[i])]
        return lab

    def params_at(self, i: int) -> ModelParams:
        """Scenario ``i`` as a scalar ``ModelParams``."""
        return self.base.replace(
            **{k: float(col[i]) for k, col in self.columns.items()})

    def subset(self, indices) -> "ArraySet":
        """The scenarios at ``indices``, in that order."""
        idx = np.asarray(indices, dtype=np.int64).ravel()
        return ArraySet(
            base=self.base, n=len(idx),
            columns={k: col[idx] for k, col in self.columns.items()},
            cat={a: (codes[idx], choices)
                 for a, (codes, choices) in self.cat.items()},
            ranges=self.ranges)

    @classmethod
    def concat(cls, *sets) -> "ArraySet":
        """Sets back-to-back (all must vary the same axes with the same
        categorical choices — a seed and its refinement rounds)."""
        if len(sets) == 1 and not isinstance(sets[0], ArraySet):
            sets = tuple(sets[0])
        if not sets:
            raise ValueError("concat needs at least one ArraySet")
        first = sets[0]
        for s in sets[1:]:
            if set(s.columns) != set(first.columns) \
                    or set(s.cat) != set(first.cat) \
                    or any(s.cat[a][1] != first.cat[a][1] for a in s.cat):
                raise ValueError("concat: ArraySets must share the same "
                                 "varied axes and categorical choices")
        return cls(
            base=first.base, n=sum(s.n for s in sets),
            columns={k: np.concatenate([s.columns[k] for s in sets])
                     for k in first.columns},
            cat={a: (np.concatenate([s.cat[a][0] for s in sets]),
                     first.cat[a][1]) for a in first.cat},
            ranges=first.ranges)

    def refine(self, points, n: int, *, seed: int = 0,
               shrink: float = 0.25) -> "ArraySet":
        """``n`` new scenarios clustered around ``points`` (label dicts,
        e.g. ``[s.label_at(i) for i in frontier]``), assigned round-robin:
        each numeric axis draws uniformly from a ``shrink * (hi - lo)``
        window centred on its point, clamped to the recorded range;
        categorical axes keep the centre's choice.  Deterministic per
        ``seed``."""
        if n < 1:
            raise ValueError(f"refine needs n >= 1, got {n}")
        pts = list(points)
        if not pts:
            raise ValueError("refine needs at least one frontier point")
        if not self.ranges:
            raise ValueError(
                "refine needs recorded axis ranges; build the seed with "
                "ParamGrid.sample / adaptive_sample")
        rng = np.random.default_rng(seed)
        owner = np.arange(n) % len(pts)        # round-robin centre per draw
        columns, cat = {}, {}
        for name in self.columns:
            lo, hi = (float(v) for v in self.ranges[name])
            mid = 0.5 * (lo + hi)
            centers = np.array([float(p.get(name, mid)) for p in pts])[owner]
            vals = centers + shrink * (hi - lo) * rng.uniform(-0.5, 0.5,
                                                              size=n)
            columns[name] = np.clip(vals, lo, hi)
        for axis, (_, choices) in self.cat.items():
            lut = {c: k for k, c in enumerate(choices)}
            codes = np.array([lut[p.get(axis, choices[0])] for p in pts],
                             dtype=np.int32)
            cat[axis] = (codes[owner], choices)
        return ArraySet(base=self.base, n=n, columns=columns, cat=cat,
                        ranges=self.ranges)


def adaptive_sample(base: ModelParams | None = None, n: int = 16, *,
                    seed: int = 0, method: str = "lhs",
                    **ranges) -> ArraySet:
    """``ParamGrid.sample`` semantics, array-backed: the same validation
    and the same LHS / uniform random stream (the same base, seed and
    ranges give scenario for scenario the same design), as an
    :class:`ArraySet` of ``(n,)`` columns instead of ``n`` ``ModelParams``
    objects."""
    base = base or ModelParams()
    if n < 1:
        raise ValueError(f"adaptive_sample needs n >= 1, got {n}")
    if method not in ("lhs", "uniform"):
        raise ValueError(f"unknown sample method {method!r}; "
                         "use 'lhs' or 'uniform'")
    if not ranges:
        raise ValueError("adaptive_sample needs at least one axis range")
    valid = {f.name for f in dataclasses.fields(ModelParams)}
    rng = np.random.default_rng(seed)
    columns, cat, recorded = {}, {}, {}
    for name, spec in ranges.items():
        vals = _axis_values(name, spec, valid)
        if name in CATEGORICAL_AXES:
            if method == "lhs":         # near-even coverage, then shuffled
                idx = np.tile(np.arange(len(vals)), -(-n // len(vals)))[:n]
                rng.shuffle(idx)
            else:
                idx = rng.integers(0, len(vals), size=n)
            cat[name] = (np.asarray(idx, dtype=np.int32), tuple(vals))
            recorded[name] = tuple(vals)
            continue
        if len(vals) != 2:
            raise ValueError(f"axis {name!r}: numeric sample ranges "
                             f"are (lo, hi) pairs, got {spec!r}")
        lo, hi = float(vals[0]), float(vals[1])
        if not hi >= lo:
            raise ValueError(f"axis {name!r}: lo ({lo}) must not "
                             f"exceed hi ({hi})")
        if method == "lhs":             # one draw per 1/n stratum, permuted
            u = (rng.permutation(n) + rng.uniform(size=n)) / n
        else:
            u = rng.uniform(size=n)
        columns[name] = lo + u * (hi - lo)
        recorded[name] = (lo, hi)
    return ArraySet(base=base, n=n, columns=columns, cat=cat,
                    ranges=recorded)


def as_array_set(grid) -> ArraySet:
    """The :class:`ArraySet` equal to a ``ParamGrid.sample`` grid (identity
    on an ArraySet).  Needs the grid's recorded axis ranges: the array
    form exists for refinement within them."""
    if isinstance(grid, ArraySet):
        return grid
    if not isinstance(grid, ParamGrid):
        raise TypeError(f"cannot convert {type(grid).__name__} to "
                        "ArraySet; pass a ParamGrid or ArraySet")
    if not grid.ranges:
        raise ValueError(
            "adaptive refinement needs recorded axis ranges; build the "
            "seed with ParamGrid.sample(...) or adaptive_sample(...)")
    ranges = dict(grid.ranges)
    columns = {name: np.array([getattr(p, name) for p in grid.params],
                              dtype=np.float64)
               for name in ranges if name not in CATEGORICAL_AXES}
    cat = {}
    for axis, names in grid.cat:
        choices = tuple(ranges.get(axis) or dict.fromkeys(names))
        lut = {c: k for k, c in enumerate(choices)}
        cat[axis] = (np.array([lut[nm] for nm in names], dtype=np.int32),
                     choices)
    base = grid.params[0] if grid.params else ModelParams()
    return ArraySet(base=base, n=len(grid), columns=columns, cat=cat,
                    ranges=ranges)


# --------------------------------------------------------------------------
# The streaming reduction state
# --------------------------------------------------------------------------

class _StreamState:
    """Host-side accumulator of the per-chunk shard outputs of
    :func:`~repro_torch.core.sweep_kernel.price_topk_chunk`.

    Keeps at most ``O(k)`` top-k / frontier candidates (compacted with a
    stable ``lexsort((idx, -val))`` merge — best speedup first, ties to
    the lower global index) plus the exact running aggregates; its memory
    does not grow with the scenario count.
    """

    def __init__(self, n_calls: int, k: int):
        self.k = int(k)
        self.cand_val, self.cand_idx = [], []
        self.front_val, self.front_idx = [], []
        self.count = 0
        self.sp_sum = 0.0
        self.sp_min, self.sp_max = np.inf, -np.inf
        self.hist = np.zeros(len(SPEEDUP_HIST_EDGES) + 1, dtype=np.int64)
        self.n_beneficial = np.zeros(n_calls, dtype=np.int64)
        self.gain_sum = np.zeros(n_calls, dtype=np.float64)

    def add(self, out: dict) -> None:
        ok = out["top_ok"].ravel()
        self.cand_val.append(out["top_val"].ravel()[ok])
        self.cand_idx.append(out["top_idx"].ravel()[ok])
        fok = out["front_ok"].ravel()
        self.front_val.append(out["front_val"].ravel()[fok])
        self.front_idx.append(out["front_idx"].ravel()[fok])
        self.count += int(round(float(out["count"].sum())))
        self.sp_sum += float(out["sp_sum"].sum())
        self.sp_min = min(self.sp_min, float(out["sp_min"].min()))
        self.sp_max = max(self.sp_max, float(out["sp_max"].max()))
        self.hist += np.rint(out["hist"].sum(axis=0)).astype(np.int64)
        self.n_beneficial += out["n_beneficial"].sum(axis=0) \
                                                .astype(np.int64)
        self.gain_sum += out["gain_sum"].sum(axis=0)
        if sum(map(len, self.cand_val)) > 4 * self.k:
            self._compact()

    @staticmethod
    def _merge(vals, idxs, keep, key=None):
        """Stable candidate merge: order by descending ``key`` (default
        the value itself), ties toward the lower global index."""
        val = np.concatenate(vals) if vals else np.zeros(0)
        idx = np.concatenate(idxs) if idxs else np.zeros(0, np.int64)
        order = np.lexsort((idx, -(key(val) if key else val)))[:keep]
        return val[order], idx[order]

    def _compact(self) -> None:
        v, i = self._merge(self.cand_val, self.cand_idx, self.k)
        self.cand_val, self.cand_idx = [v], [i]
        fv, fi = self._merge(self.front_val, self.front_idx, self.k,
                             key=lambda sp: -np.abs(sp - 1.0))
        self.front_val, self.front_idx = [fv], [fi]

    def topk(self):
        """Final ``(indices, speedups)`` of the surviving top-k."""
        v, i = self._merge(self.cand_val, self.cand_idx, self.k)
        return i, v

    def frontier_indices(self, m: int) -> np.ndarray:
        """Global indices to refine around: the running top-k UNION the
        ``m`` scenarios closest to speedup 1.0 (first occurrence order,
        deduplicated)."""
        ti, _ = self.topk()
        _, fi = self._merge(self.front_val, self.front_idx, int(m),
                            key=lambda sp: -np.abs(sp - 1.0))
        both = np.concatenate([ti, fi])
        _, first = np.unique(both, return_index=True)
        return both[np.sort(first)]

    def aggregates(self) -> SweepAggregates:
        return SweepAggregates(
            count=self.count,
            speedup_mean=self.sp_sum / self.count if self.count else 0.0,
            speedup_min=float(self.sp_min),
            speedup_max=float(self.sp_max),
            hist=self.hist.copy(),
            n_beneficial=self.n_beneficial.copy(),
            gain_sum=self.gain_sum.copy())


# --------------------------------------------------------------------------
# The streaming executor
# --------------------------------------------------------------------------

def _rank_group(plan: ExecPlan):
    """The world group when the process is one rank of an initialized
    ``torch.distributed`` group, else ``None`` (the stacked form)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    if plan.devices is not None and plan.devices != world:
        raise ValueError(f"plan.devices={plan.devices}, but the process "
                         f"group has {world} ranks")
    return dist.group.WORLD


def _gather_shards(out: dict, group) -> dict:
    """Every rank's one-shard chunk outputs (a leading axis of 1) as NumPy
    arrays with a leading axis of ranks, in rank order: packed into one
    float64 vector (indices and counts are below 2**53, so exact), one
    all-gather, unpacked to the outputs' dtypes."""
    names = sorted(out)
    flat = torch.cat([out[n].reshape(-1).to(torch.float64) for n in names])
    rows = transport.all_gather(flat, group).cpu().numpy()
    res, at = {}, 0
    for n in names:
        shape, size = tuple(out[n].shape[1:]), out[n][0].numel()
        dtype = np.dtype(str(out[n].dtype).removeprefix("torch."))
        res[n] = rows[:, at:at + size].reshape(-1, *shape).astype(dtype)
        at += size
    return res


def run_distributed(cb, scenarios, plan: ExecPlan, *, mpi_transfer=None,
                    free_transfer=None) -> TopKSweepResult:
    """The ``"distributed"`` streaming executor (registered in
    ``execplan``; reach it through ``price(..., plan="distributed:devices=
    4,topk=64,refine=2")``).

    Streams the scenario axis in chunks of ``plan.chunk_scenarios``
    (default :data:`DIST_CHUNK_DEFAULT`), each padded to a multiple of
    ``plan.devices`` shards, moved to ``plan.device`` in the plan's dtype,
    priced by the fused kernel (one launch per chunk) and reduced there by
    :func:`price_topk_chunk`; the host merges ``O(devices x topk)``
    candidates per chunk.  With ``plan.refine > 0`` the set must be
    refinable (a ``ParamGrid.sample`` grid or an :class:`ArraySet`): round
    ``r`` re-samples ``len(seed)`` scenarios around the current frontier
    with seed ``r + 1`` and a window of ``0.25 * 0.5**r`` of each range.
    The surviving top-k are re-evaluated exactly with the matrix
    ``"fused"`` backend on ``plan.device``.

    Over ranks: when a ``torch.distributed`` process group is initialized,
    ``plan.devices`` (if given) must equal its world size, every rank must
    call with the same arguments, and rank ``r`` prices rows ``[r * n /
    R, (r + 1) * n / R)`` of each padded chunk of ``n`` rows, the shard the
    stacked form gives its ``r``-th slot; the per-shard outputs are
    all-gathered (one all-gather per chunk), so each rank merges the same
    candidates and returns the same result.
    """
    dev = plan.torch_device()
    exact_plan = ExecPlan("fused", device=plan.device, x64=plan.x64)
    k = plan.topk
    C = cb.n_calls
    S = len(scenarios)
    if S == 0:
        return TopKSweepResult(
            scenarios=scenarios, indices=np.zeros(0, dtype=np.int64),
            speedups=np.zeros(0),
            result=_sweep_plan(cb, scenarios, exact_plan, mpi_transfer,
                               free_transfer),
            aggregates=SweepAggregates(
                count=0, speedup_mean=0.0, speedup_min=np.inf,
                speedup_max=-np.inf,
                hist=np.zeros(len(SPEEDUP_HIST_EDGES) + 1, dtype=np.int64),
                n_beneficial=np.zeros(C, dtype=np.int64),
                gain_sum=np.zeros(C)),
            plan=plan, shard_rows=0)

    group = _rank_group(plan)
    n_dev = plan.devices if plan.devices is not None else 1
    if group is not None:
        n_dev = dist.get_world_size(group)
        rank = dist.get_rank(group)
    chunk = plan.chunk_scenarios or DIST_CHUNK_DEFAULT
    total = as_array_set(scenarios) if plan.refine > 0 else scenarios
    if not hasattr(total, "subset"):
        raise TypeError(
            f"the distributed backend needs a ScenarioSet with .subset() "
            f"for the final exact pass; {type(total).__name__} has none")
    state = _StreamState(C, k)
    shard_rows = 0

    def consume(work, offset: int) -> None:
        nonlocal shard_rows
        view = _scenario_view(work, mpi_transfer, free_transfer)
        m = len(work)
        n_pad = padded_size(min(chunk, m), n_dev)
        shard_rows = max(shard_rows, n_pad // n_dev)
        for sl in _chunk_slices(m, n_pad):
            size = sl.stop - sl.start
            vs = view._slice(sl)._pad(n_pad)
            valid = np.zeros(n_pad, dtype=bool)
            valid[:size] = True
            idx = np.empty(n_pad, dtype=np.int64)
            idx[:size] = offset + np.arange(sl.start, sl.stop)
            idx[size:] = idx[size - 1]       # padded copies, masked out
            if group is None:
                state.add(price_topk_chunk(cb, vs.to(dev, plan.dtype), valid,
                                           idx, k, n_devices=n_dev))
                continue
            n_loc = n_pad // n_dev
            mine = slice(rank * n_loc, (rank + 1) * n_loc)
            out = topk_chunk_tensors(cb, vs._slice(mine).to(dev, plan.dtype),
                                     valid[mine], idx[mine], k)
            state.add(_gather_shards(out, group))

    consume(total, 0)
    for r in range(plan.refine):
        points = [total.label_at(int(i))
                  for i in state.frontier_indices(k)]
        fresh = total.refine(points, n=S, seed=r + 1,
                             shrink=0.25 * 0.5 ** r)
        consume(fresh, len(total))
        total = ArraySet.concat(total, fresh)

    top_idx, top_val = state.topk()
    exact = _sweep_plan(cb, total.subset(top_idx), exact_plan,
                        mpi_transfer, free_transfer)
    return TopKSweepResult(scenarios=total, indices=top_idx,
                           speedups=top_val, result=exact,
                           aggregates=state.aggregates(), plan=plan,
                           shard_rows=shard_rows)
