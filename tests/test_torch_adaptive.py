"""The port's array-backed scenario sets (``adaptive_sample``, ``ArraySet``,
``ParamGrid.refine``) and its streaming ``"distributed"`` backend against
the JAX package's, on the same inputs.

Bounds are the reference's (``test_topk_sweep.py``,
``test_distributed.py``): scenario sets, labels, refined columns and codes
equal; an ArraySet prices bit-identically to its ParamGrid in the port and
within rtol 1e-12 of the reference's numpy backend; the streaming top-k
has the matrix reference's indices, speedups and ``gain_ns`` within 1e-9,
exact ``hist`` / ``n_beneficial`` counts, and the other aggregates within
1e-9.  The port runs on the CPU, where the fused kernel's wrapper runs its
plain version; the JAX package in-process on one device.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as pt
from repro.core.adaptive import ArraySet as RefArraySet
from repro.core.adaptive import _StreamState as RefStreamState
from repro_torch.core import sweep_kernel as pt_sweep_kernel
from repro_torch.core.adaptive import _StreamState
from repro_torch.core.sweep import padded_size
from test_sweep_backends import small_bundle
from test_torch_sweep import _port_counters, _ref_fields

RANGES = dict(cxl_lat_ns=(250.0, 700.0), cxl_atomic_lat_ns=(300.0, 800.0))
N_HIST = len(pt.SPEEDUP_HIST_EDGES) + 1


@pytest.fixture(scope="module")
def compiled():
    """The reference's ``small_bundle`` compiled by the reference, and the
    port's bundle carried over from its arrays."""
    rcb = ref.compile_bundle(small_bundle())
    pcb = pt.compiled_bundle_from_arrays(
        _ref_fields(rcb), counters=_port_counters(rcb.counters),
        sampling_period=rcb.sampling_period, call_ids=rcb.call_ids)
    return rcb, pcb


def _both(fn_name, *args, **kw):
    """The same scenario-set constructor on both packages."""
    base = kw.pop("base", "multinode")
    return (getattr(ref, fn_name)(ref.PAPER_PRESETS[base](), *args, **kw),
            getattr(pt, fn_name)(pt.PAPER_PRESETS[base](), *args, **kw))


def _same_array_sets(ra, pa):
    assert len(ra) == len(pa) and ra.n == pa.n
    assert dataclasses.asdict(ra.base) == dataclasses.asdict(pa.base)
    assert set(ra.columns) == set(pa.columns)
    for k in ra.columns:
        np.testing.assert_array_equal(pa.columns[k], ra.columns[k])
        assert pa.columns[k].dtype == ra.columns[k].dtype
    assert set(ra.cat) == set(pa.cat)
    for a, (codes, choices) in ra.cat.items():
        np.testing.assert_array_equal(pa.cat[a][0], codes)
        assert pa.cat[a][0].dtype == codes.dtype and pa.cat[a][1] == choices
    assert pa.ranges == ra.ranges
    assert pa.labels() == ra.labels()


# ------------------------------------------------------ the data model

SAMPLES = [
    (16, dict(seed=3, mpi_transfer=["hockney", "loggp"], **RANGES)),
    (37, dict(seed=4, mpi_transfer=["hockney", "loggp"],
              cxl_lat_ns=(250.0, 700.0))),
    (23, dict(seed=9, method="uniform", mem_lat_ns=(80.0, 120.0),
              free_transfer=["message_free", "two_atomic"])),
    (100, dict(seed=7, mpi_transfer=["hockney", "loggp"], **RANGES)),
]


@pytest.mark.parametrize("n,kw", SAMPLES)
def test_adaptive_sample_matches_reference_and_paramgrid(n, kw):
    ra, pa = _both("adaptive_sample", n, **dict(kw))
    _same_array_sets(ra, pa)
    rg = ref.ParamGrid.sample(ref.ModelParams.multinode(), n, **dict(kw))
    pg = pt.ParamGrid.sample(pt.ModelParams.multinode(), n, **dict(kw))
    assert pa.labels() == pg.labels() == rg.labels()
    _same_array_sets(ref.as_array_set(rg), pt.as_array_set(pg))
    assert pt.as_array_set(pa) is pa
    for i in (0, n // 2, n - 1):
        assert pa.label_at(i) == pg.label_at(i)
        assert dataclasses.asdict(pa.params_at(i)) == \
            dataclasses.asdict(pg.params[i])


@pytest.mark.parametrize("seed,shrink,picks", [
    (9, 0.25, (0, 1, 2)), (1, 0.125, (5, 99, 5, 40)), (3, 1.0, (17,))])
def test_refine_matches_reference(seed, shrink, picks):
    """The same frontier points and seed give the reference's refined
    columns and codes, within the recorded ranges; categorical axes keep
    the centre's choice."""
    ra, pa = _both("adaptive_sample", 100, seed=7,
                   mpi_transfer=["hockney", "loggp"], **RANGES)
    pts = [pa.label_at(i) for i in picks]
    rn = ra.refine(pts, 30, seed=seed, shrink=shrink)
    pn = pa.refine(pts, 30, seed=seed, shrink=shrink)
    _same_array_sets(rn, pn)
    for j in range(30):
        lab, center = pn.label_at(j), pts[j % len(pts)]
        for name, (lo, hi) in RANGES.items():
            assert lo <= lab[name] <= hi
            assert abs(lab[name] - center[name]) \
                <= 0.5 * shrink * (hi - lo) + 1e-9
        assert lab["mpi_transfer"] == center["mpi_transfer"]
    # ParamGrid.refine goes through the grid's ArraySet form
    rg = ref.ParamGrid.sample(ref.ModelParams.multinode(), 10, seed=1,
                              **RANGES)
    pg = pt.ParamGrid.sample(pt.ModelParams.multinode(), 10, seed=1,
                             **RANGES)
    gp = [pg.label_at(0), pg.label_at(3)]
    new = pg.refine(gp, 5, seed=2)
    assert isinstance(new, pt.ArraySet)
    _same_array_sets(rg.refine(gp, 5, seed=2), new)


def test_subset_concat_and_params_at():
    ra, pa = _both("adaptive_sample", 100, seed=7,
                   mpi_transfer=["hockney", "loggp"], **RANGES)
    _same_array_sets(ra.subset([7, 3, 3]), pa.subset([7, 3, 3]))
    sub = pa.subset([7, 3, 3])
    assert sub.labels() == [pa.label_at(7), pa.label_at(3), pa.label_at(3)]
    assert pa.params_at(7).cxl_lat_ns == pytest.approx(
        pa.label_at(7)["cxl_lat_ns"])
    both = pt.ArraySet.concat(pa, pa)
    _same_array_sets(RefArraySet.concat(ra, ra), both)
    assert len(both) == 200 and both.label_at(150) == pa.label_at(50)
    _same_array_sets(RefArraySet.concat([ra, ra.subset([1])]),
                     pt.ArraySet.concat([pa, pa.subset([1])]))


def test_view_from_columns():
    """Varied fields are (n, 1) columns, the rest (1, 1) from the base;
    ``mem_lat_ns`` is full length; ``to`` keeps the codes int32."""
    _, pa = _both("adaptive_sample", 12, seed=2,
                  mpi_transfer=["hockney", "loggp"], **RANGES)
    v = pa.view()
    assert v.cxl_lat_ns.shape == (12, 1) and v.cxl_atomic_lat_ns.shape \
        == (12, 1)
    assert v.mpi_lat_ns.shape == (1, 1) and v.thr_mbw.lower.shape == (1, 1)
    assert v.mem_lat_ns.shape == (12, 1)
    assert v.mpi_transfer_code.shape == (12, 1)
    assert len(v.mpi_transfer_models) == 2
    assert v.free_transfer_code.shape == (1, 1)
    for dtype in (torch.float64, torch.float32):
        d = v.to("cpu", dtype)
        assert d.cxl_lat_ns.dtype == dtype and d.thr_mbw.upper.dtype == dtype
        assert d.mpi_transfer_code.dtype == torch.int32
        assert d.mpi_transfer_models[1].G_ns_per_byte.dtype == dtype
    padded = v._slice(slice(10, 12))._pad(8)
    assert padded.cxl_lat_ns.shape == (8, 1) and padded.mpi_lat_ns.shape \
        == (1, 1)
    np.testing.assert_array_equal(padded.cxl_lat_ns[2:],
                                  np.full((6, 1), v.cxl_lat_ns[11, 0]))


ERRORS = [
    ("n < 1", lambda c: c.adaptive_sample(c.ModelParams(), 0,
                                          cxl_lat_ns=(1.0, 2.0))),
    ("method", lambda c: c.adaptive_sample(c.ModelParams(), 4,
                                           method="sobol",
                                           cxl_lat_ns=(1.0, 2.0))),
    ("no ranges", lambda c: c.adaptive_sample(c.ModelParams(), 4)),
    ("not a pair", lambda c: c.adaptive_sample(c.ModelParams(), 4,
                                               cxl_lat_ns=(1.0, 2.0, 3.0))),
    ("lo > hi", lambda c: c.adaptive_sample(c.ModelParams(), 4,
                                            cxl_lat_ns=(3.0, 2.0))),
    ("unknown field", lambda c: c.adaptive_sample(c.ModelParams(), 4,
                                                  bogus=(1.0, 2.0))),
    ("unknown model", lambda c: c.adaptive_sample(c.ModelParams(), 4,
                                                  mpi_transfer=["nope"])),
    ("concat axes", lambda c: c.ArraySet.concat(
        c.adaptive_sample(c.ModelParams(), 4, **RANGES),
        c.adaptive_sample(c.ModelParams(), 4, cxl_lat_ns=(250.0, 700.0)))),
    ("concat empty", lambda c: c.ArraySet.concat([])),
    ("refine n", lambda c: c.adaptive_sample(
        c.ModelParams(), 4, **RANGES).refine([{}], 0)),
    ("refine points", lambda c: c.adaptive_sample(
        c.ModelParams(), 4, **RANGES).refine([], 3)),
    ("refine ranges", lambda c: c.ParamGrid.product(
        c.ModelParams(), cxl_lat_ns=[250.0, 400.0]).refine(
            [{"cxl_lat_ns": 300.0}], 4)),
    ("not a grid", lambda c: c.as_array_set([c.ModelParams()])),
]


@pytest.mark.parametrize("name,fn", ERRORS, ids=[e[0] for e in ERRORS])
def test_error_cases_match_reference(name, fn):
    with pytest.raises(Exception) as want:
        fn(ref)
    with pytest.raises(want.type) as got:
        fn(pt)
    assert str(got.value) == str(want.value)


# ------------------------------------------------- pricing an ArraySet

@pytest.mark.parametrize("backend", ["numpy", "torch", "fused"])
def test_array_set_prices_like_its_grid(compiled, backend):
    """An ArraySet prices bit for bit like the equal ParamGrid in the port
    (codes indexing ``choices`` against codes by first appearance), and
    within rtol 1e-12 of the reference's numpy backend."""
    rcb, pcb = compiled
    kw = dict(seed=5, mpi_transfer=["loggp", "hockney"],
              free_transfer=["two_atomic", "message_free"], **RANGES)
    pg = pt.ParamGrid.sample(pt.ModelParams.multinode(), 24, **kw)
    pa = pt.as_array_set(pg)
    ra = ref.adaptive_sample(ref.ModelParams.multinode(), 24, **kw)
    plan = pt.ExecPlan(backend, device="cpu")
    rg_res, ra_res = pt.price(pcb, pg, plan=plan), pt.price(pcb, pa, plan=plan)
    want = ref.price(rcb, ra, plan=ref.ExecPlan("numpy"))
    for f in pt.MATRIX_FIELDS:
        np.testing.assert_array_equal(getattr(ra_res, f), getattr(rg_res, f))
        np.testing.assert_allclose(getattr(ra_res, f), getattr(want, f),
                                   rtol=1e-12, atol=0)
    assert ra_res.grid is pa and ra_res.summary_rows() == \
        rg_res.summary_rows()


# ------------------------------------------- the "distributed" backend

def _check_streaming(res, want, topk, count):
    """A streaming result against the reference's full matrix result."""
    sp = want.predicted_speedup()
    np.testing.assert_array_equal(res.indices, want.topk(topk))
    np.testing.assert_allclose(res.speedups, sp[res.indices], rtol=1e-9,
                               atol=0)
    np.testing.assert_allclose(res.result.gain_ns, want.gain_ns[res.indices],
                               rtol=1e-9, atol=0)
    agg, ragg = res.aggregates, ref.SweepAggregates.from_result(want)
    assert agg.count == ragg.count == count
    np.testing.assert_array_equal(agg.hist, ragg.hist)
    np.testing.assert_array_equal(agg.n_beneficial, ragg.n_beneficial)
    np.testing.assert_allclose(
        [agg.speedup_mean, agg.speedup_min, agg.speedup_max],
        [ragg.speedup_mean, ragg.speedup_min, ragg.speedup_max], rtol=1e-9)
    np.testing.assert_allclose(agg.gain_sum, ragg.gain_sum, rtol=1e-9)


@pytest.mark.parametrize("devices", [1, 2, 4])
def test_distributed_uneven_shards_match_reference(compiled, devices):
    """S=37 with chunk=10 never divides evenly: every chunk goes through
    the pad-and-mask path, and padded rows must not leak into the top-k,
    the histogram or ``n_beneficial`` on any shard count."""
    rcb, pcb = compiled
    ra, pa = _both("adaptive_sample", 37, seed=4,
                   mpi_transfer=["hockney", "loggp"],
                   cxl_lat_ns=(250.0, 700.0))
    res = pt.price(pcb, pa, plan=pt.ExecPlan(
        "distributed", device="cpu", chunk_scenarios=10, topk=9,
        devices=devices))
    assert isinstance(res, pt.TopKSweepResult) and len(res) == 9
    _check_streaming(res, ref.price(rcb, ra), 9, 37)
    assert res.shard_rows == padded_size(10, devices) // devices
    assert res.best_scenario() == int(res.indices[0])
    assert res.labels() == [pa.label_at(int(i)) for i in res.indices]
    assert len(res.summary_rows()) == 9


def test_distributed_refine_matches_reference(compiled):
    """``refine=2`` on the reference test's 100-scenario seed: the same
    refined scenarios (seed r + 1, window 0.25 * 0.5**r), the same
    survivors in the same order, speedups within 1e-9."""
    rcb, pcb = compiled
    ra, pa = _both("adaptive_sample", 100, seed=7,
                   mpi_transfer=["hockney", "loggp"], **RANGES)
    want = ref.price(rcb, ra, plan=ref.ExecPlan.parse(
        "distributed:topk=16,chunk=32,refine=2,devices=1"))
    res = pt.price(pcb, pa, plan=pt.ExecPlan.parse(
        "distributed:device=cpu,chunk=32,topk=16,refine=2"))
    assert len(res.scenarios) == 300
    _same_array_sets(want.scenarios, res.scenarios)
    np.testing.assert_array_equal(res.indices, want.indices)
    np.testing.assert_allclose(res.speedups, want.speedups, rtol=1e-9, atol=0)
    np.testing.assert_allclose(res.result.gain_ns, want.result.gain_ns,
                               rtol=1e-9, atol=0)
    assert list(res.speedups) == sorted(res.speedups, reverse=True)
    _check_streaming(res, ref.price(rcb, want.scenarios), 16, 300)


def test_distributed_launches_one_kernel_call_per_chunk(compiled,
                                                        monkeypatch):
    """The streaming path prices each chunk with one call of the fused
    kernel's wrapper and the survivors with one more — never the unfused
    executor."""
    calls = []
    wrapper = pt_sweep_kernel.fused_bracket_segsum

    def counting(*args, **kw):
        calls.append(args[3].shape[0])
        return wrapper(*args, **kw)

    monkeypatch.setattr(pt_sweep_kernel, "fused_bracket_segsum", counting)
    monkeypatch.setattr(pt_sweep_kernel, "_bracket_seg_terms", None)
    _, pa = _both("adaptive_sample", 50, seed=1, **RANGES)
    res = pt.price(compiled[1], pa,
                   plan="distributed:device=cpu,chunk=16,topk=4,refine=1")
    assert calls == [16] * 8 + [4]         # 4 padded chunks a round
    assert len(res.scenarios) == 100 and res.aggregates.count == 100


def test_stream_state_compaction_keeps_exact_topk():
    """The reference test's case, on both packages' accumulators."""
    rng = np.random.default_rng(0)
    vals = rng.uniform(0.5, 1.5, size=64)
    states = _StreamState(n_calls=2, k=4), RefStreamState(n_calls=2, k=4)
    for j in range(0, 64, 8):
        chunk = {
            "top_val": vals[j:j + 8][None], "top_ok": np.ones((1, 8), bool),
            "top_idx": np.arange(j, j + 8, dtype=np.int64)[None],
            "front_val": vals[j:j + 8][None],
            "front_ok": np.ones((1, 8), bool),
            "front_idx": np.arange(j, j + 8, dtype=np.int64)[None],
            "count": np.array([8]), "sp_sum": np.array([vals[j:j + 8].sum()]),
            "sp_min": np.array([vals[j:j + 8].min()]),
            "sp_max": np.array([vals[j:j + 8].max()]),
            "hist": np.zeros((1, N_HIST), np.int64),
            "n_beneficial": np.zeros((1, 2), np.int64),
            "gain_sum": np.zeros((1, 2)),
        }
        for state in states:
            state.add(chunk)
    state, rstate = states
    assert sum(map(len, state.cand_val)) <= 4 * state.k + 8
    idx, val = state.topk()
    order = np.lexsort((np.arange(64), -vals))[:4]
    np.testing.assert_array_equal(idx, order)
    np.testing.assert_array_equal(val, vals[order])
    closest = np.lexsort((np.arange(64), np.abs(vals - 1.0)))[:4]
    assert set(closest) <= set(state.frontier_indices(4))
    np.testing.assert_array_equal(state.frontier_indices(4),
                                  rstate.frontier_indices(4))
    for a, b in zip(dataclasses.astuple(state.aggregates()),
                    dataclasses.astuple(rstate.aggregates())):
        np.testing.assert_array_equal(a, b)


def test_distributed_edge_cases(compiled):
    """An empty set, ``topk`` beyond the set, a ParamGrid with a string
    plan, and an explicit transfer-model override."""
    rcb, pcb = compiled
    cpu = "distributed:device=cpu"
    empty = pt.price(pcb, pt.ParamGrid.from_params([]), plan=cpu)
    assert len(empty) == 0 and empty.aggregates.count == 0
    assert empty.shard_rows == 0 and empty.result.gain_ns.shape == (0, 3)
    with pytest.raises(ValueError, match="empty"):
        empty.best_scenario()

    rg, pg = _both("adaptive_sample", 6, seed=2, **RANGES)
    res = pt.price(pcb, pg, plan=cpu + ",topk=64")
    assert len(res) == 6                      # every scenario survives
    _check_streaming(res, ref.price(rcb, rg), 64, 6)

    rg = ref.ParamGrid.product(ref.ModelParams.multinode(),
                               cxl_lat_ns=[250.0, 350.0, 500.0, 700.0],
                               cxl_atomic_lat_ns=[300.0, 430.0, 653.0])
    pg = pt.ParamGrid.product(pt.ModelParams.multinode(),
                              cxl_lat_ns=[250.0, 350.0, 500.0, 700.0],
                              cxl_atomic_lat_ns=[300.0, 430.0, 653.0])
    res = pt.price(pcb, pg, plan=cpu + ",topk=5,chunk=7")
    _check_streaming(res, ref.price(rcb, rg), 5, 12)
    assert res.result.grid.labels() == [pg.label_at(i) for i in res.indices]
    with pytest.raises(ValueError, match="recorded axis ranges"):
        pt.price(pcb, pg, plan=cpu + ",refine=1")

    ra, pa = _both("adaptive_sample", 40, seed=11, **RANGES)
    res = pt.price(pcb, pa, plan=cpu + ",topk=8",
                   mpi_transfer=pt.LogGPTransfer(800.0, 250.0, 0.02))
    _check_streaming(res, ref.price(rcb, ra, mpi_transfer=ref.LogGPTransfer(
        L_ns=800.0, o_ns=250.0, G_ns_per_byte=0.02)), 8, 40)


def test_distributed_shard_rows_bound(compiled):
    """S = 65,536 streamed in chunks of 8,192 over 4 shards: each shard
    holds 2,048 rows at a time, and every scenario is counted."""
    _, pa = _both("adaptive_sample", 65536, seed=1,
                  mpi_transfer=["hockney", "loggp"], **RANGES)
    res = pt.price(compiled[1], pa,
                   plan="distributed:device=cpu,chunk=8192,devices=4,topk=8")
    assert res.shard_rows == 2048 and res.shard_rows * 4 < len(pa) // 7
    assert res.aggregates.count == 65536
    assert int(res.aggregates.hist.sum()) == 65536
    sp = pt.price(compiled[1], pa.subset(res.indices),
                  plan="fused:device=cpu").predicted_speedup()
    np.testing.assert_allclose(res.speedups, sp, rtol=1e-9, atol=0)
    assert list(res.speedups) == sorted(res.speedups, reverse=True)
