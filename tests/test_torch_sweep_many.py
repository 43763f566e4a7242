"""The port's multi-bundle sweep (``price`` of a sequence or mapping of
bundles, ``concat_bundles``, ``MultiSweepResult``) and its float32 plans
against the JAX package's, on the same inputs.

Bounds are the reference's: ``test_sweep_many.py`` holds one batched
super-bundle evaluation to N per-bundle sweeps at 1e-9, and its numpy path
bit for bit; ``test_execplan.py`` holds a float32 plan within 1e-2 of
float64 on ``gain_ns``.  The port runs on the CPU (the fused kernel's
wrapper runs its plain version there); the JAX package in-process.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as pt
from repro.apps.stencil.spec import StencilConfig as RefStencilConfig
from repro.apps.stencil.spec import build_spec as ref_build_spec
from repro.memsim import NetworkParams as RefNetworkParams
from repro.memsim import collect as ref_collect
from repro_torch.apps.stencil import StencilConfig, build_spec
from repro_torch.memsim import NetworkParams, collect
from test_sweep_many import make_bundle as ref_make_bundle

RTOL = 1e-9
BACKENDS = ("numpy", "torch", "fused")


def make_bundle(core, seed: int, n_sites: int, period: float, wall: float):
    """``test_sweep_many.make_bundle`` with either package's record types:
    counters and sampling period differ per bundle, so the per-call repeat
    in the super-bundle matters."""
    rng = np.random.default_rng(seed)
    b = core.TraceBundle(sampling_period=period)
    b.counters = core.CounterSet(ld_ins=4e9 * (1 + seed),
                                 l1_ldm=5e8 + 1e8 * seed, l3_ldm=8e7,
                                 tot_cyc=3e9, imc_reads=2e8,
                                 wall_time_ns=wall)
    sources = list(core.DataSource)
    for i in range(n_sites):
        cid = f"b{seed}_recv{i}"
        for k in range(6 + 3 * i):
            b.add_sample(core.LoadSample(
                call_id=cid, lat_ns=float(rng.uniform(5, 400)),
                source=sources[(i + k) % len(sources)],
                weight=float(rng.uniform(0.5, 3.0))))
        b.add_comm(core.CommRecord(call_id=cid, bytes=2048 * (i + 1),
                                   count=1 + i))
        site = b.call(cid)
        site.accesses_per_element = 1.0 + 0.7 * i
        site.loads_per_line = 1.0 + i
    if n_sites:
        b.call(f"b{seed}_recv0").unpack = True
    return b


SPECS = [(0, 3, 500.0, 1.5e9), (1, 2, 900.0, 2.5e9), (2, 4, 100.0, 0.8e9)]


@pytest.fixture(scope="module")
def bundles():
    """The reference test's three bundles, built by the reference's own
    ``make_bundle`` and by the port, compiled by each package."""
    rb = [ref.compile_bundle(ref_make_bundle(*s)) for s in SPECS]
    pb = [pt.compile_bundle(make_bundle(pt, *s)) for s in SPECS]
    return rb, pb


def _grids(**axes):
    return (ref.ParamGrid.product(ref.ModelParams.multinode(), **axes),
            pt.ParamGrid.product(pt.ModelParams.multinode(), **axes))


GRID = dict(cxl_lat_ns=[250.0, 350.0, 500.0], cxl_atomic_lat_ns=[350.0, 653.0])


def _plan(backend, **kw):
    return pt.ExecPlan(backend, device="cpu", **kw)


def _assert_close(got, want, rtol=RTOL, ctx=""):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.call_ids == w.call_ids
        for f in pt.MATRIX_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert a.shape == b.shape, (ctx, i, f)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0,
                                       err_msg=f"{ctx} {i} {f}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_price_list_matches_reference_sweep_run_many(bundles, backend):
    rb, pb = bundles
    rg, pg = _grids(**GRID)
    want = ref.sweep_run_many(rb, rg, plan=ref.ExecPlan("numpy"))
    got = pt.price(pb, pg, plan=_plan(backend))
    assert isinstance(got, pt.MultiSweepResult)
    assert got.names == want.names == ("bundle0", "bundle1", "bundle2")
    _assert_close(got, want, ctx=backend)
    _assert_close(got, [pt.price(b, pg, plan=_plan(backend)) for b in pb],
                  ctx=backend)
    np.testing.assert_allclose(got.predicted_speedup(),
                               want.predicted_speedup(), rtol=RTOL)
    np.testing.assert_array_equal(got.n_beneficial(), want.n_beneficial())
    assert got[1].compiled is pb[1]


def test_numpy_super_bundle_is_bit_identical(bundles):
    """The host path is elementwise in the per-call counter columns, so the
    super-bundle run equals the per-bundle runs bit for bit."""
    _, pb = bundles
    _, pg = _grids(**GRID)
    multi = pt.price(pb, pg, plan="numpy")
    for got, b in zip(multi, pb):
        single = pt.price(b, pg, plan="numpy")
        for f in pt.MATRIX_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(single, f))


def test_price_mapping_with_names(bundles):
    rb, pb = bundles
    rg, pg = _grids(**GRID)
    rmap = dict(zip(("prefill", "decode", "embed"), rb))
    pmap = dict(zip(("prefill", "decode", "embed"), pb))
    got = pt.price(pmap, pg, plan=_plan("fused"))
    assert got.names == ("prefill", "decode", "embed")
    assert got["decode"] is got[1]
    picked = pt.price(pmap, pg, plan=_plan("fused"),
                      names=("embed", "prefill"))
    want = ref.price(rmap, rg, plan=ref.ExecPlan("numpy"),
                     names=("embed", "prefill"))
    assert picked.names == want.names == ("embed", "prefill")
    _assert_close(picked, want)
    shim = pt.sweep_run_many(pb, pg, names=["a", "b", "c"],
                             plan="fused:device=cpu")
    assert shim.names == ("a", "b", "c")
    _assert_close(shim, got, rtol=0)
    with pytest.raises(ValueError, match="1 names for 3 bundles"):
        pt.price(pb, pg, plan=_plan("fused"), names=["a"])
    with pytest.raises(ValueError, match="names= labels"):
        pt.price(pb[0], pg, plan=_plan("fused"), names=["a"])


def test_zero_call_bundle_in_the_middle(bundles):
    rb, pb = bundles

    def empty(core):
        b = core.TraceBundle(sampling_period=123.0)
        b.counters = core.CounterSet(ld_ins=1e9, wall_time_ns=1e9)
        return b

    rg, pg = _grids(**GRID)
    want = ref.sweep_run_many([rb[0], empty(ref), rb[1]], rg)
    for backend in BACKENDS:
        got = pt.price([pb[0], empty(pt), pb[1]], pg, plan=_plan(backend))
        assert got[1].gain_ns.shape == (len(pg), 0)
        _assert_close(got, want, ctx=backend)


def test_empty_bundle_list():
    rg, pg = _grids(**GRID)
    got = pt.price([], pg, plan=_plan("fused"))
    want = ref.sweep_run_many([], rg)
    assert isinstance(got, pt.MultiSweepResult) and len(got) == 0
    assert list(got) == []
    np.testing.assert_array_equal(got.predicted_speedup(),
                                  want.predicted_speedup())
    assert got.summary_rows() == want.summary_rows()


def test_concat_bundles_matches_reference(bundles):
    rb, pb = bundles
    rsup, psup = ref.concat_bundles(rb), pt.concat_bundles(pb)
    assert psup.call_ids == rsup.call_ids and psup.n_calls == 9
    for f in dataclasses.fields(rsup):
        a, b = getattr(psup, f.name), getattr(rsup, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype, f.name
    for f in ("n_msgs", "total_bytes", "gap_bytes"):
        np.testing.assert_array_equal(getattr(psup.traffic, f),
                                      getattr(rsup.traffic, f))
    for f in dataclasses.fields(rsup.counters):
        np.testing.assert_array_equal(getattr(psup.counters, f.name),
                                      getattr(rsup.counters, f.name))
    assert psup.baseline_runtime_ns == rsup.baseline_runtime_ns
    # the per-call columns reach the pricing device as tensors
    t = psup.tensors("cpu", torch.float32)
    assert t.counters.wall_time_ns.dtype == torch.float32
    assert t.sampling_period.shape == (9,)
    assert isinstance(pb[0].tensors("cpu").sampling_period, float)
    with pytest.raises(ValueError):
        pt.concat_bundles([])


def test_per_call_counter_metrics_match_reference(bundles):
    """``Metrics.from_counters`` takes per-call counter columns (NumPy or
    tensors) as the reference does."""
    rsup = ref.concat_bundles(bundles[0])
    psup = pt.concat_bundles(bundles[1])
    p, rp = pt.ModelParams.multinode(), ref.ModelParams.multinode()
    want = ref.Metrics.from_counters(rsup.counters, rp)
    for counters in (psup.counters, psup.tensors("cpu").counters):
        got = pt.Metrics.from_counters(counters, p)
        for f in dataclasses.fields(want):
            np.testing.assert_allclose(np.asarray(getattr(got, f.name)),
                                       getattr(want, f.name), rtol=1e-15)


def test_chunking_is_bit_identical(bundles):
    _, pb = bundles
    _, pg = _grids(**GRID)
    for backend in BACKENDS:
        whole = pt.price(pb, pg, plan=_plan(backend))
        parts = pt.price(pb, pg, plan=_plan(backend, chunk_scenarios=2))
        for a, b in zip(whole, parts):
            for f in pt.MATRIX_FIELDS:
                np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def test_categorical_axes_and_memsim_bundles():
    """Fig. 7 stencil bundles from both packages' memsim (byte-identical
    files), under categorical transfer-model axes."""
    axes = dict(cxl_lat_ns=[250.0, 500.0], mpi_transfer=["hockney", "loggp"],
                free_transfer=["message_free", "two_atomic"])
    rg, pg = _grids(**axes)
    rb = [ref_collect(ref_build_spec(RefStencilConfig(
        t, grid=(8, 8), ranks_per_socket=6)),
        network=RefNetworkParams.multinode(), seed=0) for t in (32, 512)]
    pb = [collect(build_spec(StencilConfig(t, grid=(8, 8),
                                           ranks_per_socket=6)),
                  network=NetworkParams.multinode(), seed=0)
          for t in (32, 512)]
    want = ref.sweep_run_many(rb, rg, plan=ref.ExecPlan("pallas"))
    for backend in BACKENDS:
        _assert_close(pt.price(pb, pg, plan=_plan(backend)), want,
                      ctx=backend)


def test_deployment_weights(bundles):
    rb, pb = bundles
    rg, pg = _grids(**GRID)
    names = ["prefill", "decode", "embed"]
    got = pt.price(pb, pg, plan=_plan("fused"), names=names)
    want = ref.price(rb, rg, plan=ref.ExecPlan("numpy"), names=names)

    class StepMix:
        def step_weights(self):
            return {"prefill": 1.0, "decode": 128.0, "embed": 1.0,
                    "prefill_chunk@16": 7.0}

    for w in (None, {"decode": 128.0}, [1.0, 2.0, 0.5], StepMix()):
        np.testing.assert_allclose(got.predicted_speedup(weights=w),
                                   want.predicted_speedup(weights=w),
                                   rtol=RTOL)
        np.testing.assert_allclose(got.predicted_runtime_ns(weights=w),
                                   want.predicted_runtime_ns(weights=w),
                                   rtol=RTOL)
        assert got.best_scenario(weights=w) == want.best_scenario(weights=w)
    np.testing.assert_array_equal(
        got.predicted_speedup(weights=StepMix()),
        got.predicted_speedup(weights={"decode": 128.0}))
    rows, rrows = got.summary_rows(), want.summary_rows()
    assert [r.keys() for r in rows] == [r.keys() for r in rrows]
    for r, rr in zip(rows, rrows):
        np.testing.assert_allclose(list(r.values())[2:],
                                   list(rr.values())[2:], rtol=RTOL)
    with pytest.raises(ValueError, match="1 weights for 3 bundles"):
        got.predicted_speedup(weights=[1.0])


def test_streaming_plan_rejected_for_multi_bundle(bundles):
    _, pb = bundles
    _, pg = _grids(**GRID)
    from repro_torch.core.sweep import _sweep_plan_many
    for call in (lambda: pt.price(pb, pg, plan="distributed:device=cpu"),
                 lambda: _sweep_plan_many(pb, pg, pt.ExecPlan.parse(
                     "distributed:device=cpu"))):
        with pytest.raises(ValueError, match="streaming"):
            call()


# ------------------------------------------------------- float32 plans

@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_float32_plan_within_reference_bound(bundles, backend):
    """``x64=False`` prices in float32 (the view, the bundle's constants
    and the kernel's float instantiation) within 1e-2 of the reference's
    float64 on ``gain_ns``, the reference's bound; ``"numpy"`` stays
    float64."""
    rb, pb = bundles
    rg, pg = _grids(**GRID)
    for rcb, pcb in zip(rb, pb):
        want = ref.price(rcb, rg, plan=ref.ExecPlan("numpy"))
        got = pt.price(pcb, pg, plan=_plan(backend, x64=False))
        err = np.max(np.abs(got.gain_ns - want.gain_ns)
                     / np.maximum(np.abs(want.gain_ns), 1.0))
        assert 0 < err < 1e-2, err
        assert (torch.device("cpu"), torch.float32) in pcb._cache("_tensors")
    multi = pt.price(pb, pg, plan=_plan(backend, x64=False))
    _assert_close(multi, ref.sweep_run_many(rb, rg), rtol=1e-2)
    host = pt.price(pb[0], pg, plan="numpy:x64=0")
    np.testing.assert_array_equal(host.gain_ns,
                                  pt.price(pb[0], pg, plan="numpy").gain_ns)


def test_exec_plan_new_options_parse_and_round_trip():
    for spec in ("distributed", "distributed:devices=4,topk=16,refine=2",
                 "fused:x64=0", "torch:device=cpu,x64=0",
                 "distributed:chunk=32,device=cpu,x64=0,devices=2,topk=1",
                 "numpy:chunk=64"):
        p = pt.ExecPlan.parse(spec)
        assert pt.ExecPlan.parse(p.to_string()) == p
        assert p.to_string() == spec
    p = pt.ExecPlan.parse("distributed:devices=8,topk=64,refine=3")
    assert (p.devices, p.topk, p.refine, p.x64) == (8, 64, 3, True)
    assert p.to_string() == "distributed:devices=8,refine=3"
    assert pt.ExecPlan.parse("fused:x64=false") == pt.ExecPlan(x64=False)
    assert pt.ExecPlan(x64=False).dtype == torch.float32
    assert pt.ExecPlan().dtype == torch.float64
    assert pt.ExecPlan("torch").executor() is pt.resolve_backend("torch")
    assert pt.is_streaming("distributed")
    assert not any(pt.is_streaming(n) for n in ("numpy", "torch", "fused"))
    for bad, msg in (("fused:x64=2", "takes 0/1"),
                     ("distributed:topk=0", "topk must be >= 1"),
                     ("distributed:devices=0", "devices must be >= 1"),
                     ("distributed:refine=-1", "refine must be >= 0"),
                     ("fused:x64", "needs a value")):
        with pytest.raises(ValueError, match=msg):
            pt.ExecPlan.parse(bad)
