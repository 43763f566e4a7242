"""The port's sweep (scenario sets, ``compile_bundle``, ``price`` under the
numpy / torch / fused backends, ``SweepResult``) against the JAX package's.

Bounds are the reference's (``test_sweep_backends.py``): the port's host
``"numpy"`` backend within rtol 1e-12 of the reference's numpy backend, the
``"torch"`` and ``"fused"`` backends (here on the CPU: ``index_add_`` and
the fused kernel's plain version) within 1e-9.  Chunking is bit-identical.
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
from test_torch_physics import synthetic_bundle

RTOL = {"numpy": 1e-12, "torch": 1e-9, "fused": 1e-9}
BACKENDS = sorted(RTOL)


def _plan(backend, **kw):
    return pt.ExecPlan(backend, device="cpu", **kw)


@pytest.fixture(scope="module")
def bundles():
    return synthetic_bundle(ref), synthetic_bundle(pt)


@pytest.fixture(scope="module")
def compiled(bundles):
    return ref.compile_bundle(bundles[0]), pt.compile_bundle(bundles[1])


def _grids(ctor, *args, **kw):
    """The same constructor on both packages (base params by preset)."""
    base = kw.pop("base", "multinode")
    return (getattr(ref.ParamGrid, ctor)(ref.PAPER_PRESETS[base](), *args,
                                         **kw),
            getattr(pt.ParamGrid, ctor)(pt.PAPER_PRESETS[base](), *args,
                                        **kw))


def _assert_results_close(rr, pr, rtol, ctx=""):
    for f in pt.MATRIX_FIELDS:
        a, b = getattr(pr, f), getattr(rr, f)
        assert a.shape == b.shape and a.dtype == np.float64, (ctx, f)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=f"{ctx} {f}")
    np.testing.assert_allclose(pr.predicted_speedup(), rr.predicted_speedup(),
                               rtol=rtol, atol=0)


# ----------------------------------------------------------- scenario sets

def _same_scenarios(rg, pg):
    assert rg.labels() == pg.labels()
    assert len(rg) == len(pg)
    assert [dataclasses.asdict(p) for p in rg.params] == \
        [dataclasses.asdict(p) for p in pg.params]
    assert rg.cat == pg.cat and rg.axes == pg.axes and rg.ranges == pg.ranges
    for i in range(len(rg)):
        assert rg.label_at(i) == pg.label_at(i)


@pytest.mark.parametrize("ctor,args,kw", [
    ("product", (), dict(cxl_lat_ns=[250.0, 350.0, 500.0],
                         cxl_atomic_lat_ns=[350.0, 653.0],
                         mpi_transfer=["hockney", "loggp"])),
    ("sample", (37,), dict(seed=4, cxl_lat_ns=(250, 700),
                           cxl_atomic_lat_ns=(300, 800),
                           mpi_transfer=["hockney", "loggp"])),
    ("sample", (23,), dict(seed=9, method="uniform",
                           mem_lat_ns=(80, 120),
                           free_transfer=["message_free", "two_atomic"])),
    ("zip", (), dict(cxl_lat_ns=[300.0, 400.0, 500.0],
                     cxl_atomic_lat_ns=[350.0, 430.0, 800.0],
                     mpi_transfer=["loggp", "hockney", "loggp"])),
])
def test_scenario_sets_match(ctor, args, kw):
    _same_scenarios(*_grids(ctor, *args, **kw))


def test_concat_and_subset_match():
    ra, pa = _grids("product", cxl_lat_ns=[250.0, 400.0])
    rb, pb = _grids("sample", 5, seed=1, cxl_lat_ns=(250, 700),
                    mpi_transfer=["hockney", "loggp"])
    rc, pc = ref.ParamGrid.concat(ra, rb), pt.ParamGrid.concat(pa, pb)
    _same_scenarios(rc, pc)
    _same_scenarios(rc.subset([5, 0, 3]), pc.subset([5, 0, 3]))


# ---------------------------------------------------------------- backends

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("preset", sorted(ref.PAPER_PRESETS))
def test_backends_match_reference_on_every_preset(compiled, backend, preset):
    rg, pg = _grids("product", base=preset, cxl_lat_ns=[150.0, 400.0],
                    cxl_atomic_lat_ns=[200.0, 600.0])
    rr = ref.price(compiled[0], rg, plan=ref.ExecPlan("numpy"))
    pr = pt.price(compiled[1], pg, plan=_plan(backend))
    _assert_results_close(rr, pr, RTOL[backend], (preset, backend))


@pytest.mark.parametrize("backend", BACKENDS)
def test_backends_match_reference_on_categorical_axes(compiled, backend):
    rg, pg = _grids("sample", 24, seed=2, cxl_lat_ns=(250, 700),
                    cxl_atomic_lat_ns=(300, 800),
                    mpi_transfer=["hockney", "loggp"],
                    free_transfer=["message_free", "two_atomic"])
    rr = ref.price(compiled[0], rg, plan=ref.ExecPlan("numpy"))
    pr = pt.price(compiled[1], pg, plan=_plan(backend))
    _assert_results_close(rr, pr, RTOL[backend], backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_backends_match_reference_with_transfer_override(compiled, backend):
    rg, pg = _grids("product", cxl_lat_ns=[250.0, 350.0, 500.0])
    rr = ref.price(compiled[0], rg, plan=ref.ExecPlan("numpy"),
                   mpi_transfer=ref.LogGPTransfer(900.0, 150.0, 0.05))
    pr = pt.price(compiled[1], pg, plan=_plan(backend),
                  mpi_transfer=pt.LogGPTransfer(900.0, 150.0, 0.05))
    _assert_results_close(rr, pr, RTOL[backend], backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_rows_match_scalar_predictor(compiled, bundles, backend):
    _, pg = _grids("product", cxl_lat_ns=[250.0, 500.0],
                   cxl_atomic_lat_ns=[350.0, 653.0])
    res = pt.price(compiled[1], pg, plan=_plan(backend))
    for i, p in enumerate(pg.params):
        run = pt.predict_run(bundles[1], p)
        for cid, call in res.scenario_calls(i).items():
            for f in ("t_transfer_mpi_ns", "t_transfer_cxl_ns",
                      "t_access_mpi_ns", "t_access_cxl_ns"):
                np.testing.assert_allclose(getattr(call, f),
                                           getattr(run.calls[cid], f),
                                           rtol=1e-9)


def test_slice_end_to_end_matches_reference_pallas():
    """memsim -> compile_bundle -> ParamGrid.sample -> price: the port's
    fused path (plain version on the CPU) against the reference's Pallas
    backend in interpret mode."""
    rb = ref_collect(ref_build_spec(RefStencilConfig(
        512, grid=(8, 8), ranks_per_socket=6)),
        network=RefNetworkParams.multinode(), seed=0)
    pb = collect(build_spec(StencilConfig(512, grid=(8, 8),
                                          ranks_per_socket=6)),
                 network=NetworkParams.multinode(), seed=0)
    rg, pg = _grids("sample", 48, seed=0, cxl_lat_ns=(250, 700),
                    cxl_atomic_lat_ns=(300, 800))
    rr = ref.price(rb, rg, plan=ref.ExecPlan("pallas"))
    pr = pt.price(pb, pg, plan=_plan("fused"))
    _assert_results_close(rr, pr, 1e-9, "slice")


# -------------------------------------------------------------- edge cases

@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_grids(bundles, compiled, backend):
    res = pt.price(compiled[1], pt.ParamGrid.from_params([]),
                   plan=_plan(backend))
    assert res.t_access_cxl_ns.shape == (0, compiled[1].n_calls)
    assert res.predicted_speedup().shape == (0,)
    empty = pt.compile_bundle(pt.TraceBundle(counters=bundles[1].counters))
    _, pg = _grids("product", cxl_lat_ns=[250.0, 500.0])
    res = pt.price(empty, pg, plan=_plan(backend))
    assert res.t_transfer_mpi_ns.shape == (2, 0)
    rres = ref.price(ref.compile_bundle(ref.TraceBundle(
        counters=bundles[0].counters)), _grids("product",
                                               cxl_lat_ns=[250.0, 500.0])[0])
    np.testing.assert_array_equal(res.predicted_speedup(),
                                  rres.predicted_speedup())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("chunk", [1, 4, 7])
def test_chunking_is_bit_identical(compiled, backend, chunk):
    _, pg = _grids("sample", 19, seed=5, cxl_lat_ns=(250, 700),
                   mpi_transfer=["hockney", "loggp"])
    whole = pt.price(compiled[1], pg, plan=_plan(backend))
    part = pt.price(compiled[1], pg, plan=_plan(backend,
                                                chunk_scenarios=chunk))
    for f in pt.MATRIX_FIELDS:
        np.testing.assert_array_equal(getattr(part, f), getattr(whole, f))


@pytest.mark.parametrize("impl", ["reduceat", "index_add", "kernel"])
def test_segment_sum_impls_match_reference(compiled, impl):
    """Every segment-sum route (host reduceat, ``index_add_``, the kernel
    wrapper — its plain version on the CPU) against the reference's
    reduceat, on packed terms with empty segments."""
    from repro.core.sweep_kernel import _segment_sum_np as ref_segsum
    from repro_torch.core.sweep_kernel import _segment_sum
    rcb, pcb = compiled
    rng = np.random.default_rng(8)
    for grp in ("hit", "lfb", "miss"):
        n = len(getattr(pcb, grp + "_lat"))
        x = rng.normal(size=(5, n))
        want = ref_segsum(x, getattr(rcb, grp + "_starts"),
                          getattr(rcb, grp + "_counts"))
        got = _segment_sum(torch.from_numpy(x), getattr(pcb, grp + "_starts"),
                           getattr(pcb, grp + "_counts"),
                           getattr(pcb.tensors("cpu"), grp + "_seg"),
                           pcb.n_calls, impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------- results

def test_result_methods_match(compiled):
    """On identical matrices every SweepResult question has the reference's
    answer."""
    rg, pg = _grids("sample", 40, seed=3, cxl_lat_ns=(80, 900),
                    cxl_atomic_lat_ns=(100, 2000),
                    mpi_transfer=["hockney", "loggp"])
    rr = ref.price(compiled[0], rg, plan=ref.ExecPlan("numpy"))
    pr = pt.SweepResult(grid=pg, compiled=compiled[1],
                        **{f: getattr(rr, f).copy()
                           for f in pt.MATRIX_FIELDS})
    eq = np.testing.assert_array_equal
    eq(pr.speedup, rr.speedup)
    eq(pr.gain_ns, rr.gain_ns)
    eq(pr.n_beneficial(), rr.n_beneficial())
    eq(pr.ranked_call_indices(), rr.ranked_call_indices())
    for cap in (0, 3000, 10 ** 9):
        for a, b in zip(pr.prioritize_for_capacity(cap),
                        rr.prioritize_for_capacity(cap)):
            eq(a, b)
    for replaced in (None, ["recv_1"]):
        eq(pr.predicted_speedup(replaced), rr.predicted_speedup(replaced))
        assert pr.best_scenario(replaced) == rr.best_scenario(replaced)
        eq(pr.topk(5, replaced), rr.topk(5, replaced))
        assert pr.summary_rows(replaced) == rr.summary_rows(replaced)
        pa = pt.SweepAggregates.from_result(pr, replaced)
        ra = ref.SweepAggregates.from_result(rr, replaced)
        for f in dataclasses.fields(ra):
            eq(getattr(pa, f.name), getattr(ra, f.name))
    assert {k: dataclasses.astuple(v) for k, v in
            pr.scenario_calls(7).items()} == \
        {k: dataclasses.astuple(v) for k, v in rr.scenario_calls(7).items()}


def test_priced_results_agree(compiled):
    rg, pg = _grids("sample", 40, seed=3, cxl_lat_ns=(80, 900),
                    cxl_atomic_lat_ns=(100, 2000))
    rr = ref.price(compiled[0], rg, plan=ref.ExecPlan("numpy"))
    pr = pt.price(compiled[1], pg, plan=_plan("fused"))
    np.testing.assert_allclose(pr.predicted_speedup(), rr.predicted_speedup(),
                               rtol=1e-9)
    np.testing.assert_array_equal(pr.n_beneficial(), rr.n_beneficial())
    shim = pt.sweep_run(compiled[1], pg, plan="fused:device=cpu")
    listed = pt.price(compiled[1], list(pg.params), plan=_plan("fused"))
    for f in pt.MATRIX_FIELDS:
        np.testing.assert_array_equal(getattr(shim, f), getattr(pr, f))
        np.testing.assert_array_equal(getattr(listed, f), getattr(pr, f))


# ------------------------------------------------------- carrying across

def _ref_fields(cb):
    fields = {f.name: getattr(cb, f.name) for f in dataclasses.fields(cb)
              if isinstance(getattr(cb, f.name), np.ndarray)}
    fields.update(n_msgs=cb.traffic.n_msgs, total_bytes=cb.traffic.total_bytes,
                  gap_bytes=cb.traffic.gap_bytes)
    return fields


def _port_counters(c):
    return pt.CounterSet(**dataclasses.asdict(c))


def test_compiled_bundle_from_arrays_round_trips(compiled):
    rcb, pcb = compiled
    cb = pt.compiled_bundle_from_arrays(
        _ref_fields(rcb), counters=_port_counters(rcb.counters),
        sampling_period=rcb.sampling_period, call_ids=rcb.call_ids)
    for f in dataclasses.fields(pcb):
        a, b = getattr(cb, f.name), getattr(pcb, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype, f.name
        elif isinstance(b, pt.SiteTraffic):
            for g in ("n_msgs", "total_bytes", "gap_bytes"):
                np.testing.assert_array_equal(getattr(a, g), getattr(b, g))
        else:
            assert a == b, f.name
    _, pg = _grids("product", cxl_lat_ns=[250.0, 500.0])
    a = pt.price(cb, pg, plan=_plan("fused"))
    b = pt.price(pcb, pg, plan=_plan("fused"))
    for f in pt.MATRIX_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_compile_bundle_matches_reference(compiled):
    rcb, pcb = compiled
    for name, val in _ref_fields(rcb).items():
        mine = getattr(pcb, name) if hasattr(pcb, name) \
            else getattr(pcb.traffic, name)
        np.testing.assert_array_equal(mine, val, err_msg=name)
    for multiple in (8, 128):
        for grp, triple in rcb.padded_groups(multiple).items():
            for a, b in zip(pcb.padded_groups(multiple)[grp], triple):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype


def test_bundle_tensors_are_cached_per_device(compiled):
    pcb = compiled[1]
    t = pcb.tensors("cpu")
    assert pcb.tensors(torch.device("cpu")) is t
    assert t.hit_lat.dtype == torch.float64 and t.unpack.dtype == torch.bool
    assert set(t.groups) == {"hit", "lfb", "miss"}


# -------------------------------------------------------------- the plan

def test_exec_plan_round_trips_and_rejects_jax_backends():
    assert pt.ExecPlan() == pt.ExecPlan("fused", None, "cuda")
    for spec in ("fused", "numpy", "torch:chunk=8", "torch:device=cpu",
                 "fused:chunk=4,device=cuda:0", "distributed",
                 "distributed:device=cpu,x64=0,devices=4,topk=8,refine=1"):
        p = pt.ExecPlan.parse(spec)
        assert pt.ExecPlan.parse(p.to_string()) == p
        assert p.to_string() == spec
    assert pt.known_backends() == ("distributed", "fused", "numpy", "torch")
    assert pt.is_streaming("distributed")
    for name in ("jax", "pallas"):
        with pytest.raises(ValueError, match="unknown backend"):
            pt.ExecPlan.parse(name)
    for bad in ("torch:chunk=0", "torch:vmap=1", "torch:chunk=1,chunk=2",
                "torch:device"):
        with pytest.raises(ValueError):
            pt.ExecPlan.parse(bad)
    with pytest.raises(ValueError, match="already registered"):
        pt.register_backend("torch", pt.resolve_backend("fused"))
    torch_run = pt.resolve_backend("torch")
    assert pt.register_backend("torch", torch_run, overwrite=True) is torch_run


def test_no_fallback_to_the_cpu(compiled):
    """With no CUDA device present, every plan that names CUDA (the default
    plan included) raises instead of pricing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default plan prices there")
    _, pg = _grids("product", cxl_lat_ns=[250.0, 500.0])
    matrix = (None, "torch", pt.ExecPlan("fused", chunk_scenarios=1),
              pt.ExecPlan("fused", x64=False), "torch:x64=0")
    for plan in matrix + ("distributed", "distributed:topk=4,refine=1"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.price(compiled[1], pg, plan=plan)
    for plan in matrix:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.price([compiled[1], compiled[1]], pg, plan=plan)
    for plan in (None, "distributed"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.price(compiled[1], pt.ParamGrid.from_params([]), plan=plan)


def test_unported_subjects_raise_type_error(compiled):
    """HLO text, compiled artifacts and serve engines now price through
    the advisor (the name is kept from before it was ported): text with no
    collective prices to no call, an engine to its steps; anything else
    still raises ``TypeError``.  Lists and mappings of bundles price (the
    multi-bundle sweep)."""
    _, pg = _grids("product", cxl_lat_ns=[250.0])

    class Compiled:
        def as_text(self):
            return "HloModule m"

    class Engine:
        def compiled_steps(self):
            return {"decode": compiled[1]}

    for subject in ("HloModule m", Compiled()):
        res = pt.price(subject, pg, plan=_plan("numpy"))
        assert isinstance(res, pt.SweepResult) and res.call_ids == ()
    multi = pt.price(Engine(), pg, plan=_plan("numpy"))
    assert multi.names == ("decode",)
    mixed = pt.price([compiled[1], "HloModule m"], pg, plan=_plan("numpy"))
    assert len(mixed) == 2 and mixed[1].call_ids == ()
    with pytest.raises(TypeError, match="expected a TraceBundle"):
        pt.price(42, pg, plan=_plan("numpy"))
    single = pt.price(compiled[1], pg, plan=_plan("numpy"))
    for subject in ([compiled[1]], {"step": compiled[1]}):
        multi = pt.price(subject, pg, plan=_plan("numpy"))
        assert isinstance(multi, pt.MultiSweepResult) and len(multi) == 1
        for f in pt.MATRIX_FIELDS:
            np.testing.assert_array_equal(getattr(multi[0], f),
                                          getattr(single, f))
