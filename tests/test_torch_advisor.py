"""The port's advisor and ``price`` of program subjects against the JAX
package's, on the same HLO text: ``test_price.py``'s HLO, ``FakeCompiled``,
mapping and ``FakeEngine`` cases, ``test_sweep.py``'s per-scenario advisor
check and ``test_sweep_many.py``'s multi-step advisor sweeps.

Bounds are the reference's: rtol 1e-9 on every matrix (``test_sweep.py``
and ``test_sweep_many.py`` hold their backends to it), on the port's
``numpy`` plan and its ``torch`` and ``fused`` plans on the CPU; call ids
and ``summary_rows`` equal.  The JAX package prices on its ``numpy``
backend.
"""
import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as pt
from test_price import SYNTH_HLO_A, SYNTH_HLO_B, FakeCompiled, FakeEngine
from test_sweep import SYNTH_HLO

RTOL = 1e-9
PLANS = ["numpy", "torch:device=cpu", "fused:device=cpu"]


def _grids(core_a=pt, core_b=ref):
    return tuple(core.ParamGrid.product(core.ModelParams.multinode(),
                                        cxl_lat_ns=[250.0, 350.0, 500.0],
                                        cxl_atomic_lat_ns=[350.0, 653.0])
                 for core in (core_a, core_b))


def assert_close(got, want):
    assert got.call_ids == want.call_ids
    for f in pt.MATRIX_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=0.0, err_msg=f)


def assert_multi_close(got, want):
    assert got.names == want.names
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("text", ["A", "B", "synth"])
def test_hlo_text_prices_as_reference(plan, text):
    hlo = {"A": SYNTH_HLO_A, "B": SYNTH_HLO_B, "synth": SYNTH_HLO}[text]
    pg, rg = _grids()
    got = pt.price(hlo, pg, plan=plan)
    want = ref.price(hlo, rg, plan=ref.ExecPlan("numpy"))
    assert isinstance(got, pt.SweepResult)
    assert_close(got, want)
    # an explicit default advisor and the advisor's own sweep agree
    adv = pt.CommAdvisor()
    assert_close(pt.price(hlo, pg, plan=plan, advisor=adv), want)
    assert_close(adv.sweep_text(hlo, pg, plan=plan), want)
    assert got.summary_rows() == want.summary_rows()


@pytest.mark.parametrize("plan", PLANS)
def test_compiled_artifact_prices_as_reference(plan):
    pg, rg = _grids()
    cost = {"flops": 3.0e9, "bytes accessed": 7.0e8}
    text = SYNTH_HLO_A.replace("add(%ar, %ar)", "negate(%ar)")
    got = pt.price(FakeCompiled(text, cost), pg, plan=plan)
    want = ref.price(FakeCompiled(text, cost), rg,
                     plan=ref.ExecPlan("numpy"))
    assert_close(got, want)
    assert_close(pt.CommAdvisor().sweep(FakeCompiled(text, cost), pg,
                                        plan=plan), want)


@pytest.mark.parametrize("plan", PLANS)
def test_mapping_of_compiled_steps(plan):
    pg, rg = _grids()
    steps = {"prefill": FakeCompiled(SYNTH_HLO_A),
             "decode": FakeCompiled(SYNTH_HLO_B)}
    got = pt.price(steps, pg, plan=plan)
    want = ref.price(steps, rg, plan=ref.ExecPlan("numpy"))
    assert got.names == ("prefill", "decode")
    assert_multi_close(got, want)
    sel = pt.price(steps, pg, plan=plan, names=["decode"])
    assert sel.names == ("decode",)
    assert_close(sel["decode"], want["decode"])
    assert_multi_close(pt.CommAdvisor().sweep_many(steps, pg, plan=plan),
                       want)


@pytest.mark.parametrize("plan", PLANS)
def test_serve_engine_dispatch(plan):
    pg, rg = _grids()
    eng = FakeEngine({"prefill@8": FakeCompiled(SYNTH_HLO_A),
                      "decode": FakeCompiled(SYNTH_HLO_B)})
    got = pt.price(eng, pg, plan=plan)
    want = ref.price(eng, rg, plan=ref.ExecPlan("numpy"))
    assert got.names == ("prefill@8", "decode")
    assert_multi_close(got, want)
    assert_multi_close(pt.CommAdvisor().sweep_serve(eng, pg, plan=plan),
                       want)
    assert got.summary_rows(weights={"decode": 64.0}) \
        == want.summary_rows(weights={"decode": 64.0})


def test_mixed_sequence_of_subjects():
    """HLO text, a compiled artifact and a trace bundle in one call."""
    pg, rg = _grids()
    p_bundle = pt.synthesize_bundle(SYNTH_HLO_B, {},
                                    pt.ModelParams.tpu_v5e_ici())
    r_bundle = ref.synthesize_bundle(SYNTH_HLO_B, {},
                                     ref.ModelParams.tpu_v5e_ici())
    got = pt.price([SYNTH_HLO_A, FakeCompiled(SYNTH_HLO), p_bundle], pg,
                   plan="numpy", names=["a", "b", "c"])
    want = ref.price([SYNTH_HLO_A, FakeCompiled(SYNTH_HLO), r_bundle], rg,
                     plan=ref.ExecPlan("numpy"), names=["a", "b", "c"])
    assert_multi_close(got, want)


def test_bad_subjects_raise():
    pg, _ = _grids()
    for subject in (12345, [12345], 3.5):
        with pytest.raises(TypeError, match="cannot price"):
            pt.price(subject, pg, plan="numpy")
    with pytest.raises(ValueError, match="names="):
        pt.price(SYNTH_HLO_A, pg, plan="numpy", names=["x"])


def test_default_plan_needs_a_card():
    pg, _ = _grids()
    if pt.ExecPlan().device == "cuda":
        import torch
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pt.price(SYNTH_HLO_A, pg)


def test_synthesized_bundles_agree():
    """The shared body on HLO text: same call ids, comms, samples, site
    metadata, counters and meta as the reference's."""
    for text in (SYNTH_HLO_A, SYNTH_HLO_B, SYNTH_HLO):
        for min_group in (2, 3, 5):
            a = pt.synthesize_bundle(text, {}, pt.ModelParams.tpu_v5e_ici(),
                                     min_group=min_group)
            b = ref.synthesize_bundle(text, {},
                                      ref.ModelParams.tpu_v5e_ici(),
                                      min_group=min_group)
            assert a.meta == b.meta
            assert vars(a.counters) == vars(b.counters)
            assert list(a.call_sites) == list(b.call_sites)
            for cid in a.call_sites:
                sa, sb = a.call_sites[cid], b.call_sites[cid]
                assert sa.meta == sb.meta
                assert [(c.bytes, c.count) for c in sa.comms] \
                    == [(c.bytes, c.count) for c in sb.comms]
                assert [(s.lat_ns, s.source.name, s.weight)
                        for s in sa.samples] \
                    == [(s.lat_ns, s.source.name, s.weight)
                        for s in sb.samples]


def test_advisor_sweep_matches_analyze_per_scenario():
    """``test_sweep.py``: each sweep row equals a dedicated scalar advisor
    with that row's params, and the reference's."""
    adv = pt.CommAdvisor()
    grid = adv.default_grid(n_lat=4, n_atomic=4)
    res = adv.sweep_text(SYNTH_HLO, grid, plan="numpy")
    want = ref.CommAdvisor().sweep_text(SYNTH_HLO,
                                        ref.CommAdvisor().default_grid(4, 4))
    assert res.gain_ns.shape == (16, 2)
    assert_close(res, want)
    rgrid = ref.CommAdvisor().default_grid(4, 4)
    for i in (0, 7, 15):
        rep = pt.CommAdvisor(grid.params[i]).analyze_text(SYNTH_HLO, {})
        rref = ref.CommAdvisor(rgrid.params[i]).analyze_text(SYNTH_HLO, {})
        assert rep.summary_rows() == rref.summary_rows()
        for j, cid in enumerate(res.call_ids):
            assert res.gain_ns[i, j] == pytest.approx(
                rep.run.calls[cid].gain_ns, rel=RTOL)


@pytest.mark.parametrize("plan", PLANS)
def test_advisor_sweep_text_many(plan):
    """``test_sweep_many.py``: every step's collectives under one grid,
    per-step results equal to per-step sweeps and to the reference's."""
    adv, radv = pt.CommAdvisor(), ref.CommAdvisor()
    grid, rgrid = adv.default_grid(3, 2), radv.default_grid(3, 2)
    texts = {"prefill": SYNTH_HLO_A, "decode": SYNTH_HLO_B}
    multi = adv.sweep_text_many(texts, grid, plan=plan)
    want = radv.sweep_text_many(texts, rgrid)
    assert multi.names == ("prefill", "decode")
    assert_multi_close(multi, want)
    for name, text in texts.items():
        assert_close(multi[name], adv.sweep_text(text, grid, plan=plan))
    assert multi["decode"].compiled.n_calls == 1
    rows = multi.summary_rows(weights={"decode": 64.0})
    assert len(rows) == len(grid)
    assert rows == want.summary_rows(weights={"decode": 64.0})


def test_advisor_sweep_text_many_costs_alignment():
    adv, radv = pt.CommAdvisor(), ref.CommAdvisor()
    grid = adv.default_grid(2, 2)
    multi = adv.sweep_text_many({"a": SYNTH_HLO_A, "b": SYNTH_HLO_B}, grid,
                                names=("b", "a"), plan="numpy")
    assert multi.names == ("b", "a")
    assert multi["a"].call_ids \
        == adv.sweep_text(SYNTH_HLO_A, grid, plan="numpy").call_ids
    costs = {"a": {"flops": 1e12, "bytes accessed": 5e9}, "b": None}
    got = adv.sweep_text_many({"a": SYNTH_HLO_A, "b": SYNTH_HLO_B}, grid,
                              costs=costs, plan="numpy")
    want = radv.sweep_text_many({"a": SYNTH_HLO_A, "b": SYNTH_HLO_B},
                                radv.default_grid(2, 2), costs=costs)
    assert_multi_close(got, want)
    with pytest.raises(ValueError, match="named steps"):
        adv.sweep_text_many([SYNTH_HLO_A], grid, costs={"a": {}})


def test_analyze_reports_agree():
    """``test_hlo_advisor.py``: verdicts flip with the params, as the
    reference's, and every report row agrees."""
    for kw in ({"mpi_lat_ns": 150_000.0},
               {"mpi_lat_ns": 0.0, "mpi_bw_Bpns": 1e6,
                "cxl_atomic_lat_ns": 1e7}):
        a = pt.CommAdvisor(pt.ModelParams.tpu_v5e_ici().replace(**kw)) \
            .analyze_text(SYNTH_HLO, {})
        b = ref.CommAdvisor(ref.ModelParams.tpu_v5e_ici().replace(**kw)) \
            .analyze_text(SYNTH_HLO, {})
        assert len(a.run.calls) == 2
        assert a.summary_rows() == b.summary_rows()
        assert a.step_gain_us == b.step_gain_us
        assert a.terms.as_dict() == b.terms.as_dict()
    compiled = FakeCompiled(SYNTH_HLO_B, {"flops": 2e9})
    assert pt.CommAdvisor().analyze_compiled(compiled).summary_rows() \
        == ref.CommAdvisor().analyze_compiled(compiled).summary_rows()


def test_default_grid_and_specs():
    a, b = pt.CommAdvisor().default_grid(3, 2), \
        ref.CommAdvisor().default_grid(3, 2)
    assert a.labels() == b.labels()
    assert vars(pt.TPU_V5E) == vars(ref.TPU_V5E)
    assert pt.CommAdvisor().spec == pt.TPU_V5E
    h = pt.H100
    assert (h.peak_bf16_flops, h.hbm_bw, h.hbm_bytes) == (989e12, 3.35e12,
                                                          80e9)
    assert h.ici_link_bw * h.ici_links == pytest.approx(900e9)
    assert set(vars(h)) == set(vars(pt.TPU_V5E))
