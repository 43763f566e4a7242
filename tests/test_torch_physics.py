"""The port's scalar per-call path (characterization, access, transfer,
``predict_run``) against the JAX package's, on memsim stencil bundles and on
a synthetic bundle with every data source and an unpack site, for every
paper preset: rtol 1e-12."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as pt
from repro.apps.stencil.spec import StencilConfig, build_spec
from repro.memsim import NetworkParams, collect

RTOL = 1e-12
CALL_FIELDS = ("t_transfer_mpi_ns", "t_transfer_cxl_ns", "t_access_mpi_ns",
               "t_access_cxl_ns", "transfer_bytes", "buffer_bytes")


def synthetic_bundle(core, seed: int = 3, n_sites: int = 3):
    """Compact bundle covering all data sources + an unpack site, built with
    either package's record types (``core`` is ``repro.core`` or
    ``repro_torch.core``)."""
    rng = np.random.default_rng(seed)
    bundle = core.TraceBundle(sampling_period=500.0)
    bundle.counters = core.CounterSet(ld_ins=5e9, l1_ldm=6e8, l3_ldm=9e7,
                                      tot_cyc=3.1e9, imc_reads=2.2e8,
                                      wall_time_ns=1.5e9)
    sources = list(core.DataSource)
    for i in range(n_sites):
        cid = f"recv_{i}"
        for k in range(12):
            bundle.add_sample(core.LoadSample(
                call_id=cid, lat_ns=float(rng.uniform(5, 400)),
                source=sources[(i + k) % len(sources)],
                weight=float(rng.uniform(0.5, 3.0))))
        bundle.add_comm(core.CommRecord(call_id=cid, bytes=1024 * (i + 1),
                                        count=2 + i))
        site = bundle.call(cid)
        site.accesses_per_element = float(1.0 + 1.5 * i)
        site.loads_per_line = float(1.0 + i)
    if n_sites:
        bundle.call("recv_0").unpack = True
    return bundle


def stencil_bundles(tmp_path, tile, network):
    """The reference's memsim bundle, and the port's ``load`` of its save."""
    rb = collect(build_spec(StencilConfig(tile, grid=(8, 8),
                                          ranks_per_socket=6)),
                 network=getattr(NetworkParams, network)(), seed=0)
    rb.save(tmp_path)
    return rb, pt.TraceBundle.load(tmp_path)


def _params(preset):
    return ref.PAPER_PRESETS[preset](), pt.PAPER_PRESETS[preset]()


def _assert_runs_close(rr, pr):
    assert list(pr.calls) == list(rr.calls)
    for cid, rc in rr.calls.items():
        pc = pr.calls[cid]
        for f in CALL_FIELDS:
            np.testing.assert_allclose(getattr(pc, f), getattr(rc, f),
                                       rtol=RTOL, err_msg=f"{cid}.{f}")
    np.testing.assert_allclose(pr.predicted_speedup(), rr.predicted_speedup(),
                               rtol=RTOL)
    for c in ref.ALL_CATEGORIES:
        pc = pt.Category(c.value)
        np.testing.assert_allclose(
            float(pr.characterization.subsequent[pc]),
            rr.characterization.subsequent[c], rtol=RTOL, atol=1e-15)
        np.testing.assert_allclose(
            float(pr.characterization.first[pc]),
            rr.characterization.first[c], rtol=RTOL, atol=1e-15)


def test_presets_match():
    assert sorted(pt.PAPER_PRESETS) == sorted(ref.PAPER_PRESETS)
    for name in ref.PAPER_PRESETS:
        rp, pp = _params(name)
        assert dataclasses.asdict(pp) == dataclasses.asdict(rp)


@pytest.mark.parametrize("preset", sorted(ref.PAPER_PRESETS))
@pytest.mark.parametrize("tile,network", [(64, "multinode"),
                                          (1024, "on_numa")])
def test_predict_run_matches_on_stencil(tmp_path, preset, tile, network):
    rb, pb = stencil_bundles(tmp_path, tile, network)
    rp, pp = _params(preset)
    _assert_runs_close(ref.predict_run(rb, rp), pt.predict_run(pb, pp))


@pytest.mark.parametrize("preset", sorted(ref.PAPER_PRESETS))
def test_predict_run_matches_on_synthetic(preset):
    rp, pp = _params(preset)
    _assert_runs_close(ref.predict_run(synthetic_bundle(ref), rp),
                       pt.predict_run(synthetic_bundle(pt), pp))


def test_loggp_transfer_override_matches():
    rp, pp = _params("multinode")
    rr = ref.predict_run(synthetic_bundle(ref), rp,
                         mpi_transfer=ref.LogGPTransfer(900.0, 150.0, 0.05))
    pr = pt.predict_run(synthetic_bundle(pt), pp,
                        mpi_transfer=pt.LogGPTransfer(900.0, 150.0, 0.05))
    _assert_runs_close(rr, pr)


def test_characterization_stays_float64():
    """Python-scalar operands never drop the weights to float32."""
    pp = pt.ModelParams.multinode()
    ch = pt.Characterization.from_counters(synthetic_bundle(pt).counters, pp)
    for w in list(ch.first.values()) + list(ch.subsequent.values()):
        if isinstance(w, torch.Tensor):
            assert w.dtype == torch.float64
    assert pt.quadratic_weight(0.5, 0.0, 1.0).dtype == torch.float64
    assert float(pt.quadratic_weight(0.5, 0.0, 1.0)) == 0.25
