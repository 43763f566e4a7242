"""The port's examples (``repro_torch.examples``) and record scripts
(``repro_torch.scripts``) on the CPU (``--device cpu``), their numbers
held to the JAX package's own functions on the same inputs:

* the quickstart's and the stencil advisor's per-call gains against the
  reference's ``predict_run`` (physics rtol 1e-12), the stencil on a 2 x 2
  grid against the oracle with both backends;
* the HPCG validation rows and overhead split against the reference's
  (1e-12), the PCG solve on 4 z-slabs with both backends;
* the sweep quickstart's gain matrices against the reference's
  ``price`` on its own compiled bundle (the sweep backends' 1e-9), its
  torch and fused drifts from numpy against the reference's ``jax``
  backend's (1e-9);
* ``train_lm --small`` lowers its loss in 6 steps; ``serve_lm`` returns
  the requested token counts from the static and the continuous engine;
* ``refresh_fits`` and ``update_experiments`` over a record that
  ``launch.dryrun.run_cell`` just wrote.

Every example's ``main`` runs once, at the smallest arguments."""
import json
import math

import numpy as np
import pytest
import torch.distributed as dist

from repro.apps.hpcg import validation as ref_hpcg
from repro.apps.stencil import validation as ref_stencil
from repro.apps.stencil.spec import StencilConfig as RefStencilConfig
from repro.apps.stencil.spec import build_spec as ref_build_spec
from repro.apps.stencil.spec import HALO_CALLS as REF_HALO_CALLS
import repro.core as ref
from repro.memsim import collect as ref_collect
from repro.memsim import NetworkParams as RefNetwork
from repro_torch.examples import (hpcg_analysis, quickstart, serve_lm,
                                  stencil_advisor, sweep_quickstart,
                                  train_lm)
from repro_torch.scripts import refresh_fits, update_experiments

RTOL_PHYSICS, RTOL_SWEEP = 1e-12, 1e-9
CPU = ["--device", "cpu"]


def _ref_run(tile, network=None):
    cfg = RefStencilConfig(tile=tile)
    kw = {} if network is None else {"network": network}
    bundle = ref_collect(ref_build_spec(cfg), bw_share=cfg.bw_share,
                         ranks_per_socket=cfg.ranks_per_socket, **kw)
    return ref.predict_run(bundle, ref.ModelParams.optane())


def _hold_calls(run, want):
    assert list(run.calls) == list(want.calls)
    for cid, c in run.calls.items():
        w = want.calls[cid]
        for k in ("t_mpi_ns", "t_cxl_ns", "gain_ns"):
            np.testing.assert_allclose(getattr(c, k), getattr(w, k),
                                       rtol=RTOL_PHYSICS, err_msg=cid)


def test_quickstart_matches_the_reference():
    _, _, run = quickstart.predictions()
    _hold_calls(run, _ref_run(128))
    errs = quickstart.stencil_errors("cpu")
    assert errs == {"message_based": 0.0, "message_free": 0.0}
    assert quickstart.main(CPU) == 0


def test_stencil_advisor_matches_the_reference():
    for tile, run, ns, we, _ in stencil_advisor.guidance():
        want = _ref_run(tile, RefNetwork.cross_numa())
        _hold_calls(run, want)
        np.testing.assert_allclose(
            ns, sum(want.calls[c].gain_ns for c in ("halo_N", "halo_S"))
            / 1e3, rtol=RTOL_PHYSICS)
        np.testing.assert_allclose(
            we, sum(want.calls[c].gain_ns for c in ("halo_W", "halo_E"))
            / 1e3, rtol=RTOL_PHYSICS)
    from repro_torch.apps.stencil.validation import multinode_prediction
    for kw in ({"tiles": (32, 128, 1024)},
               {"tiles": (32,), "optimistic": True}):
        for got, want in zip(multinode_prediction(**kw),
                             ref_stencil.multinode_prediction(**kw)):
            assert (got["tile"], got["halo"]) == (want["tile"], want["halo"])
            np.testing.assert_allclose(got["predicted_speedup"],
                                       want["predicted_speedup"],
                                       rtol=RTOL_PHYSICS)
    assert stencil_advisor.main(CPU) == 0


def test_hpcg_analysis_matches_the_reference():
    from repro_torch.apps.hpcg.validation import (overhead_breakdown,
                                                  run_validation)
    got = run_validation(sizes=hpcg_analysis.SIZES)
    want = ref_hpcg.run_validation(sizes=hpcg_analysis.SIZES)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.nx, g.scenario) == (w.nx, w.scenario)
        np.testing.assert_allclose(
            [g.reference_norm, g.predicted_norm],
            [w.reference_norm, w.predicted_norm], rtol=RTOL_PHYSICS)
    for g, w in zip(overhead_breakdown(sizes=(16, 128)),
                    ref_hpcg.overhead_breakdown(sizes=(16, 128))):
        assert (g["nx"], g["mode"]) == (w["nx"], w["mode"])
        np.testing.assert_allclose(g["transfer_frac"], w["transfer_frac"],
                                   rtol=RTOL_PHYSICS)
    solved = hpcg_analysis.solves("cpu")
    assert solved["message_based"] == solved["message_free"]
    res, err = solved["message_free"]
    assert res < 1e-6 and err < 1e-5
    assert hpcg_analysis.main(CPU) == 0


def test_sweep_quickstart_matches_the_reference():
    cb = sweep_quickstart.bundle()
    got = sweep_quickstart.sweeps(cb, "cpu")
    # the reference's walk-through, on its own bundle
    cfg = RefStencilConfig(tile=32, grid=(8, 8), ranks_per_socket=6)
    rcb = ref.compile_bundle(ref_collect(
        ref_build_spec(cfg), network=RefNetwork.multinode(),
        bw_share=cfg.bw_share, ranks_per_socket=cfg.ranks_per_socket))
    lg = ref.LogGPTransfer(L_ns=1200.0, o_ns=200.0,
                           G_ns_per_byte=1 / 24.715)
    ref.TRANSFER_MODELS["loggp_overhead"] = lambda p: lg
    mp = ref.ModelParams.multinode()
    grid = ref.ParamGrid.product(
        mp, cxl_lat_ns=[float(v) for v in np.linspace(250.0, 700.0, 8)],
        cxl_atomic_lat_ns=[float(v) for v in np.linspace(300.0, 800.0, 8)])
    sampled = ref.ParamGrid.sample(
        mp, 32, seed=0, cxl_lat_ns=(250.0, 700.0),
        cxl_atomic_lat_ns=(300.0, 800.0),
        mpi_transfer=["hockney", "loggp_overhead"])
    paper = ref.ParamGrid.zip(mp, cxl_lat_ns=[350.0, 300.0],
                              cxl_atomic_lat_ns=[430.0, 350.0])
    want = {"grid": ref.price(rcb, grid),
            "loggp": ref.price(rcb, grid, mpi_transfer=lg),
            "mixed": ref.price(rcb, ref.ParamGrid.product(
                mp, cxl_lat_ns=[300.0, 350.0, 400.0],
                mpi_transfer=["hockney", "loggp_overhead"])),
            "sampled": ref.price(rcb, sampled),
            "paper": ref.price(rcb, paper),
            "union": ref.price(rcb, ref.ParamGrid.concat(grid, sampled,
                                                         paper))}
    for name, w in want.items():
        np.testing.assert_allclose(got[name].gain_ns, w.gain_ns,
                                   rtol=RTOL_SWEEP, err_msg=name)
        np.testing.assert_allclose(
            got[name].predicted_speedup(replaced=set(REF_HALO_CALLS)),
            w.predicted_speedup(replaced=set(REF_HALO_CALLS)),
            rtol=RTOL_SWEEP, err_msg=name)
    ref_drift = sweep_quickstart.drift(
        ref.price(rcb, grid, plan=ref.ExecPlan("jax")), want["grid"])
    for name in ("torch", "fused", "chunked"):
        d = sweep_quickstart.drift(got[name], got["grid"])
        assert d <= RTOL_SWEEP and abs(d - ref_drift) <= RTOL_SWEEP, name
    assert np.array_equal(got["chunked"].gain_ns, got["grid"].gain_ns)
    assert sweep_quickstart.main(CPU) == 0


def test_serve_lm_returns_the_requested_tokens():
    args = serve_lm.arguments(CPU + ["--batch", "4", "--prompt-len", "8",
                                     "--new-tokens", "6"])
    _, out, _ = serve_lm.serve(args)
    assert tuple(out.shape) == (4, 6)
    args.continuous = True
    _, outs, _ = serve_lm.serve(args)
    assert [len(o) for o in outs] == [6 - 3 * (i % 3) for i in range(4)]
    assert serve_lm.main(CPU + ["--arch", "jamba-v0.1-52b", "--batch", "2",
                                "--prompt-len", "8", "--new-tokens", "4",
                                "--continuous"]) == 0


def test_train_lm_small_lowers_its_loss(tmp_path):
    assert train_lm.main(CPU + ["--small", "--steps", "6", "--seq", "32",
                                "--batch", "4", "--log-every", "1",
                                "--ckpt-dir", str(tmp_path)]) == 0
    assert any(tmp_path.iterdir())                 # the checkpoint


def test_record_scripts_over_a_fresh_record(tmp_path):
    """``run_cell`` writes ``qwen2.5-3b x decode_32k`` on (16, 16);
    ``refresh_fits`` recomputes the same analytic footprint and verdicts
    against the H100's 80 GB, and ``update_experiments`` writes its row
    between the table's markers (twice: replaced, not appended)."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_ranks, make_mesh
    init_fake_ranks(256)
    try:
        mesh = make_mesh((16, 16), ("data", "model"), "cpu")
        rec = dryrun.run_cell(ARCHS["qwen2.5-3b"], SHAPES["decode_32k"],
                              mesh)
    finally:
        dist.destroy_process_group()
    mdir = tmp_path / "16x16"
    mdir.mkdir()
    path = mdir / "qwen2.5-3b__decode_32k.json"
    stale = dict(rec, memory=dict(rec["memory"], fits_hbm=False,
                                  analytic_live_bytes={}))
    path.write_text(json.dumps(stale))
    (mdir / "broken.json").write_text(json.dumps(
        {"arch": "gemma-7b", "shape": "train_4k", "status": "error"}))
    assert refresh_fits.main(["--root", str(tmp_path)]) == 0
    again = json.loads(path.read_text())
    assert again["memory"] == rec["memory"]
    assert refresh_fits.mesh_sizes("2x16x16") == (32, 16)
    out = tmp_path / "EXPERIMENTS.md"
    out.write_text("# notes\n")
    for _ in range(2):
        assert update_experiments.main(["--root", str(tmp_path), "--out",
                                        str(out)]) == 0
    text = out.read_text()
    assert text.startswith("# notes\n")
    assert text.count(update_experiments.BEGIN) == 1
    row = next(ln for ln in text.splitlines()
               if ln.startswith("| qwen2.5-3b | decode_32k |"))
    cells = [c.strip() for c in row.strip("|").split("|")]
    assert cells[5] == rec["roofline"]["dominant"] and cells[8] == "Y"
    assert math.isclose(float(cells[3]), rec["roofline"]["memory_s"],
                        rel_tol=1e-2)
    assert "| ERROR |" in text
