"""The correctness check at sizes a test run holds: the control (the
program in the precision below the configuration's) fails it, the program
passes it, and a run with the timed path broken underneath comes out not
correct, once for each fault a cell can have (the apps' ``FAULTS``)."""
import time

import pytest
import torch

from perfbench import catalog, control, harness

HPCG = "hpcg-256x8.mf"
HEAT = "heat2d-fig7.t4096-mf"
#: 4 ranks x 16^3, 10 iterations a set: the cell's limits hold here.
HPCG_CFG = {**catalog.config("hpcg-256x8"), "ranks": 4, "nx": 16, "ny": 16,
            "nz": 16, "iterations": 10}
#: 2 x 2 ranks x 16^2: a plane of 1,024 points, whose total heat drifts
#: about 1e-9 a step in float32 (the cell's 2^30 points: about 1e-11), so
#: its limits are the tiny plane's own.
HEAT_CFG = {**catalog.config("heat2d-fig7"), "px": 2, "py": 2}
HEAT_PARAMS = {"tile": 16, "check_patch": 8, "check_jitter": 2,
               "trace_steps": 6}
HEAT_LIMITS = {"patch_err": 1e-5, "heat_drift": 1e-7}
SEED = 2**40 + 11


def _run(cell, patch=None, trace=False):
    if cell == HPCG:
        kw = dict(config=HPCG_CFG)
    else:
        kw = dict(config=HEAT_CFG, params=HEAT_PARAMS, limits=HEAT_LIMITS)
    return harness.run_cell(torch, cell, SEED, 0.0, trace, "cpu",
                            time.perf_counter(), patch=patch, **kw)


@pytest.mark.parametrize("cell", [HPCG, HEAT])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(cell, trace):
    out = _run(cell, trace=trace)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell,units", [(HPCG, 1), (HEAT, 6)])
def test_the_control_fails_and_the_program_passes(cell, units):
    if cell == HPCG:
        r = control.readings(torch, cell, SEED, units, "cpu",
                             config=HPCG_CFG)
    else:
        r = control.readings(torch, cell, SEED, units, "cpu",
                             config=HEAT_CFG, params=HEAT_PARAMS,
                             limits=HEAT_LIMITS)
    lim = r["limits"]
    assert all(r["program"][k] <= lim[k] for k in lim), r
    assert any(not r["control"][k] <= lim[k] for k in lim), r


FAULTS = [(cell, fault) for cell in (HPCG, HEAT)
          for fault in catalog.app(catalog.config(
              catalog.workload(cell)["config"])["app"]).FAULTS]


@pytest.mark.parametrize("cell,fault", list(FAULTS),
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    app = catalog.config(catalog.workload(cell)["config"])["app"]
    plant = catalog.app(app).FAULTS[fault]
    out = _run(cell, patch=lambda a: plant(a, monkeypatch))
    assert not out["correct"] and out["failed"] > 0, out["checks"]


@pytest.mark.parametrize("cell", [HPCG, HEAT])
def test_every_fault_a_cell_can_have_is_planted(cell):
    """A step that returns its state unchanged, half of the batch left
    out, the exchange between ranks left out, an answer altered."""
    app = catalog.config(catalog.workload(cell)["config"])["app"]
    assert set(catalog.app(app).FAULTS) == {
        "state_unchanged", "half_batch", "no_exchange", "answer_altered"}


def test_fault_readings_fail_every_fault():
    r = control.fault_readings(torch, HPCG, SEED, 1, "cpu", config=HPCG_CFG)
    lim = r["limits"]
    assert set(r["faults"]) == {"state_unchanged", "half_batch",
                                "no_exchange", "answer_altered"}
    for name, got in r["faults"].items():
        assert any(not got[k] <= lim[k] for k in lim), (name, got)
