"""The readers of the program's spans and exchange counters
(``perfbench.span_window`` and the metrics that read it).

On the CPU, at the fault tests' sizes: a traced run reports
``exchange_bytes_per_step`` at its exact value and stays correct, the
device readers read nothing, and the harness's own traced window holds no
span of the program.  Marked ``cuda``: on the card every reader reads, and
``exchange_launches_per_step`` is the count worked out from the code.
"""
import time

import pytest
import torch

from perfbench import catalog, counts, harness, span_window, tracing
from perfbench.tests import test_perfbench_faults as faults

SPANS = {"hpcg.solve", "hpcg.apply_a", "hpcg.exchange", "hpcg.pdot",
         "heat.step", "heat.exchange", "heat.update"} \
    | {f"hpcg.v_cycle.L{i}" for i in range(4)}
DEVICE_READERS = {"operator_span_roofline", "exchange_step_ms",
                  "exchange_launches_per_step"}


def _hpcg_bytes_per_step(cfg) -> float:
    """A set's exchanged planes, two a rank at every ``apply_a``, over its
    iterations, in 1e6 B."""
    slab = (cfg["nz"], cfg["ny"], cfg["nx"])
    slabs = counts.hpcg_slabs(slab, cfg["levels"])
    per_set = counts.hpcg_applies_per_set(cfg["iterations"], len(slabs))
    itemsize = getattr(torch, cfg["dtype"]).itemsize
    nbytes = sum(c * 2 * cfg["ranks"] * s[1] * s[2] * itemsize
                 for c, s in zip(per_set, slabs))
    return nbytes / (cfg["iterations"] * 1e6)


def _heat_bytes_per_step(cfg, tile, itemsize=4) -> float:
    """Four strips of ``tile`` points a rank, in 1e6 B."""
    return cfg["px"] * cfg["py"] * 4 * tile * itemsize / 1e6


@pytest.mark.parametrize("cell", [faults.HPCG, faults.HEAT])
def test_a_traced_run_counts_the_exchanged_bytes_exactly(cell):
    out = faults._run(cell, trace=True)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    want = (_hpcg_bytes_per_step(faults.HPCG_CFG) if cell == faults.HPCG
            else _heat_bytes_per_step(faults.HEAT_CFG,
                                      faults.HEAT_PARAMS["tile"]))
    assert out["metrics"]["exchange_bytes_per_step"] == {
        "value": want, "unit": "MB/step"}
    assert not DEVICE_READERS & set(out["metrics"])


@pytest.mark.parametrize("cell", [faults.HPCG, faults.HEAT])
def test_only_the_spans_window_records_spans(cell, monkeypatch):
    """The harness's traced window runs with the spans off and holds none
    of them; the spans window, after it, holds them."""
    from repro_torch import spans
    windows = []
    traced = tracing.traced_window

    def spy(torch_, run, sync, on_card):
        recording = spans.is_recording()
        tr = traced(torch_, run, sync, on_card)
        windows.append((recording, {e.name for e in tr.profiler.events()}))
        return tr
    monkeypatch.setattr(tracing, "traced_window", spy)
    out = faults._run(cell, trace=True)
    assert out["correct"], out["checks"]
    assert len(windows) == 2
    (first_on, first), (second_on, second) = windows
    assert not first_on and not first & SPANS
    assert second_on and second & SPANS


def test_an_untraced_run_runs_no_spans_window():
    ctx = harness.Context(torch, None, 0.0, None)
    assert span_window.window(ctx) is None
    assert ctx.spans_window is None


#: The card case's shapes: HPCG at 8 x 32^3 (its four levels), heat at
#: 8 x 8 x 256^2.
CARD = {
    "hpcg-256x8.mf": dict(config={**catalog.config("hpcg-256x8"),
                                  "nx": 32, "ny": 32, "nz": 32}),
    "heat2d-fig7.t4096-mf": dict(params={"tile": 256}),
}


def _launches_per_step(cell) -> float:
    """From the code: HPCG's exchange is one halo kernel and the two
    Dirichlet fills, 11.22 a PCG iteration at 4 levels; heat's is two
    ``stack``s, four neighbour tables (``arange``, add, ``remainder``) and
    four gathers."""
    if cell == faults.HPCG:
        cfg = CARD[cell]["config"]
        slabs = counts.hpcg_slabs((cfg["nz"], cfg["ny"], cfg["nx"]),
                                  cfg["levels"])
        per_set = counts.hpcg_applies_per_set(cfg["iterations"], len(slabs))
        return 3 * sum(per_set) / cfg["iterations"]
    return 2 + 4 * 3 + 4


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CARD))
def test_the_span_readers_on_the_card(card, cell):
    out = harness.run_cell(torch, cell, 2**35 + 7, 0.2, True, "cuda",
                           time.perf_counter(), **CARD[cell])
    assert out["correct"], out["checks"]
    got = out["metrics"]
    want = {"exchange_step_ms", "exchange_launches_per_step",
            "exchange_bytes_per_step"}
    if cell == faults.HPCG:
        want.add("operator_span_roofline")
        assert 0 < got["operator_span_roofline"]["value"] <= 100
    assert want <= set(got)
    assert got["exchange_launches_per_step"]["value"] == pytest.approx(
        _launches_per_step(cell), rel=1e-12)
    assert got["exchange_step_ms"]["value"] > 0
