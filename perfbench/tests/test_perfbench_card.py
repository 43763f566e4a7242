"""The harness on the card at small sizes: every metric of both kinds of
run is read, the shares stay under 100%, and the check passes.  Marked
``cuda``; run on a machine with the card:

    python -m pytest -q -m cuda perfbench/tests
"""
import time

import pytest
import torch

from perfbench import catalog, harness

CASES = {
    "hpcg-256x8.mf": dict(config={**catalog.config("hpcg-256x8"),
                                  "nx": 32, "ny": 32, "nz": 32}),
    "heat2d-fig7.t4096-mf": dict(params={"tile": 256}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CASES))
@pytest.mark.parametrize("trace", [False, True])
def test_run_cell_on_the_card(card, cell, trace):
    out = harness.run_cell(torch, cell, 2**35 + 1, 0.2, trace, "cuda",
                           time.perf_counter(), **CASES[cell])
    assert out["correct"], out["checks"]
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in catalog.metrics_of(catalog.benchmark(), cell,
                                                  kind)}
    assert set(out["metrics"]) == want
    for name, m in out["metrics"].items():
        assert m["value"] > 0, name
        if m["unit"] == "%" and name != "idle_pct":
            assert m["value"] <= 100, (name, m["value"])
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
