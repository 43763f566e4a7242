"""The granite cell at a size a test run holds, on the CPU: its app drives
the port's continuous engine, the check's reference holds it, the control
(the weights rounded through float8) fails the check, each planted fault
fails it, and the configuration's file is the registered model with its
published values.  The cell's limits hold here."""
import time

import pytest
import torch

from perfbench import catalog, control, harness, lm_counts
from perfbench.apps import granite

CELL = "granite4h-small-l10.dec256"
FULL = catalog.config("granite4h-small-l10")
#: Widths cut to a test's size; 6 layers, attention at 5.
CFG = {**FULL, "hidden_size": 64, "num_attention_heads": 4,
       "num_key_value_heads": 2, "intermediate_size": 32,
       "shared_intermediate_size": 64, "mamba_n_heads": 8,
       "mamba_d_head": 16, "mamba_d_state": 16, "mamba_chunk_size": 8,
       "num_local_experts": 8, "num_experts_per_tok": 3, "vocab_size": 256,
       "n_layers": 6, "dtype": "float32"}
PARAMS = {"slots": 4, "prompt_min": 5, "prompt_max": 40, "max_len": 48,
          "steps": 4, "check_rows": 2}
SEED = 2**40 + 11


def _run(patch=None, trace=False):
    return harness.run_cell(torch, CELL, SEED, 0.0, trace, "cpu",
                            time.perf_counter(), config=CFG, params=PARAMS,
                            patch=patch)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["checks"]["dropped_share"]["value"] == 0.0
    assert out["attempted"] == PARAMS["check_rows"] * PARAMS["steps"]


def test_the_control_fails_and_the_program_passes():
    lim = catalog.workload(CELL)["limits"]
    args = (torch, CELL, SEED, 1, "cpu", CFG, PARAMS, lim)
    program = control._reading(*args)
    rounded = control._reading(*args, dtype="float8_e4m3fn")
    assert all(program[k] <= lim[k] for k in lim), program
    assert not rounded["logit_err"] <= lim["logit_err"], rounded


@pytest.mark.parametrize("fault", sorted(granite.FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    out = _run(patch=lambda a: granite.FAULTS[fault](a, monkeypatch))
    assert not out["correct"] and out["failed"] > 0, out["checks"]


def test_every_fault_a_decode_can_have_is_planted():
    assert set(granite.FAULTS) == {"state_unchanged", "state_zeroed",
                                   "no_shared", "logit_raised"}


def test_the_file_is_the_registered_model_at_its_depth():
    from repro_torch import configs
    arch = granite.arch_of(FULL)
    want = configs.get_arch("granite-4.0-h-small").replace(
        name=FULL["name"], n_layers=10, remat=False)
    assert arch == want
    assert FULL["reduced"] == ["n_layers"] and FULL["num_hidden_layers"] == 40
    cat = {"num_local_experts": 72, "num_experts_per_tok": 10,
           "mamba_n_heads": 128, "mamba_d_head": 64, "mamba_d_state": 128,
           "vocab_size": 100352, "hidden_size": 4096}
    assert {k: FULL[k] for k in cat} == cat


def test_counts_at_the_cells_size():
    """8.36 B parameters, about 37.7 GB a step (9.66 GB of states each
    way) and 1.3 TFLOP."""
    c, slots = FULL, 256
    n = (9 * lm_counts.mamba2_weight_bytes(c)
         + lm_counts.attention_weight_bytes(c)
         + 10 * lm_counts.moe_weight_bytes(c)
         + lm_counts.head_weight_bytes(c))
    assert 16.6e9 < n < 16.9e9
    assert 9 * lm_counts.state_bytes(c, slots) == 9 * 256 * 128 * 64 * 128 * 4
    app = granite.App(torch, FULL, catalog.workload(CELL)["params"], SEED,
                      "cpu")
    pos = app.lengths
    assert 35e9 < lm_counts.step_bytes(c, slots, pos) < 40e9
    assert 1.1e12 < lm_counts.step_ops(c, slots, pos) < 1.5e12
    assert 10e-3 < app.step_least_s < 12.5e-3
    assert 1000 < app.lengths.mean() < 1800
    assert app.rows[0] == int(app.lengths.argmax())
