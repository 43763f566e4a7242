"""The port's dataflow tier (``repro_torch.analysis.dataflow``), beside the
JAX package's (``tests/test_dataflow.py``).

The registered kernels' contracts run clean over every case: every output
element written, by one CTA, inside its array, every grid axis moving a
region, and each plan's shared memory split by buffer summing to the
plan's.  Seeded bad region maps trip exactly their rule: an off-by-one
grid (``tile-uncovered``), a map that ignores a parallel axis
(``write-race`` and ``dropped-grid-index``), a transposed map
(``block-oob``).  The reference's ``scratch-uninit`` / ``output-unwritten``
body-execution tests and its halo skip have no counterpart: the kernels'
bodies are CUDA (``chip_smoke.py``'s two-fill launches stand in for
them), and the halo exchange's windows are regions here.
"""
import json

import pytest

from repro_torch.analysis import dataflow as dfl
from repro_torch.analysis import kernelcheck as kc
from repro_torch.kernels import _plan


def rules_of(rep) -> set:
    return {f.rule for f in rep.findings}


def blocks(fn, shape=(32, 128), block=(8, 32)):
    """``tiles`` for a 2-D output cut in ``block``-sized tiles, CTA (x, y)
    writing tile ``fn(x, y)``."""
    def tiles(plan, cta):
        i, j = fn(cta[0], cta[1])
        return {"o": [((i * block[0], i * block[0] + block[0]),
                       (j * block[1], j * block[1] + block[1]))]}
    return tiles


def plan2(gx=4, gy=4, **kw):
    return _plan.LaunchPlan("k", (gx, gy, 1), (128, 1, 1), **kw)


PAR = ("parallel",) * 3


def analyze(tiles, plan=None, semantics=PAR, shape=(32, 128)):
    return dfl.analyze_plan(plan or plan2(), {"o": shape}, tiles, semantics,
                            kernel="t", case="c", src=("t.py", 3))


def test_repo_dataflow_is_clean():
    reports = dfl.check_dataflow()
    assert {r.kernel for r in reports} == set(kc.known_kernels())
    assert len(reports) == sum(len(kc._CASES[k]) for k in kc.known_kernels())
    for r in reports:
        assert r.status == "ok", (r.kernel, r.case,
                                  [str(f) for f in r.findings])
        assert r.metrics["grid_points"] >= 1 and r.metrics["regions"] >= 1


def test_contracts_resolve_for_all_kernels():
    for name in kc.known_kernels():
        contract = dfl.dataflow_contract(name)
        assert isinstance(contract, dfl.DataflowContract)
        assert contract.semantics == PAR


def test_smem_split_sums_to_each_plan():
    for r in dfl.check_dataflow():
        dyn = sum(b for _, b, k in r.smem if k == "dynamic")
        static = sum(b for _, b, k in r.smem if k == "static")
        assert (dyn, static) == (r.metrics["smem"],
                                 r.metrics["static_smem"]), r.case


def test_flash_main_shape_splits_the_kv_ring():
    (rep,) = [r for r in dfl.check_dataflow(["flash_attention"])
              if r.case.startswith("B=2,S=4096")]
    split = {n: b for n, b, _ in rep.smem}
    assert split == {"1024-byte alignment pad": 1024, "q tile": 32768,
                     "k ring": 3 * 32768, "v ring": 3 * 32768,
                     "mbarriers": 104}
    assert rep.metrics["grid_points"] == 64 * 32


def test_persistent_bracket_grid_covers_every_tile_once():
    contract = dfl.dataflow_contract("sweep_bracket")
    case = {"S": 5000, "n_max": 16, "n_seg": 3, "dtype": "float64",
            "occ": 1, "sms": 4}                  # 4 CTAs over 10 tiles
    rep = dfl.analyze_case("sweep_bracket", case, contract)
    assert rep.grid == (4, 1, 1) and rep.ok
    assert rep.metrics["regions"] == 4 * 10     # 4 outputs x 10 tiles


def test_halo_windows_on_both_routes():
    contract = dfl.dataflow_contract("halo_exchange")
    for case in ({"n": 5, "plane": (40, 40), "dtype": "float32"},
                 {"n": 5, "plane": (40, 40), "dtype": "float32",
                  "route": "flags"},
                 {"n": 2, "plane": (3, 5), "dtype": "float64"}):
        rep = dfl.analyze_case("halo_exchange", case, contract)
        assert rep.ok, (case, [str(f) for f in rep.findings])


# ------------------------------------------- seeded-bad finding classes

def test_seeded_uncovered_tile_off_by_one_grid():
    rep = analyze(blocks(lambda i, j: (i, j)), plan2(gx=3))
    assert rules_of(rep) == {"tile-uncovered"}
    (f,) = rep.findings
    assert "first unwritten element (24, 0)" in f.message


def test_seeded_write_race_and_dropped_index_on_a_parallel_axis():
    rep = analyze(blocks(lambda i, j: (0, j)))
    assert rules_of(rep) == {"write-race", "dropped-grid-index",
                             "tile-uncovered"}
    (f,) = [f for f in rep.findings if f.rule == "dropped-grid-index"]
    assert "grid axis x" in f.message


def test_seeded_write_race_alone():
    rep = analyze(blocks(lambda i, j: (i // 2, j)), plan2(gx=8),
                  shape=(32, 128))
    assert "write-race" in rules_of(rep)
    (f,) = [f for f in rep.findings if f.rule == "write-race"]
    assert "distinct parallel" in f.message


def test_revisiting_along_a_sequential_axis_is_legal():
    rep = analyze(blocks(lambda i, j: (i, 0), block=(8, 128)),
                  semantics=("parallel", "sequential", "parallel"))
    assert rep.ok


def test_seeded_oob_transposed_map():
    rep = analyze(blocks(lambda i, j: (j, i)), plan2(gx=4, gy=4),
                  shape=(32, 64))
    assert "block-oob" in rules_of(rep)


def test_region_of_the_wrong_rank_is_oob():
    rep = analyze(lambda p, cta: {"o": [((0, 8),)]})
    assert rules_of(rep) >= {"block-oob"}


def test_contract_grid_rank_mismatch_is_a_finding():
    rep = analyze(blocks(lambda i, j: (i, j)), semantics=("parallel",) * 2)
    assert rules_of(rep) == {"contract-mismatch"}


def test_grid_too_large_is_refused():
    rep = analyze(blocks(lambda i, j: (i, j)), plan2(gx=2000, gy=1000))
    assert rules_of(rep) == {"grid-too-large"}


def test_smem_split_mismatch_is_a_finding():
    rep = analyze(blocks(lambda i, j: (i, j)),
                  plan2(smem=100, buffers=(("a", 60, "dynamic"),)))
    assert rules_of(rep) == {"smem-split"}


def test_findings_carry_file_line_rule_message():
    (f,) = analyze(blocks(lambda i, j: (i, j)), plan2(gx=3)).findings
    assert str(f).startswith("t.py:3 tile-uncovered output 'o'")


def test_contract_rejects_unknown_semantics():
    with pytest.raises(ValueError, match="unknown grid-axis semantic"):
        dfl.DataflowContract(("parallel", "arbitrary", "parallel"),
                             None, None, None)


def test_kernel_without_dataflow_registration_is_skipped():
    @kc.register_kernel_checker("tmp_nodf", ({"n": 1},))
    def tmp(case):                                 # pragma: no cover
        return None
    try:
        (rep,) = dfl.check_dataflow(["tmp_nodf"])
        assert rep.status == "skipped" and "no dataflow contract" in rep.note
    finally:
        for reg in (kc._CHECKERS, kc._CASES, kc._DATAFLOW):
            reg.pop("tmp_nodf", None)


@pytest.fixture
def bad_registered_kernel():
    """A kernel whose contract's grid is one CTA short."""
    import sys
    import types
    mod = types.ModuleType("tmp_bad_dataflow")
    mod.DATAFLOW = dfl.DataflowContract(
        PAR, lambda c: plan2(gx=3), lambda c: {"o": (32, 128)},
        lambda c, p, cta: blocks(lambda i, j: (i, j))(p, cta))
    sys.modules[mod.__name__] = mod

    @kc.register_kernel_checker("tmp_bad", ({"n": 1},),
                                dataflow="tmp_bad_dataflow")
    def tmp(case):                                 # pragma: no cover
        return None
    yield "tmp_bad"
    for reg in (kc._CHECKERS, kc._CASES, kc._DATAFLOW):
        reg.pop("tmp_bad", None)
    sys.modules.pop(mod.__name__, None)


def test_cli_nonzero_exit_and_file_line_on_seeded_bad(bad_registered_kernel,
                                                      capsys):
    assert dfl.main(["--kernel", bad_registered_kernel]) == 1
    line = capsys.readouterr().out.splitlines()[0]
    assert " tile-uncovered " in line and "test_torch_dataflow.py:" in line


def test_cli_json_reports_seeded_findings(bad_registered_kernel, capsys):
    assert dfl.main(["--kernel", bad_registered_kernel, "--format",
                     "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["n_findings"] == 1
    assert payload["reports"][0]["findings"][0]["rule"] == "tile-uncovered"


def test_cli_clean_run_exit_zero(capsys):
    assert dfl.main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_cli_json_schema_on_clean_repo(capsys):
    assert dfl.main(["--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert set(payload) == {"tool", "n_findings", "n_skipped", "reports"}
    assert payload["tool"] == "repro_torch.analysis.dataflow"
    assert payload["n_findings"] == 0 and payload["n_skipped"] == 0
    assert set(payload["reports"][0]) >= {"kernel", "case", "status",
                                          "grid", "metrics", "smem",
                                          "findings"}


def test_cli_verbose_prints_smem_rows(capsys):
    assert dfl.main(["--kernel", "mamba_scan", "-v"]) == 0
    out = capsys.readouterr().out
    assert "static   ring" in out and "partial y" in out


def test_cli_unknown_kernel_exits_2(capsys):
    assert dfl.main(["--kernel", "nope"]) == 2
