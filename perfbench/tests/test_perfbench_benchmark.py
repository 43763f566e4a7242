"""BENCHMARK.json against the benchmark's contract, and the harness finding
every piece by name."""
import json
import math
import re
import shutil

import pytest

from perfbench import catalog

BENCH = catalog.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert (catalog.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert PATH.fullmatch(path) and not path.startswith("/") \
            and ".." not in path.split("/")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) \
        and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_entries_names_units_and_keys(kind):
    entries = BENCH[kind]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        allowed = KEYS[kind] | ({"workloads"} if kind in ("end_to_end",
                                                          "per_layer")
                                else set())
        assert KEYS[kind] <= set(e) <= allowed, e
        assert NAME.fullmatch(e["name"]), e["name"]
        if kind in ("end_to_end", "per_layer"):
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if kind == "per_layer":
            assert _line(e["layer"])
        if kind == "configs":
            assert _line(e["source"]) and _line(e["why"])
            assert len(e["reduced"]) <= 16
            assert all(NAME.fullmatch(k) for k in e["reduced"])
            assert e["file"].startswith(BENCH["paths"][0] + "/")
        if kind == "workloads":
            assert NAME.fullmatch(e["config"])
            assert NAME.fullmatch(e["traffic"])
            assert e["chips"] in (1, 4) and _line(e["why"])


def test_setup_time_and_four_chip_share():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_run_seconds_fit_the_full_check():
    """A full check of 24 cells: 2 + 14 x 24 runs of ``run_seconds`` + 60,
    2 x 90 s of compiling a cell, 1,200 s spare, within 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    e2e = {m["name"] for m in catalog.metrics_of(BENCH, cell, "end_to_end")}
    per = catalog.metrics_of(BENCH, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in e2e, (cell, m["name"], m["moves"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_per_layer_metric_moves_a_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    cells = metric.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        catalog.cell_entry(BENCH, cell)
        assert metric["moves"] in {
            m["name"] for m in catalog.metrics_of(BENCH, cell, "end_to_end")}
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_a_layer_name_is_one_line_and_shared_letter_for_letter():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(_line(layer) for layer in layers)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_harness_finds_every_file_of_a_cell(cell):
    entry = catalog.cell_entry(BENCH, cell)
    wl = catalog.workload(cell)
    assert (wl["name"], wl["config"], wl["traffic"], wl["why"]) == (
        cell, entry["config"], entry["traffic"], entry["why"])
    cfg = catalog.config(entry["config"])
    conf = next(c for c in BENCH["configs"] if c["name"] == cfg["name"])
    assert (catalog.ROOT / conf["file"]).resolve() == \
        catalog.HERE / "configs" / f"{cfg['name']}.json"
    assert conf["source"] == cfg["source"]
    assert conf["reduced"] == cfg["reduced"]
    assert hasattr(catalog.app(cfg["app"]), "App")
    for kind in ("end_to_end", "per_layer"):
        for m in catalog.metrics_of(BENCH, cell, kind):
            assert callable(catalog.reader(m["name"]))
    assert set(wl["limits"]) and all(
        isinstance(v, float) and v > 0 for v in wl["limits"].values())


def test_names_outside_the_characters_are_refused():
    for bad in ("../x", "a/b", "a b", ".x", ""):
        with pytest.raises(ValueError):
            catalog.workload(bad)


def test_a_cell_and_a_metric_are_added_as_new_files_only(tmp_path,
                                                         monkeypatch):
    """A copy of the benchmark's folder gains a cell (the heat app, message
    based, tile 16) and a per-layer metric as new files, and BENCHMARK.json
    new entries; the harness runs the cell and reads the metric with no
    other file changed."""
    import time

    import torch

    from perfbench import harness
    copy = tmp_path / "perfbench"
    shutil.copytree(catalog.HERE, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(copy): p.read_bytes()
              for p in copy.rglob("*") if p.is_file()}
    wl = json.loads((copy / "workloads" /
                     "heat2d-fig7.t4096-mf.json").read_text())
    wl.update(name="heat2d-fig7.t16-mb", traffic="t16-mb",
              why="a new cell, message based at a small tile")
    wl["params"].update(tile=16, backend="message_based", check_patch=8,
                        check_jitter=2)
    wl["limits"] = {"patch_err": 1e-5, "heat_drift": 1e-6}
    (copy / "workloads" / "heat2d-fig7.t16-mb.json").write_text(
        json.dumps(wl))
    cfg = json.loads((copy / "configs" / "heat2d-fig7.json").read_text())
    cfg.update(name="heat2d-2x2", px=2, py=2)
    (copy / "configs" / "heat2d-2x2.json").write_text(json.dumps(cfg))
    wl["config"] = "heat2d-2x2"
    (copy / "workloads" / "heat2d-fig7.t16-mb.json").write_text(
        json.dumps(wl))
    (copy / "metrics" / "steps_in_window.py").write_text(
        "def read(ctx):\n    return ctx.steps\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "heat2d-2x2", "source": "x",
                             "file": "perfbench/configs/heat2d-2x2.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "heat2d-fig7.t16-mb",
                               "config": "heat2d-2x2", "traffic": "t16-mb",
                               "chips": 1, "why": wl["why"]})
    bench["end_to_end"].append({"name": "steps_in_window", "unit": "steps",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["heat2d-fig7.t16-mb"]})
    monkeypatch.setattr(catalog, "HERE", copy)
    out = harness.run_cell(torch, "heat2d-fig7.t16-mb", 2**40 + 3, 0.0,
                           False, "cpu", time.perf_counter(), bench=bench)
    assert out["correct"], out["checks"]
    assert out["metrics"]["steps_in_window"]["value"] == 1
    after = {p.relative_to(copy): p.read_bytes()
             for p in copy.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
    assert math.isfinite(out["metrics"]["step_ms"]["value"])
