"""Nothing the benchmark runs loads JAX or the JAX package (``repro``;
top-level names compared whole, so ``repro_torch`` is not ``repro``), the
reference loads nothing of the port, and a run without a card, or without
the port, prints no result."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import catalog, harness

FOREIGN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(folder):
    return [p for p in folder.rglob("*.py") if "tests" not in p.parts]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources(catalog.HERE):
        assert not _imports(path) & FOREIGN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources(catalog.HERE / "reference"):
        assert _imports(path) <= {"__future__", "torch"}, path


def test_foreign_names_are_compared_whole():
    assert harness.foreign_modules(["repro_torch", "repro_torch.apps",
                                    "jaxtyping", "torch"]) == []
    assert harness.foreign_modules(["jax.numpy", "repro.apps", "flax",
                                    "jaxlib.xla"]) == ["flax", "jax",
                                                       "jaxlib", "repro"]


def test_a_run_loads_no_jax(tmp_path):
    """Every module a run loads (the harness, each cell's app module and
    reference, every metric's reader, and the port's apps) in a fresh
    interpreter: none has a foreign top-level name."""
    code = (
        "import sys, json\n"
        "from perfbench import catalog, harness, control\n"
        "b = catalog.benchmark()\n"
        "for w in b['workloads']:\n"
        "    cfg = catalog.config(w['config'])\n"
        "    import torch\n"
        "    app = catalog.app(cfg['app']).App(torch, cfg, "
        "catalog.workload(w['name'])['params'], 1, 'cpu')\n"
        "    for kind in ('end_to_end', 'per_layer'):\n"
        "        for m in catalog.metrics_of(b, w['name'], kind):\n"
        "            catalog.reader(m['name'])\n"
        "print(json.dumps(harness.foreign_modules()))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(catalog.ROOT), str(catalog.ROOT / "src")])}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []


def _run(cwd, timeout=300):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "hpcg-256x8.mf",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, timeout=timeout,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def _no_result(out):
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _no_result(_run(catalog.ROOT))


def test_run_with_only_the_benchmark_prints_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder has no program to run."""
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(catalog.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))
