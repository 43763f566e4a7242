"""Finding the benchmark's pieces by name.

``BENCHMARK.json`` at the root of the checkout names every cell, metric and
configuration; each is a file of its own under this folder:

- a cell: ``workloads/<cell>.json`` (its configuration, traffic parameters,
  the limits of its correctness check, and why it exists);
- a configuration: ``configs/<config>.json`` (sizes, source, ``reduced``,
  ``assumed``, and its ``app``);
- an app: ``apps/<app>.py``, named by the configuration's ``app``;
- a metric: ``metrics/<metric>.py``, whose ``read(ctx)`` gives its value.

So a later cell, configuration or metric is new files plus new entries in
``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: What a name may be made of (and so every file named after one).
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell_entry(bench: dict, cell: str) -> dict:
    """The ``workloads`` entry of ``cell`` in ``BENCHMARK.json``."""
    for entry in bench["workloads"]:
        if entry["name"] == cell:
            return entry
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def workload(cell: str) -> dict:
    return _json(HERE / "workloads" / f"{_checked(cell)}.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{_checked(name)}.json")


def _module(kind: str, name: str):
    path = HERE / kind / f"{_checked(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}.{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def app(name: str):
    """The module of app ``name``: it defines ``App``."""
    return _module("apps", name)


def reader(metric: str):
    """The ``read(ctx)`` of ``metric``."""
    return _module("metrics", metric).read


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The ``kind`` (``end_to_end`` or ``per_layer``) metrics that ``cell``
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]
