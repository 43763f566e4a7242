"""Import hygiene of the port: ``repro_torch`` (and ``chip_smoke.py``)
import neither ``jax`` nor the JAX package ``repro``, and no module of the
package imports ``torch.testing._internal`` (only tests may, for the fake
process group)."""
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "repro" or k.startswith("repro."))
print(json.dumps({"modules": len(names), "names": names, "bad": bad}))
"""

#: The modules of the parallel slice: the probe must import each of them.
PARALLEL_MODULES = {"repro_torch.parallel", "repro_torch.parallel.sharding",
                    "repro_torch.parallel.pipeline",
                    "repro_torch.parallel.transport",
                    "repro_torch.parallel.fsdp",
                    "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
                    "repro_torch.launch.perf_cell"}


#: The modules of the analysis tier: the probe must import each of them.
ANALYSIS_MODULES = {"repro_torch.lint", "repro_torch.analysis",
                    "repro_torch.analysis.lint",
                    "repro_torch.analysis.kernelcheck",
                    "repro_torch.analysis.dataflow",
                    "repro_torch.analysis.ircheck",
                    "repro_torch.analysis.top_collectives",
                    "repro_torch.kernels._plan"}


#: The program's spans and exchange counters: the probe must import each.
TRACING_MODULES = {"repro_torch.spans", "repro_torch.comm.counters"}


#: The 27-point operator's kernel package: the probe must import each.
STENCIL_MODULES = {"repro_torch.kernels.stencil27",
                   "repro_torch.kernels.stencil27.ops",
                   "repro_torch.kernels.stencil27.ref",
                   "repro_torch.kernels.stencil27.stencil27"}


#: The Mamba-2 state update's kernel package: the probe must import each.
MAMBA2_STATE_MODULES = {"repro_torch.kernels.mamba2_state",
                        "repro_torch.kernels.mamba2_state.ops",
                        "repro_torch.kernels.mamba2_state.ref",
                        "repro_torch.kernels.mamba2_state.mamba2_state"}


#: The port's examples and record scripts: the probe must import each.
EXAMPLE_MODULES = {f"repro_torch.examples.{n}" for n in (
    "quickstart", "sweep_quickstart", "stencil_advisor", "hpcg_analysis",
    "serve_lm", "train_lm")} | {"repro_torch.scripts.refresh_fits",
                                "repro_torch.scripts.update_experiments"}


def test_importing_every_port_module_loads_no_jax():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env=env, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["modules"] >= 75
    assert PARALLEL_MODULES <= set(out["names"])
    assert ANALYSIS_MODULES <= set(out["names"])
    assert EXAMPLE_MODULES <= set(out["names"])
    assert TRACING_MODULES <= set(out["names"])
    assert STENCIL_MODULES <= set(out["names"])
    assert MAMBA2_STATE_MODULES <= set(out["names"])
    assert out["bad"] == [], f"the port imported {out['bad']}"


def test_examples_and_scripts_load_no_jax():
    """Every example and record script, imported in a fresh interpreter,
    leaves jax and the JAX package out of ``sys.modules``."""
    code = ("import importlib, json, sys; [importlib.import_module(m) for m "
            f"in {sorted(EXAMPLE_MODULES)!r}]; "
            "print(json.dumps(sorted(k for k in "
            "sys.modules if k.split('.')[0] in ('jax', 'jaxlib', "
            "'repro'))))")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == []


def test_parallel_entry_points_load_no_jax():
    """``import repro_torch.parallel, repro_torch.parallel.fsdp,
    repro_torch.launch.mesh, repro_torch.launch.dryrun,
    repro_torch.launch.perf_cell`` in a fresh interpreter leaves jax and the
    JAX package out of ``sys.modules``."""
    code = ("import json, sys; import repro_torch.parallel, "
            "repro_torch.parallel.fsdp, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun, repro_torch.launch.perf_cell; "
            "print(json.dumps(sorted(k for k in "
            "sys.modules if k.split('.')[0] in ('jax', 'jaxlib', "
            "'repro'))))")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == []


def test_no_port_module_imports_torch_testing_internals():
    """The advisor's capture runs under fake tensors with no test-only
    helper: no source of the package (the new ``core.graph`` and
    ``core.advisor`` among them) names ``torch.testing._internal``.
    (``import torch`` itself loads a few of its modules, so the check is on
    the sources.)"""
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"core/graph.py", "core/advisor.py", "core/hlo.py",
            "core/analytic.py", "comm/collectives.py"} <= names
    for path in sorted(PORT.rglob("*.py")):
        assert "torch.testing._internal" not in path.read_text(), path


_FORBIDDEN = re.compile(r"^\s*(import\s+jax|from\s+jax"
                        r"|import\s+repro\b|from\s+repro\b)",
                        re.M)


def test_no_source_file_names_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 71
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


_SERVE_PROBE = r"""
import json, sys
import numpy as np
import repro_torch.serve as serve
from repro_torch import configs
from repro_torch.models import make_model
model = make_model(configs.get_arch("jamba-v0.1-52b").reduced(),
                   device="cpu")
eng = serve.ContinuousEngine(model=model, n_slots=2, max_len=16)
outs = eng.run([(np.arange(5) % 7, 3)])
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "repro" or k.startswith("repro."))
print(json.dumps({"exports": len(serve.__all__), "tokens": len(outs[0]),
                  "bad": bad}))
"""


def test_serving_loads_no_jax():
    """``repro_torch.serve`` imports and serves a request without jax."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", _SERVE_PROBE],
                          capture_output=True, text=True, env=env,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out == {"exports": 14, "tokens": 3, "bad": []}
