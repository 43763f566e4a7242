"""The port's AST linter (``repro_torch.analysis.lint``), beside the JAX
package's (``repro.analysis.lint``, ``tests/test_lint.py``).

Each ``tests/fixtures/torch_lint/bad_*.py`` seeds exactly one rule's
violation; the linter must flag it (and only it), stay silent on the good
fixture, honour ``# repro_torch: noqa[...]`` pragmas, and exit clean on the
port and ``chip_smoke.py``.  The two linters' CLIs agree on exit codes and
JSON keys.  The reference's ``compat-drift`` mesh-seam and Pallas
allowlist tests and its ``donation-misuse`` fixture have no counterpart:
the port's compat policy is ``jax-import``, and PyTorch donates nothing
(the IR tier's ``inplace-dead`` checks in-place updates on captured
steps).
"""
import json
import re
from pathlib import Path

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint as port_lint
from repro_torch.analysis.lint import (_RULES, Finding, known_rules,
                                       lint_file, lint_paths, main,
                                       register_rule)

FIX = Path(__file__).parent / "fixtures" / "torch_lint"
ROOT = Path(__file__).resolve().parents[1]

BAD = {
    "bad_jax_import.py": "jax-import",
    "bad_kernel_fallback.py": "kernel-fallback",
    "bad_import_time_build.py": "import-time-build",
    "bad_host_sync.py": "host-sync-in-hot-path",
    "bad_compile_loop.py": "compile-in-loop",
    "bad_dtype_leak.py": "default-dtype-leak",
}


def _write(tmp_path, text: str, name: str = "f.py") -> Path:
    p = tmp_path / name
    p.write_text(text)
    return p


def test_all_rules_registered():
    assert set(BAD.values()) | {"unknown-noqa"} == set(known_rules())


@pytest.mark.parametrize("fname,rule", sorted(BAD.items()))
def test_bad_fixture_triggers_exactly_its_rule(fname, rule, capsys):
    findings = lint_file(FIX / fname)
    assert findings, f"{fname} must produce findings"
    assert {f.rule for f in findings} == {rule}
    assert main([str(FIX / fname)]) == 1          # CLI: nonzero on findings
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == len(findings)
    assert all(re.fullmatch(rf".*{fname}:\d+ {rule} \S.*", ln) for ln in out)


def test_seeded_fixtures_count_every_violation():
    counts = {f: len(lint_file(FIX / f)) for f in BAD}
    assert counts == {"bad_jax_import.py": 3, "bad_kernel_fallback.py": 1,
                      "bad_import_time_build.py": 2, "bad_host_sync.py": 3,
                      "bad_compile_loop.py": 2, "bad_dtype_leak.py": 2}


def test_good_fixture_is_clean():
    assert lint_file(FIX / "good_clean.py") == []


def test_pragmas_suppress_bare_and_bracketed(tmp_path):
    assert lint_file(FIX / "pragma_suppressed.py") == []
    # the same content without the pragmas does fire
    src = (FIX / "pragma_suppressed.py").read_text()
    bare = re.sub(r"  # repro_torch: noqa.*", "", src)
    rules = [f.rule for f in lint_file(_write(tmp_path, bare))]
    assert rules == ["default-dtype-leak", "import-time-build"]


def test_pragma_wrong_rule_does_not_suppress(tmp_path):
    p = _write(tmp_path, "import torch\n"
               "torch.set_default_dtype(torch.float64)"
               "  # repro_torch: noqa[compile-in-loop]\n")
    assert [f.rule for f in lint_file(p)] == ["default-dtype-leak"]


def test_reference_pragma_does_not_suppress_port_rules(tmp_path):
    p = _write(tmp_path, "import jax  # repro: noqa\n")
    assert [f.rule for f in lint_file(p)] == ["jax-import"]


def test_allow_paths_skip_a_rule(tmp_path):
    @register_rule("tmp-allowed", allow_paths=("*/launch/*.py",))
    def tmp(ctx):
        yield 1, "fires"
    try:
        p = _write(tmp_path, "x = 1\n")
        assert lint_file(p, rel="src/repro_torch/launch/a.py",
                         select=["tmp-allowed"]) == []
        assert [f.rule for f in lint_file(p, rel="src/repro_torch/core/a.py",
                                          select=["tmp-allowed"])] \
            == ["tmp-allowed"]
    finally:
        _RULES.pop("tmp-allowed", None)


def test_jax_import_any_spelling(tmp_path):
    p = _write(tmp_path, "import flax\nimport repro\n"
               "from repro import core\n__import__('jax')\n"
               "from . import repro\nimport repro_torch\n")
    assert [f.line for f in lint_file(p)] == [1, 2, 3, 4]


def test_kernel_fallback_library_entry_and_reraise(tmp_path):
    p = _write(tmp_path, "def f(lib, x):\n"
               "    try:\n"
               "        lib.fn('scan', x.dtype)(x)\n"
               "    except OSError:\n"
               "        print('no kernel')\n"
               "        raise\n"
               "    try:\n"
               "        lib.fn('scan', x.dtype)(x)\n"
               "    except OSError:\n"
               "        return None\n")
    fs = lint_file(p)
    assert [(f.rule, f.line) for f in fs] == [("kernel-fallback", 9)]


def test_import_time_build_skips_function_bodies_and_main(tmp_path):
    p = _write(tmp_path, "import subprocess\nimport torch\n\n"
               "def f(x=None):\n    return subprocess.run(['nvcc'])\n\n"
               "class A:\n    N = 3\n    def g(self):\n"
               "        return torch.cuda.device_count()\n\n"
               "if __name__ == '__main__':\n"
               "    subprocess.run(['nvidia-smi'])\n")
    assert lint_file(p) == []
    p = _write(tmp_path, "import triton\nimport torch\n"
               "def f(x=torch.cuda.device_count()):\n    return x\n", "g.py")
    assert [f.line for f in lint_file(p)] == [1, 3]


def test_host_sync_scalar_annotations_and_cold_functions(tmp_path):
    p = _write(tmp_path, "def train_step(params, n: int, t):\n"
               "    return int(n), float(t), params.tolist()\n"
               "def helper(t):\n    return t.item()\n")
    assert [(f.line, f.message.split()[0]) for f in lint_file(p)] \
        == [(2, ".tolist()"), (2, "float()")]


def test_hot_functions_live_in_the_registration():
    assert _RULES["host-sync-in-hot-path"].settings == (
        ("hot", port_lint.HOT_FUNCTIONS),)
    assert {"decode_step", "price_grid_fused", "price_topk_chunk",
            "train_step"} <= set(port_lint.HOT_FUNCTIONS)


def test_dtype_switch_restored_in_finally_is_clean(tmp_path):
    p = _write(tmp_path, "import torch\n"
               "def f():\n"
               "    old = torch.backends.cudnn.allow_tf32\n"
               "    torch.backends.cudnn.allow_tf32 = False\n"
               "    try:\n        pass\n"
               "    finally:\n"
               "        torch.backends.cudnn.allow_tf32 = old\n")
    assert lint_file(p) == []


def test_registry_rejects_duplicate_rule():
    with pytest.raises(ValueError, match="already registered"):
        @register_rule("jax-import")
        def dup(ctx):                              # pragma: no cover
            return []


def test_register_custom_rule_and_select():
    @register_rule("tmp-rule")
    def tmp(ctx):
        yield 1, "always fires"
    try:
        fs = lint_file(FIX / "good_clean.py", select=["tmp-rule"])
        assert [(f.rule, f.line) for f in fs] == [("tmp-rule", 1)]
    finally:
        _RULES.pop("tmp-rule", None)


def test_select_unknown_rule_errors():
    with pytest.raises(ValueError, match="unknown lint rule"):
        lint_file(FIX / "good_clean.py", select=["not-a-rule"])
    assert main(["--select", "not-a-rule", str(FIX)]) == 2


def test_unknown_noqa_pragma_is_a_finding(tmp_path):
    p = _write(tmp_path, "x = 1  # repro_torch: noqa[not-a-rule]\n"
               "y = 2  # repro_torch: noqa[jax-import]\n")
    findings = lint_file(p)
    assert [f.rule for f in findings] == ["unknown-noqa"]
    assert findings[0].line == 1
    assert "not-a-rule" in findings[0].message


def test_unknown_noqa_ignores_docstring_examples(tmp_path):
    p = _write(tmp_path, '"""Docs: # repro_torch: noqa[zzz]."""\nx = 1\n')
    assert lint_file(p) == []


def test_bare_noqa_carries_no_rule_names(tmp_path):
    assert lint_file(_write(tmp_path, "x = 1  # repro_torch: noqa\n")) == []


def test_cli_json_format(capsys):
    assert main(["--format", "json", str(FIX / "bad_dtype_leak.py")]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["tool"] == "repro_torch.lint"
    assert payload["n_findings"] == len(payload["findings"]) == 2
    f = payload["findings"][0]
    assert f["rule"] == "default-dtype-leak" and f["line"] >= 1
    assert f["path"].endswith("bad_dtype_leak.py")


def test_syntax_error_reported_not_raised(tmp_path):
    fs = lint_file(_write(tmp_path, "def f(:\n", "broken.py"))
    assert [f.rule for f in fs] == ["syntax-error"]


def test_finding_str_is_clickable():
    f = Finding("a/b.py", 7, "jax-import", "msg")
    assert str(f) == "a/b.py:7 jax-import msg"


def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in known_rules():
        assert rule in out


_PARITY = {
    "clean": ("x = 1\n", [], 0),
    "syntax": ("def f(:\n", [], 1),
    "unknown-rule": ("x = 1\n", ["--select", "not-a-rule"], 2),
}


@pytest.mark.parametrize("case", sorted(_PARITY))
def test_cli_exit_codes_and_json_keys_match_the_reference(case, tmp_path,
                                                          capsys):
    text, extra, rc = _PARITY[case]
    p = _write(tmp_path, text)
    got = []
    for mod in (port_lint, ref_lint):
        code = mod.main(["--format", "json", *extra, str(p)])
        out = capsys.readouterr().out
        got.append((code, json.loads(out) if out else None))
    (code_p, js_p), (code_r, js_r) = got
    assert code_p == code_r == rc
    if js_p is None:
        assert js_r is None
        return
    assert set(js_p) == set(js_r)
    assert [set(f) for f in js_p["findings"]] \
        == [set(f) for f in js_r["findings"]]
    assert [(f["line"], f["rule"]) for f in js_p["findings"]] \
        == [(f["line"], f["rule"]) for f in js_r["findings"]]


def test_repo_lints_clean():
    """The gate: the port and its chip script carry zero findings."""
    findings = lint_paths([ROOT / "src" / "repro_torch",
                           ROOT / "chip_smoke.py"])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_cli_runs_clean_on_the_repo_with_its_json_schema(capsys,
                                                        monkeypatch):
    monkeypatch.chdir(ROOT)
    assert main(["--format", "json"]) == 0          # the default paths
    payload = json.loads(capsys.readouterr().out)
    assert set(payload) == {"tool", "n_files", "n_findings", "findings"}
    assert payload["n_findings"] == 0 and payload["n_files"] >= 100


def test_linter_imports_only_the_standard_library():
    """``repro_torch.analysis`` and the CLI load no torch, numpy or jax,
    so the linter runs where none is installed."""
    import subprocess
    import sys
    code = ("import json, sys; import repro_torch.analysis, "
            "repro_torch.lint; print(json.dumps(sorted(k for k in "
            "sys.modules if k.split('.')[0] in ('torch', 'numpy', 'jax', "
            "'repro'))))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == []
