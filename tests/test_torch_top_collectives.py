"""``python -m repro_torch.analysis.top_collectives`` against the JAX
package's ``scripts/top_collectives.py``: on a gzip of the synthetic HLO
texts the advisor tests use, the port prints the same lines, with
``--sweep`` and without it (``--backend=numpy``).  The reference script
runs in a subprocess, as it is."""
import gzip
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import top_collectives
from test_price import SYNTH_HLO_B
from test_sweep import SYNTH_HLO

ROOT = Path(__file__).resolve().parents[1]


def _reference(path, *flags) -> str:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "scripts/top_collectives.py",
                           str(path), "12", *flags], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("text", [SYNTH_HLO, SYNTH_HLO_B],
                         ids=["synth", "synth_b"])
def test_same_lines_as_the_reference(text, tmp_path, capsys):
    path = tmp_path / "cell.hlo.gz"
    with gzip.open(path, "wt") as f:
        f.write(text)
    for flags in ((), ("--sweep",)):
        want = _reference(path, "--backend=numpy", *flags)
        assert top_collectives.main([str(path), "12", "--backend=numpy",
                                     *flags]) == 0
        got = capsys.readouterr().out
        assert got == want
        assert ("scenario sweep" in got) == bool(flags)


def test_usage_errors(tmp_path, capsys):
    assert top_collectives.main([]) == 1
    assert top_collectives.main([str(tmp_path / "none.gz")]) == 1
    assert top_collectives.main(["x.gz", "--backend=nope"]) == 1
    assert "usage:" in capsys.readouterr().err
