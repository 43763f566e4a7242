"""The port's two launchers on the CPU, in subprocesses, with the JAX
package's output lines; and without a card, that they refuse to run unless
the CPU is named.

* ``python -m repro_torch.launch.train --arch qwen2.5-3b --reduced
  --device cpu`` prints the reference driver's ``[train] step`` lines and
  ``final loss``; with ``--ckpt-dir`` and ``--fail-at-step`` it fails, and
  the next launch restores and finishes.
* ``python -m repro_torch.launch.serve --arch ... --reduced --device cpu``
  on the static, continuous and paged engines, with ``--price-sweep``,
  prints the reference driver's lines (checked against the JAX package's
  own serve driver, run the same way).
* ``import repro_torch.train`` / ``.launch.train`` / ``.launch.serve`` and
  a train step load no ``jax`` and no ``repro``.
"""
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.launch.train import train
from repro_torch.models.config import ShapeConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
       "JAX_PLATFORMS": "cpu"}


def _run(*args, ok=True):
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, env=ENV, timeout=300, cwd=ROOT)
    if ok:
        assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _shape(line):
    """A line with its numbers blanked and its runs of spaces (the
    numbers' padding) made one: the format, not the values."""
    return re.sub(r" +", " ", re.sub(r"-?\d+(\.\d+)?", "#", line))


def test_train_cli_on_the_cpu(tmp_path):
    out = _run("repro_torch.launch.train", "--arch", "qwen2.5-3b",
               "--reduced", "--steps", "5", "--seq", "32", "--batch", "4",
               "--micro", "2", "--device", "cpu").stdout.splitlines()
    assert [_shape(ln) for ln in out] == [
        "[train] step # loss # gnorm #", "[train] step # loss # gnorm #",
        "final loss: #"]
    assert out[0].startswith("[train] step     0 ")
    assert out[1].startswith("[train] step     4 ")
    assert out[2] == f"final loss: {float(out[1].split()[4]):.4f}"

    ck = ["repro_torch.launch.train", "--arch", "jamba-v0.1-52b",
          "--reduced", "--steps", "6", "--seq", "16", "--batch", "2",
          "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device", "cpu"]
    failed = _run(*ck, "--fail-at-step", "3", ok=False)
    assert failed.returncode != 0
    assert "RuntimeError: injected failure at step 3" in failed.stderr
    out = _run(*ck).stdout.splitlines()
    assert out[0] == "[train] restored step 2, resuming at 3"
    assert out[-1].startswith("final loss: ")


class _Writes:
    """A stdout that keeps each write apart."""

    def __init__(self):
        self.writes = []

    def write(self, text):
        self.writes.append(text)
        return len(text)

    def flush(self):
        pass


def test_train_cli_writes_each_line_whole(tmp_path, monkeypatch):
    """The ranks of a launch share its stdout, so each line the train
    launcher prints is one write, its text and newline together: no other
    rank's line can then land inside it (an unbuffered ``print`` writes the
    two apart)."""
    from repro_torch.launch import train as launch_train

    args = ["--arch", "qwen2.5-3b", "--reduced", "--seq", "16", "--batch",
            "2", "--log-every", "1", "--summary", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "1", "--device", "cpu"]
    lines = []
    for steps in ("2", "3"):             # the second run restores step 1
        out = _Writes()
        monkeypatch.setattr(sys, "stdout", out)
        assert launch_train.main(args + ["--steps", steps]) == 0
        monkeypatch.undo()
        assert all(w.endswith("\n") and w.count("\n") == 1
                   for w in out.writes), out.writes
        lines += [w[:-1] for w in out.writes]
    assert [_shape(ln) for ln in lines if not ln.startswith("{")] == [
        "[train] step # loss # gnorm #", "[train] step # loss # gnorm #",
        "final loss: #", "[train] restored step #, resuming at #",
        "[train] step # loss # gnorm #", "final loss: #"]
    summaries = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [[h["step"] for h in s["history"]] for s in summaries] == \
        [[0, 1], [2]]
    assert all(s["rank"] == 0 and s["world"] == 1 for s in summaries)


@pytest.mark.parametrize("engine", [[], ["--continuous"], ["--paged"]])
def test_serve_cli_on_the_cpu(engine):
    """The port's serve driver prints the JAX package's driver's lines
    (the numbers differ: weights and prompts are drawn otherwise)."""
    args = ["--arch", "jamba-v0.1-52b", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "8", *engine,
            "--price-sweep"]
    got = _run("repro_torch.launch.serve", *args, "--device", "cpu").stdout
    want = _run("repro.launch.serve", *args).stdout
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _shape(g), _shape(w)
        if g.startswith("  prefill@"):   # the paged engine's prefill length
            continue                     # differs (ROADMAP reference caveat)
        assert g == w


def test_launchers_need_the_card_or_the_cpu_named():
    cfg = configs.get_arch("qwen2.5-3b").reduced()
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, ShapeConfig("t", "train", 8, 2), 1)
    proc = _run("repro_torch.launch.serve", "--arch", "qwen2.5-3b",
                "--reduced", ok=False)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


_TRAIN_PROBE = r"""
import json, sys
import repro_torch.train as train_pkg
import repro_torch.launch.serve
from repro_torch.launch.train import train
from repro_torch import configs
from repro_torch.models.config import ShapeConfig
_, hist = train(configs.get_arch("falcon-mamba-7b").reduced(),
                ShapeConfig("t", "train", 16, 2), 2, log_every=1,
                device="cpu")
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "repro" or k.startswith("repro."))
print(json.dumps({"exports": len(train_pkg.__all__), "steps": len(hist),
                  "bad": bad}))
"""


def test_training_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _TRAIN_PROBE],
                          capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in ENV.items()
                               if k != "JAX_PLATFORMS"}, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out == {"exports": 9, "steps": 2, "bad": []}
