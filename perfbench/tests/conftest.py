"""The benchmark's tests import the port from ``src/`` and the benchmark as
the package ``perfbench``; run them from the root of the checkout:

    python -m pytest -q perfbench/tests
"""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def card():
    """The CUDA device, for tests marked ``cuda``; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
