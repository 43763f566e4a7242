"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell asks
for.  It prints the card's name and power limit (once the window has
closed), then, as its last line of standard output, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number compared beside its limit, also the last lines of
standard error).  It exits non-zero, printing no result, without enough
CUDA devices, or if JAX or the JAX package is loaded once the window has
closed.
"""
import os
import pathlib
import sys
import time

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
# Every kernel cache of the program and of its libraries stays at a fixed
# path inside the checkout, so that only a checkout's first run builds.
# The port builds its own CUDA libraries into build/repro_torch/.
_CACHE = ROOT / "build" / "perfbench" / "cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "nv")
# (in place of this folder, which would shadow modules by its file names)
sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
