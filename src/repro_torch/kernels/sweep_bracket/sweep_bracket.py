"""Build, load and launch the CUDA kernels of ``csrc/sweep_bracket.cu``.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``build/repro_torch/`` at the
root of the checkout (the library's name carries a hash of the source, so an
edited source is rebuilt).  It is loaded with ``ctypes``; every pointer and
the stream travel as ``c_void_p``.  Nothing is built or loaded when this
module is imported: machines without ``nvcc`` import it freely and run the
plain versions in ``ref`` on CPU tensors.

The launchers here take raw, already-validated device tensors;
``ops.fused_bracket_segsum`` and ``ops.segment_sum`` own the checks, the
CSR preparation and the output allocation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "sweep_bracket.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # 12 group pointers, delta, cxl, S, n_seg, 4 outputs, stream
    "sweep_bracket": [_P] * 14 + [_I, _I] + [_P] * 5,
    # x, rows, n, offsets, perm, n_seg, out, stream
    "segsum": [_P, _I, _I, _P, _P, _I, _P, _P],
}
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


class _Library:
    """The loaded shared library, and the compiler's report if this process
    built it (``None`` when an up-to-date library was already on disk)."""

    def __init__(self, path: pathlib.Path, report: str | None):
        self.path = path
        self.report = report
        self._dll = ctypes.CDLL(str(path))
        for base, argtypes in _SIGNATURES.items():
            for suffix in _SUFFIX.values():
                fn = getattr(self._dll, f"{base}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int

    def fn(self, base: str, dtype: torch.dtype):
        return getattr(self._dll, f"{base}_{_SUFFIX[dtype]}")


_LIB: _Library | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "sweep_bracket CUDA kernels cannot be built")
    return found


def build() -> _Library:
    """Compile (if needed) and load the kernels' library; idempotent.

    Compiles into a temporary file and renames it into place, so concurrent
    processes never load a half-written library.  A failed compile raises
    with the compiler's output.
    """
    global _LIB
    if _LIB is not None:
        return _LIB
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    path = BUILD_DIR / f"libsweep_bracket-{digest}.so"
    report = None
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                   str(SOURCE)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        report = proc.stdout + proc.stderr
    _LIB = _Library(path, report)
    return _LIB


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def launch_bracket(groups, delta: torch.Tensor, cxl: torch.Tensor,
                   n_seg: int, outs) -> None:
    """Enqueue the fused bracket kernel on the current stream.  ``groups``
    are three ``(lat, w, offsets, perm)`` tuples (``perm`` may be None);
    ``outs`` four preallocated ``(S, n_seg)`` tensors."""
    lib = build()
    args = [_ptr(t) for g in groups for t in g]
    stream = torch.cuda.current_stream(delta.device).cuda_stream
    rc = lib.fn("sweep_bracket", delta.dtype)(
        *args, _ptr(delta), _ptr(cxl), delta.shape[0], n_seg,
        *(_ptr(o) for o in outs), stream)
    _check(rc, "sweep_bracket")


def launch_segsum(x: torch.Tensor, offsets: torch.Tensor,
                  perm: torch.Tensor | None, n_seg: int,
                  out: torch.Tensor) -> None:
    """Enqueue the CSR segment-sum kernel: ``x (rows, n)`` -> ``out (rows,
    n_seg)``."""
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fn("segsum", x.dtype)(
        _ptr(x), x.shape[0], x.shape[1], _ptr(offsets), _ptr(perm), n_seg,
        _ptr(out), stream)
    _check(rc, "segsum")
