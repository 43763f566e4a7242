"""Build and load the port's CUDA sources: one ``nvcc`` call per source.

Each source under a kernel package's ``csrc/`` is compiled for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``build/repro_torch/`` at the root of the checkout.  The library's name
carries a hash of the source and the flags, so an edited source is rebuilt.
It is compiled into a temporary file and renamed into place, so concurrent
processes never load a half-written library; a failed compile raises with
the compiler's output.  The library is loaded with ``ctypes``; every pointer
and the stream travel as ``c_void_p``.

Nothing is built or loaded when this module is imported: machines without
``nvcc`` import it freely.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: Entry points are named ``<base>_<suffix>``, one per float type that the
#: source instantiates.
SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}


class Library:
    """A loaded shared library, and the compiler's report and wall seconds
    if this process built it (``None`` when an up-to-date library was
    already on disk)."""

    def __init__(self, path: pathlib.Path, report: str | None,
                 seconds: float | None, signatures: dict):
        self.path = path
        self.report = report
        self.seconds = seconds
        self._dll = ctypes.CDLL(str(path))
        self._fns = {}
        for base, (argtypes, dtypes) in signatures.items():
            for dtype in dtypes:
                fn = getattr(self._dll, f"{base}_{SUFFIX[dtype]}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                self._fns[base, dtype] = fn

    def fn(self, base: str, dtype: torch.dtype):
        return self._fns[base, dtype]


_LIBS: dict[pathlib.Path, Library] = {}
_LOCKS: dict[pathlib.Path, threading.Lock] = {}
_GUARD = threading.Lock()


def _nvcc(what: str) -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found (PATH or /usr/local/cuda/bin): "
                           f"the {what} CUDA kernels cannot be built")
    return found


def _compile(source: pathlib.Path) -> tuple:
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    path = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    if path.exists():
        return path, None, None
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(source.stem), *NVCC_FLAGS, "-o", tmp,
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, proc.stdout + proc.stderr, time.perf_counter() - t0


def build(source: pathlib.Path, signatures: dict) -> Library:
    """Compile ``source`` (if needed) and load it; idempotent per source.

    ``signatures`` maps each entry point's base name to its ``ctypes``
    argument types and the float types the source defines it for.  Different sources build concurrently from different
    threads (``nvcc`` runs outside the interpreter lock).
    """
    with _GUARD:
        lock = _LOCKS.setdefault(source, threading.Lock())
    with lock:
        if source not in _LIBS:
            _LIBS[source] = Library(*_compile(source), signatures)
        return _LIBS[source]


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
