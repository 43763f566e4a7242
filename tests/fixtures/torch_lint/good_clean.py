"""Lint fixture: code every port rule accepts."""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import mamba_scan as _cuda


def build():
    return _build.build(_cuda.SOURCE, {})


def launch(x, dt, Bt, Ct, A, D, y, h):
    try:
        _cuda.launch(x, dt, Bt, Ct, A, D, y, h)
    except RuntimeError as e:
        raise RuntimeError("scan launch failed") from e


def in_float64(fn):
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return fn()
    finally:
        torch.set_default_dtype(old)


def price_grid_fused(cb, view, n_calls: int):
    return cb, view, int(n_calls)


if __name__ == "__main__":
    print(torch.zeros(1, device="cuda"))
