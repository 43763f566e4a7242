"""Lint fixture: a kernel built, and the card touched, at import."""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import mamba_scan as _cuda

LIB = _build.build(_cuda.SOURCE, {})
ON_CARD = torch.zeros(4, device="cuda")


def later():
    return _build.build(_cuda.SOURCE, {})     # at first use: fine
