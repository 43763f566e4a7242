"""Lint fixture: a kernel launch that falls back to the plain version."""
from repro_torch.kernels.mamba_scan import mamba_scan as _cuda
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref


def scan(x, dt, Bt, Ct, A, D, y, h):
    try:
        _cuda.launch(x, dt, Bt, Ct, A, D, y, h)
    except RuntimeError:
        return mamba_scan_ref(x, dt, Bt, Ct, A, D)
    return y, h
