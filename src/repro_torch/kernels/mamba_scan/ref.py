"""The plain, sequential version of the selective-scan kernel.

What CPU tensors run, what the kernel is held against on the card, and the
LM's plain path (``models.mamba.mamba_block`` with ``use_kernel=False``).
"""
from __future__ import annotations

import torch


def mamba_scan_ref(x, dt, Bt, Ct, A, D, h0=None):
    """x/dt: (B, L, d); Bt/Ct: (B, L, N); A: (d, N); D: (d,).

    Returns (y (B, L, d), h_final (B, d, N)) — f32 math throughout:
    h <- exp(dt * A) * h + (dt * x) * Bt, then y = h . Ct + D * x.
    """
    Bsz, L, d = x.shape
    N = A.shape[-1]
    xf = x.float()
    h = torch.zeros((Bsz, d, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    ys = []
    for t in range(L):
        dtt = dt[:, t]
        da = torch.exp(dtt[..., None] * A)                       # (B, d, N)
        h = da * h + (dtt * xf[:, t])[..., None] * Bt[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Ct[:, t]))
    y = torch.stack(ys, 1) if ys else xf.new_zeros((Bsz, 0, d))
    return y + xf * D, h
