"""The plain, sequential version of the selective-scan kernel.

What CPU tensors run, what the kernel is held against on the card, and the
LM's plain path (``models.mamba.mamba_block`` with ``use_kernel=False``).
"""
from __future__ import annotations

import torch


def scan_steps(xf, dt, Bt, Ct, A, h):
    """The recurrence alone, one step at a time from the state ``h``:
    (h . Ct per step (B, L, d), the last h).  ``xf`` is float32."""
    from ...core.graph import folded, stand_ins
    L = xf.shape[1]
    with folded(L, backward_inside=False) as run:   # a capture runs one
        ys = stand_ins(L - run, (xf.shape[0], xf.shape[2]), xf)
        for t in range(run):
            dtt = dt[:, t]
            da = torch.exp(dtt[..., None] * A)                   # (B, d, N)
            h = da * h + (dtt * xf[:, t])[..., None] * Bt[:, t, None, :]
            ys.append(torch.einsum("bdn,bn->bd", h, Ct[:, t]))
            del da                      # no step's temporaries outlive it
    y = torch.stack(ys, 1) if ys else xf.new_zeros((xf.shape[0], 0,
                                                    xf.shape[2]))
    return y, h


def mamba_scan_ref(x, dt, Bt, Ct, A, D, h0=None):
    """x/dt: (B, L, d); Bt/Ct: (B, L, N); A: (d, N); D: (d,).

    Returns (y (B, L, d), h_final (B, d, N)) — f32 math throughout:
    h <- exp(dt * A) * h + (dt * x) * Bt, then y = h . Ct + D * x.
    """
    Bsz, _, d = x.shape
    N = A.shape[-1]
    xf = x.float()
    h = torch.zeros((Bsz, d, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    y, h = scan_steps(xf, dt, Bt, Ct, A, h)
    return y + xf * D, h
