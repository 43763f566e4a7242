"""Plain version of one Mamba-2 decode step's state update and readout.

Exactly the port's path before the kernel (``models.mamba2.mamba2_decode``
under the span ``lm.mamba2.state``): the state times its decay into a new
tensor, ``addcmul_`` of ``dt x (x) B`` into it, the ``C`` readout and
``D x``.  CPU tensors run it; the CUDA kernel is held to it.
"""
from __future__ import annotations

import torch


def mamba2_state_update_ref(ssm, x, dt, Bt, Ct, A_log, D):
    """``ssm (b, H, P, N)``, ``x (b, H, P)``, ``dt (b, H)``, ``Bt`` / ``Ct
    (b, G, N)``, ``A_log`` / ``D (H,)``, all float32.  Returns ``y (b, H,
    P)`` and the new state ``(b, H, P, N)``; ``ssm`` is not written."""
    Bsz, H, P, N = ssm.shape
    G = Bt.shape[1]
    xh = x.reshape(Bsz, G, H // G, P)
    da = torch.exp(dt * -torch.exp(A_log)).reshape(Bsz, G, -1)
    u = dt.reshape(Bsz, G, -1)[..., None] * xh        # (B, G, J, P)
    S = ssm.reshape(Bsz, G, H // G, P, N) * da[..., None, None]
    S.addcmul_(u[..., None], Bt.reshape(Bsz, G, 1, 1, N))
    y = torch.einsum("bgjpn,bgn->bgjp", S, Ct.reshape(Bsz, G, N))
    y = y + xh * D.reshape(G, -1)[..., None]
    return y.reshape(Bsz, H, P), S.reshape(Bsz, H, P, N)
