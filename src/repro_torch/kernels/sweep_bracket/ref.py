"""Plain PyTorch versions of the two sweep-bracket kernels.

They restate the kernels' functions the way the sweep's unfused path
computes them — broadcast the ``(S, 1)`` scenario columns against the packed
``(n,)`` samples, then scatter-add per segment id with ``index_add_`` — and
are what the wrappers in ``ops`` run for tensors on the CPU (the analogue
of the reference's interpret mode).  The CUDA kernels are held against them
on the card.
"""
from __future__ import annotations

import torch


def _seg(term: torch.Tensor, ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """(..., n) terms -> (..., n_seg) per-segment sums.  Padding rows (id 0,
    zero weight) contribute exactly zero; empty segments stay 0."""
    out = term.new_zeros(term.shape[:-1] + (n_seg,))
    return out.index_add_(-1, ids.to(device=term.device, dtype=torch.long),
                          term)


def bracket_segsum_ref(hit, lfb, miss, delta, cxl_lat, n_seg: int) -> dict:
    """Same contract as ``ops.fused_bracket_segsum``: ``(lat, w, seg)``
    groups of any lengths, ``delta`` / ``cxl_lat`` of shape ``(S,)`` or
    ``(S, 1)``; returns four ``(S, n_seg)`` tensors in ``delta``'s dtype."""
    delta = delta.reshape(-1, 1)
    cxl_lat = cxl_lat.reshape(-1, 1)
    hl, hw, hs = hit
    ll, lw, ls = lfb
    ml, mw, ms = miss
    zero = delta.new_zeros(())
    return {
        "hit_degraded": _seg(hw * torch.maximum(hl + delta, zero), hs, n_seg),
        "lfb_mem": _seg(lw * torch.maximum(ll + delta, zero), ls, n_seg),
        "lfb_half": _seg(lw * torch.maximum(ll + delta / 2.0, zero), ls,
                         n_seg),
        "miss_congested": _seg(mw * torch.maximum(cxl_lat, ml + delta), ms,
                               n_seg),
    }


def segment_sum_ref(x: torch.Tensor, seg_ids: torch.Tensor,
                    n_seg: int) -> torch.Tensor:
    """``x (..., n)`` + ids ``(n,)`` in ``[0, n_seg)``, sorted or not ->
    ``(..., n_seg)``; empty segments sum to zero."""
    return _seg(x, seg_ids, n_seg)
