"""The plain version of the flash-attention kernel (GQA, causal or not).

What CPU tensors run, and what the kernel is held against on the card.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, Hq, D); k/v: (B, T, Hkv, D) -> (B, S, Hq, D), f32 math,
    the output in q's dtype.  Query head h reads kv head h // (Hq // Hkv).
    ``q_offset``: q's row ``s`` is key position ``s + q_offset`` (q is the
    block of a longer sequence that starts there), so with ``causal`` it
    sees keys ``t <= s + q_offset``."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = q.float().reshape(B, S, Hkv, g, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qf, k.float()) / math.sqrt(D)
    if causal:
        pos_q = torch.arange(S, device=q.device) + q_offset
        pos_k = torch.arange(T, device=q.device)
        scores = scores.masked_fill(pos_q[:, None] < pos_k[None, :],
                                    float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)
