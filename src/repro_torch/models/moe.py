"""Mixture-of-Experts FFN with top-k routing (phi3.5-moe / llama4 / jamba).

The forward parts of the JAX package's ``models/moe.py``, with its two
single-device dispatch implementations:

* ``dense``   — one-hot einsum dispatch (Shazeer-style), O(T*E*C) memory;
  the readable oracle.
* ``scatter`` — rank-within-expert scatter/gather dispatch, O(T*E + E*C*d)
  memory; the production path.

Both honour a capacity factor: tokens ranked beyond ``C = cf * T * k / E``
for their expert are dropped (their combine weight contributes nothing).
Three details are pinned to the reference: top-k ties go to the lower
expert index (as ``lax.top_k``), a token's rank within its expert follows
the flat ``(T, k)`` order of the assignments, and dropped assignments are
dropped on the way in and read back as zeros.

``groups`` splits the T tokens into equal groups routed on their own: each
group has its own capacity and its own ranks, as if each were a separate
call.  A continuous engine decodes its slots in one batched call where the
reference maps the model over the slots (``jax.vmap``), so that each
slot's single token sees ``capacity(cfg, 1)`` and is never dropped;
``moe_ffn(..., per_row=True)`` gives each batch row its own group to match.
The experts still run once, over every group's buffer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import Params, activation, dtype_of, normal


def init_moe(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """The router (``(d, E)``, f32) and the stacked experts ``w_gate``,
    ``w_up`` (``(E, d, f)``) and ``w_down`` (``(E, f, d)``)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype_of(cfg)
    s = 1.0 / math.sqrt(d)
    return Params(router=normal(gen, (d, E), torch.float32, s),
                  w_gate=normal(gen, (E, d, f), dt, s),
                  w_up=normal(gen, (E, d, f), dt, s),
                  w_down=normal(gen, (E, f, d), dt,
                                1.0 / math.sqrt(f) / math.sqrt(cfg.n_layers)))


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    c = int(math.ceil(cfg.capacity_factor * n_tokens
                      * cfg.experts_per_token / cfg.n_experts))
    return max(8, -(-c // 8) * 8)   # round up to a multiple of 8


def top_k(logits, k: int):
    """(values, indices) of the ``k`` largest entries of the last axis,
    ties to the lower index (``lax.top_k``'s order; ``torch.topk`` names
    none)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, x, cfg: ArchConfig):
    """x: (T, d) -> top-k (weights (T,k) f32, indices (T,k), router logits)."""
    logits = x.float() @ p["router"]                      # (T, E)
    topw, topi = top_k(logits, cfg.experts_per_token)
    return torch.softmax(topw, dim=-1), topi, logits


def _expert_mlp(p, buf, cfg: ArchConfig):
    """buf: (E, C, d) -> (E, C, d), batched gated MLP over experts."""
    gate = torch.bmm(buf, p["w_gate"])
    up = torch.bmm(buf, p["w_up"])
    return torch.bmm(activation(cfg, gate) * up, p["w_down"])


def aux_load_balance_loss(logits, topi, cfg: ArchConfig):
    """Switch-style auxiliary loss: E * sum_e f_e * p_e."""
    E = cfg.n_experts
    probs = torch.softmax(logits, dim=-1)                 # (T, E)
    frac_tokens = F.one_hot(topi[..., 0], E).float().mean(0)
    frac_probs = probs.mean(0)
    return E * (frac_tokens * frac_probs).sum()


# ------------------------------------------------------------------- dense
def _ranks(topi, E: int, groups: int):
    """Each assignment's expert (T*k,), one-hot (T*k, E) and rank within
    its expert and group (T*k,), in the flat (token, k) order."""
    flat_e = topi.reshape(groups, -1)                            # (G, n*k)
    onehot = F.one_hot(flat_e, E)                                # (G, n*k, E)
    rank = (onehot.cumsum(1) - 1).gather(2, flat_e[..., None])[..., 0]
    return flat_e.reshape(-1), onehot.reshape(-1, E), rank.reshape(-1)


def _group_of(T: int, k: int, groups: int, device):
    """The group of each of the T*k assignments."""
    return torch.arange(groups, device=device).repeat_interleave(
        T // groups * k)


def moe_ffn_dense(p, x, cfg: ArchConfig, groups: int = 1):
    """One-hot einsum dispatch (oracle).  x: (T, d)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(cfg, T // groups)
    topw, topi, logits = _route(p, x, cfg)

    flat_e, onehot, rank = _ranks(topi, E, groups)
    onehot = onehot.float()                                      # (T*k, E)
    keep = rank < C
    # column g * C + rank of the experts' (G * C)-row buffers
    col = _group_of(T, k, groups, x.device) * C + rank
    slots = torch.arange(groups * C, device=x.device)
    pos_oh = (col[:, None] == slots).float() * keep[:, None]
    disp = onehot[:, :, None] * pos_oh[:, None, :]           # (T*k, E, G*C)

    xr = x.repeat_interleave(k, dim=0)                           # (T*k, d)
    buf = torch.einsum("tec,td->ecd", disp, xr.float())
    out = _expert_mlp(p, buf.to(x.dtype), cfg)                   # (E, C, d)
    back = torch.einsum("tec,ecd->td", disp, out.float())
    back = back * topw.reshape(-1)[:, None]
    y = back.reshape(T, k, d).sum(1).to(x.dtype)
    return y, aux_load_balance_loss(logits, topi, cfg)


# ----------------------------------------------------------------- scatter
def moe_ffn_scatter(p, x, cfg: ArchConfig, groups: int = 1):
    """Rank-within-expert scatter/gather dispatch (production path)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(cfg, T // groups)
    GC = groups * C                              # rows of each expert
    topw, topi, logits = _route(p, x, cfg)

    flat_e, _, rank = _ranks(topi, E, groups)
    keep = rank < C
    col = _group_of(T, k, groups, x.device) * C + rank
    slot = torch.where(keep, flat_e * GC + col, E * GC)          # E*GC: drop

    # row E*GC takes every dropped assignment and is cut off
    xr = x.repeat_interleave(k, dim=0)
    buf = x.new_zeros((E * GC + 1, d)).index_copy_(0, slot, xr)[:E * GC]
    out = _expert_mlp(p, buf.reshape(E, GC, d), cfg).reshape(E * GC, d)

    gathered = torch.cat([out, out.new_zeros((1, d))])[slot]     # drop -> 0
    back = gathered.float() * topw.reshape(-1)[:, None] * keep[:, None]
    y = back.reshape(T, k, d).sum(1).to(x.dtype)
    return y, aux_load_balance_loss(logits, topi, cfg)


def moe_ffn(p, x, cfg: ArchConfig, impl: str = "scatter",
            per_row: bool = False):
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar).  ``per_row`` routes
    each batch row on its own (capacity and ranks per row, the aux loss
    over all rows)."""
    B, S, d = x.shape
    if impl == "ep_local":
        raise NotImplementedError(
            "moe_impl='ep_local' (expert-parallel dispatch over a device "
            "mesh) is not ported yet; use 'scatter' or 'dense'")
    if impl not in ("dense", "scatter"):
        raise ValueError(f"unknown moe_impl {impl!r}; known: 'dense', "
                         "'scatter'")
    fn = moe_ffn_dense if impl == "dense" else moe_ffn_scatter
    y, aux = fn(p, x.reshape(B * S, d), cfg, groups=B if per_row else 1)
    return y.reshape(B, S, d), aux
