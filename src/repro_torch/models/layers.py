"""Shared neural layers: RMSNorm, RoPE, GQA attention, gated MLPs, the
embedding — the forward parts of the JAX package's ``models/layers.py``.

Parameters live in :class:`Params` modules that read like the reference's
parameter dicts (``p["wq"]``, ``"wqkv" in p``), in the reference's layouts
(``x @ w`` with ``w`` of shape ``(in, out)``), so the reference's
parameters load one to one (``models.convert``).  Initialisation draws from
an explicit ``torch.Generator`` on the target device; ``keep(name,
tensor)`` keeps a rank's block of each tensor as soon as it is drawn.

Tensor parallelism (``tp``, a ``parallel.sharding.ModelAxis``): each
function takes this rank's block of the parameters
(``parallel.sharding.param_layout``) and the residual stream whole, as
every rank holds it.  A column-parallel product's input passes Megatron's
*f* (``transport.sum_backward``: identity, its gradient summed over the
``model`` group); a row-parallel product's partial sums pass *g*
(``transport.row_sum``: added in float32, then cast back).  A module
whose heads or channels do not split over the ranks runs whole.

Sequence sharding (``seq``, a ``parallel.sharding.SeqAxis``: the
``"fsdp_seq"`` layout): each ``model`` rank holds a contiguous block of
the positions, with its global positions for RoPE.  Attention gathers k
and v along the sequence over ``model`` (``transport.gather_blocks``: one
all-gather; the backward reduce-scatters dk and dv), and rank ``r``
attends the first ``(r + 1) L / R`` keys with its queries at offset
``r L / R`` (the kernel's ``q_offset``), so rank R-1 does R times rank 0's
work: the load is not balanced (a zig-zag order would change which
positions a rank holds).  The decode caches are split along L over
``model``: :func:`attention_decode_seq` combines every rank's partial
softmax ``(m, l, o)`` with one all-gather.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention import ops as fa_ops
from ..parallel import sharding, transport
from .config import ArchConfig


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def whole(name: str, t: torch.Tensor) -> torch.Tensor:
    """The default ``keep``: every tensor whole."""
    return t


def normal(gen: torch.Generator, shape, dtype, std: float) -> torch.Tensor:
    """``std`` times a standard normal draw of ``shape``, drawn in ``dtype``
    on ``gen``'s device (the reference's ``jax.random.normal(k, shape, dt)
    * std``)."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device).mul_(std)


class Params(nn.Module):
    """Named parameters and sub-modules, read like the reference's
    parameter dicts: ``p["wq"]``, ``"wqkv" in p``."""

    def __init__(self, **entries):
        super().__init__()
        for name, value in entries.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# --------------------------------------------------------------------- norms
def rms_norm(x, scale, eps: float):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


# ---------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)            # (D/2,)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def _pad_heads_cols(w, nq, nq_pad, hd, nkv, axis=1):
    """Zero-pad per-KV-group head blocks from nq to nq_pad heads, keeping
    the group-major layout (head = kv * g + j); the padded lanes are exact
    zero-saddles (their wo rows are zero too)."""
    if nq_pad == nq:
        return w
    nkv = max(nkv, 1)
    g, g_pad = nq // nkv, nq_pad // nkv
    if axis == 1:                           # (d, nq*hd) columns
        d = w.shape[0]
        grouped = w.reshape(d, nkv, g, hd)
        pad = w.new_zeros((d, nkv, g_pad - g, hd))
        return torch.cat([grouped, pad], dim=2).reshape(d, nq_pad * hd)
    d = w.shape[1]                          # (nq*hd, d) rows (wo)
    grouped = w.reshape(nkv, g, hd, d)
    pad = w.new_zeros((nkv, g_pad - g, hd, d))
    return torch.cat([grouped, pad], dim=1).reshape(nq_pad * hd, d)


def init_attention(cfg: ArchConfig, gen: torch.Generator,
                   keep=whole) -> Params:
    """``wq``/``wk``/``wv`` (or the fused ``wqkv``), optional biases, and
    ``wo``; ``keep(name, tensor)`` the block of each to hold."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    nq_pad = cfg.padded_heads
    s = 1.0 / math.sqrt(d)
    dt = dtype_of(cfg)
    wo = keep("attn.wo", _pad_heads_cols(
        normal(gen, (nq * hd, d), dt, s / math.sqrt(cfg.n_layers)),
        nq, nq_pad, hd, nkv, axis=0))
    wq = _pad_heads_cols(normal(gen, (d, nq * hd), dt, s), nq, nq_pad, hd,
                         nkv)
    zeros = lambda name, n: keep(name, torch.zeros((n,), dtype=dt,
                                                   device=gen.device))
    if cfg.fused_proj:
        p = {"wqkv": keep("attn.wqkv", torch.cat(
            [wq, normal(gen, (d, 2 * nkv * hd), dt, s)], dim=1)), "wo": wo}
        if cfg.qkv_bias:
            p["bqkv"] = zeros("attn.bqkv", (nq_pad + 2 * nkv) * hd)
        return Params(**p)
    wq = keep("attn.wq", wq)
    p = {"wq": wq, "wk": keep("attn.wk", normal(gen, (d, nkv * hd), dt, s)),
         "wv": keep("attn.wv", normal(gen, (d, nkv * hd), dt, s)), "wo": wo}
    if cfg.qkv_bias:
        p.update(bq=zeros("attn.bq", nq_pad * hd),
                 bk=zeros("attn.bk", nkv * hd), bv=zeros("attn.bv", nkv * hd))
    return Params(**p)


def attn_heads(cfg: ArchConfig, tp) -> Optional[sharding.Heads]:
    """This rank's heads under ``tp`` (``None``: attention runs whole)."""
    return None if tp is None else sharding.head_split(cfg, tp.size,
                                                       tp.rank)


def _project_qkv(p, x, cfg: ArchConfig, positions, tp=None):
    """q (B, S, Hq, D) and k / v (B, S, Hkv, D): with ``tp``, this rank's
    query heads and the kv heads they read.  Where two ranks hold one kv
    head, its columns' gradients are summed over them
    (``sharding.shared_grad``)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    heads = attn_heads(cfg, tp)
    nq, nkv = cfg.padded_heads, cfg.n_kv_heads
    if heads is not None:
        nq, nkv = heads.nq, len(heads.kv)
        x = transport.sum_backward(x, tp.group)
    if "wqkv" in p:
        w, b = p["wqkv"], p["bqkv"] if cfg.qkv_bias else None
        if heads is not None:       # the whole fused leaf, by its columns
            cols = torch.tensor(sharding.qkv_columns(cfg, heads),
                                device=x.device)
            w = transport.sum_backward(w, tp.group).index_select(1, cols)
            if b is not None:
                b = transport.sum_backward(b, tp.group).index_select(0, cols)
        qkv = x @ w
        if b is not None:
            qkv = qkv + b
        q, k, v = qkv.split([nq * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        kv = {n: p[n] for n in ("wk", "wv", "bk", "bv") if n in p}
        if heads is not None:
            kv = {n: sharding.shared_grad(t, sharding.param_layout(
                cfg, f"attn.{n}", t.ndim, tp.size), tp) for n, t in kv.items()}
        q, k, v = x @ p["wq"], x @ kv["wk"], x @ kv["wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + kv["bk"], v + kv["bv"]
    q = q.reshape(B, S, nq, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(q, k, v, causal: bool = True, kv_positions=None,
                  q_positions=None):
    """Grouped-query attention.  q: (B,S,Hq,D), k/v: (B,T,Hkv,D);
    ``q_positions`` (S,) or, one row per sequence, (B, S)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, S, Hkv, g, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k) / math.sqrt(D)
    if causal:
        if q_positions is None:
            q_positions = torch.arange(S, device=q.device)
        if kv_positions is None:
            kv_positions = torch.arange(T, device=q.device)
        # (S, T), or (B, 1, 1, S, T) when every row has its own positions
        mask = q_positions[..., :, None] >= kv_positions[None, :]
        if mask.ndim == 3:
            mask = mask[:, None, None]
        # a Python scalar, not a tensor made from it: on the card a new
        # tensor is a copy from the host, which waits for the card
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(B, S, Hq * D)


#: Sequence length above which the blockwise (flash-style) plain path is
#: used instead of materializing the full (S, T) score matrix.
CHUNKED_ATTN_THRESHOLD = 2048


def chunked_attention(q, k, v, causal: bool = True,
                      q_block: int = 1024, kv_block: int = 1024,
                      q_offset: int = 0):
    """Blockwise streaming-softmax attention, the plain path for long
    sequences.

    q: (B, S, Hq, D); k/v: (B, T, Hkv, D).  Never materializes more than a
    (B, Hkv, g, q_block, kv_block) score tile; the running (max, denom, acc)
    carry is the standard online-softmax recurrence.  ``q_offset``: q's row
    ``s`` is key position ``s + q_offset``.
    """
    from ..core.graph import folded, stand_ins
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qb = math.gcd(q_block, S)
    kb = math.gcd(kv_block, T)
    nq, nk = S // qb, T // kb

    qg = q.reshape(B, nq, qb, Hkv, g, D).float()
    kc = k.reshape(B, nk, kb, Hkv, D).float()
    vc = v.reshape(B, nk, kb, Hkv, D).float()
    scale = 1.0 / math.sqrt(D)
    zero = q.new_zeros((), dtype=torch.float32)
    # a capture with grad disabled runs one tile of each loop and counts
    # it for all (core.graph.folded); the tiles differ in values only
    with folded(nq, backward_inside=False) as run_q:
        outs = stand_ins(nq - run_q, (B, qb, Hkv, g, D), qg)
        for qi in range(run_q):
            qblk = qg[:, qi]                              # (B, qb, Hkv, g, D)
            m = torch.full((B, Hkv, g, qb), -math.inf, device=q.device)
            l = torch.zeros((B, Hkv, g, qb), device=q.device)
            acc = torch.zeros((B, Hkv, g, qb, D), device=q.device)
            with folded(nk, backward_inside=False) as run_k:
                for ki in range(run_k):
                    s = torch.einsum("bqhgd,bkhd->bhgqk", qblk,
                                     kc[:, ki]) * scale
                    if causal:
                        s = torch.where(
                            (q_offset + qi * qb
                             + torch.arange(qb, device=q.device))
                            [:, None] >= (ki * kb + torch.arange(
                                kb, device=q.device))[None, :],
                            s, zero - math.inf)
                    m_new = torch.maximum(m, s.amax(dim=-1))
                    # guard fully-masked rows (m_new == -inf)
                    safe_m = torch.where(torch.isfinite(m_new), m_new, zero)
                    p = torch.exp(s - safe_m[..., None])
                    p = torch.where(torch.isfinite(s), p, zero)
                    corr = torch.where(torch.isfinite(m),
                                       torch.exp(m - safe_m), zero)
                    l = l * corr + p.sum(dim=-1)
                    acc = acc * corr[..., None] \
                        + torch.einsum("bhgqk,bkhd->bhgqd", p, vc[:, ki])
                    m = m_new
                    del s, p, safe_m, corr, m_new    # no tile outlives its
            out = acc / torch.clamp_min(l, 1e-30)[..., None]   # iteration
            outs.append(out.permute(0, 3, 1, 2, 4))        # (B, qb, Hkv, g, D)
            del m, l, acc, out
    out = torch.stack(outs, dim=1).reshape(B, S, Hq * D)
    return out.to(q.dtype)


def attention_block(p, x, cfg: ArchConfig, positions=None,
                    use_kernel: bool = False, tp=None, seq=None):
    """Full-sequence (training / prefill) attention.

    With ``tp``, each rank attends with its query heads and the kv heads
    they read; where those query heads do not cover whole kv groups
    (``sharding.Heads.expand``), or ``cfg.attn_expand_kv`` asks for it,
    k / v are repeated to one per query head, as the reference's
    ``_expand_and_pin_heads`` does, so the kernel's ``Hq % Hkv == 0``
    holds.  ``head_pad_multiple`` (padded query heads, zero-saddled) is in
    ``cfg.padded_heads``, which the heads are split from.  Neither changes
    a value.  With ``seq``: this rank's block of the positions
    (``positions`` global), against the keys gathered over ``model``.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, tp)
    if seq is not None:
        return _attend_seq(q, k, v, seq, use_kernel)[0] @ p["wo"]
    heads = attn_heads(cfg, tp)
    k, v = _expand(k, v, heads, cfg.attn_expand_kv)
    return _out(_attend(q, k, v, use_kernel) @ p["wo"], tp, heads)


def _expand(k, v, heads, always: bool = False):
    """k / v repeated to one per query head where the rank's query heads
    do not cover whole kv groups, or ``always`` (the cache keeps the kv
    heads)."""
    if heads is None or (heads.expand is None and not always):
        return k, v
    per = heads.nq // len(heads.kv)
    idx = torch.tensor(heads.expand or [j // per for j in range(heads.nq)],
                       device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _out(y, tp, split):
    """A row-parallel output: summed over the ``model`` group where the
    module is split."""
    return y if tp is None or split is None else transport.row_sum(y, tp.group)


def _attend(q, k, v, use_kernel: bool, q_offset: int = 0):
    """Causal attention over a whole sequence (``q_offset``: of q's block
    of it, against the keys up to the block's end): the kernel, or the
    plain paths split at :data:`CHUNKED_ATTN_THRESHOLD`.  The kernel's
    block sizes are the sequence itself, which divides any length (the
    CUDA kernels tile on their own; the wrapper's blocks only shape its
    checks), so a prompt of any length runs on it."""
    B, S = q.shape[:2]
    T = k.shape[1]
    if use_kernel:
        out = fa_ops.flash_attention(q, k, v, causal=True, block_q=S,
                                     block_k=T, q_offset=q_offset)
        return out.reshape(B, S, -1)
    if max(S, T) > CHUNKED_ATTN_THRESHOLD:
        return chunked_attention(q, k, v, causal=True, q_offset=q_offset)
    if q_offset:
        return gqa_attention(q, k, v, causal=True, kv_positions=torch.arange(
            T, device=q.device), q_positions=q_offset + torch.arange(
                S, device=q.device))
    return gqa_attention(q, k, v, causal=True)


def _attend_seq(q, k, v, seq, use_kernel: bool):
    """Rank ``r``'s block of causal attention under sequence sharding:
    ``(out, k, v)``, k / v gathered whole along the sequence over
    ``model`` in one all-gather (its backward reduce-scatters dk and dv),
    of which the block's queries at offset ``r * S`` attend the first
    ``(r + 1) * S``."""
    S = q.shape[1]
    kv = transport.gather_blocks(torch.stack([k, v]), seq.group, 2)
    k, v = kv[0], kv[1]
    end = (seq.rank + 1) * S
    out = _attend(q, k[:, :end], v[:, :end], use_kernel, seq.rank * S)
    return out, k, v


def attention_prefill(p, x, cfg: ArchConfig, use_kernel: bool = False,
                      tp=None, seq=None, positions=None):
    """Full-sequence attention that also returns the (k, v) cache rows:
    ``(out, k (B, S, Hkv, D), v)`` (with ``tp``: this rank's kv heads; with
    ``seq``: this rank's block of the positions ``positions``, and k / v of
    the whole sequence, as gathered for the attention)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, tp)
    if seq is not None:
        out, k, v = _attend_seq(q, k, v, seq, use_kernel)
        return out @ p["wo"], k, v
    heads = attn_heads(cfg, tp)
    out = _attend(q, *_expand(k, v, heads, cfg.attn_expand_kv),
                  use_kernel) @ p["wo"]
    return _out(out, tp, heads), k, v


def attention_decode(p, x, cfg: ArchConfig, cache_k, cache_v, pos, tp=None,
                     seq=None):
    """Decode step with a pre-filled KV cache; writes the new rows into
    ``cache_k`` / ``cache_v`` in place and attends over the whole cache.

    x: (B, S, d) — S = 1 for ordinary decode, S > 1 for a chunked-prefill
    step that processes S prompt tokens at once; cache_k/v: (B, S_max, Hkv,
    D); ``pos`` is the index of the FIRST new token, an int for the whole
    batch or a (B,) tensor with one per row (the slots of a continuous
    engine, each at its own position).  Returns (out, cache_k, cache_v).
    With ``tp`` the caches hold this rank's kv heads
    (``sharding.cache_layout``); with ``seq`` (:func:`attention_decode_seq`)
    this rank's block of the positions.
    """
    if seq is not None:
        return attention_decode_seq(p, x, cfg, cache_k, cache_v, pos, seq)
    B, S = x.shape[0], x.shape[1]
    steps = torch.arange(S, device=x.device)
    if torch.is_tensor(pos) and pos.ndim == 1:
        positions = pos.to(x.device)[:, None] + steps          # (B, S)
    else:
        positions = (int(pos) + steps).expand(B, S)
    q, k, v = _project_qkv(p, x, cfg, positions, tp)
    rows = torch.arange(B, device=x.device)[:, None]
    cache_k[rows, positions] = k
    cache_v[rows, positions] = v
    kv_pos = torch.arange(cache_k.shape[1], device=x.device)
    heads = attn_heads(cfg, tp)
    out = gqa_attention(q, *_expand(cache_k, cache_v, heads), causal=True,
                        kv_positions=kv_pos, q_positions=positions)
    return _out(out @ p["wo"], tp, heads), cache_k, cache_v


def attention_decode_seq(p, x, cfg: ArchConfig, cache_k, cache_v, pos: int,
                         seq):
    """Decode under sequence sharding: the caches hold this rank's block
    of ``L / R`` positions of the whole ``max_len`` (every kv head).  The
    new tokens (the same on every ``model`` rank) are written by the rank
    whose block holds their positions; every rank computes its partial
    softmax ``(m, l, o)`` in float32 over its valid positions (an empty
    block gives ``m = -inf``, ``l = 0``), and one all-gather over ``model``
    combines them.  ``pos`` is an int: the whole batch at one position."""
    if torch.is_tensor(pos) and pos.ndim:
        raise NotImplementedError(
            "layout='fsdp_seq' decodes a batch at one position; a position "
            "per row (the continuous engines) has no sequence-sharded path")
    B, S = x.shape[0], x.shape[1]
    pos = int(pos)
    positions = (pos + torch.arange(S, device=x.device)).expand(B, S)
    q, k, v = _project_qkv(p, x, cfg, positions)
    Lc = cache_k.shape[1]
    lo = seq.rank * Lc
    a, b = max(pos, lo), min(pos + S, lo + Lc)       # rows this rank owns
    if a < b:
        cache_k[:, a - lo:b - lo] = k[:, a - pos:b - pos]
        cache_v[:, a - lo:b - lo] = v[:, a - pos:b - pos]
    Hq, D = q.shape[2], q.shape[3]
    Hkv = cache_k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bshgd,bthd->bhgst", qg, cache_k).float() / math.sqrt(D)
    live = (pos + torch.arange(S, device=x.device))[:, None] >= (
        lo + torch.arange(Lc, device=x.device))[None, :]       # (S, Lc)
    s = s.masked_fill(~live, -math.inf)
    m = s.amax(-1)                                             # (B,h,g,S)
    e = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = e.sum(-1)
    o = torch.einsum("bhgst,bthd->bhgsd", e, cache_v.float())
    parts = transport.all_gather(torch.cat([o, m[..., None], l[..., None]],
                                           -1), seq.group)
    o, m, l = parts[..., :D], parts[..., D], parts[..., D + 1]
    top = m.amax(0)
    w = torch.where(torch.isfinite(m), torch.exp(m - torch.where(
        torch.isfinite(top), top, 0.0)), 0.0)                 # (R,B,h,g,S)
    out = (w[..., None] * o).sum(0) / (w * l).sum(0)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq * D).to(x.dtype)
    return out @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------- MLPs
def init_mlp(cfg: ArchConfig, gen: torch.Generator,
             d_ff: Optional[int] = None, keep=whole) -> Params:
    """Gated MLP: ``w_gate``/``w_up`` (or the fused ``w_gateup``) and
    ``w_down``."""
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    s = 1.0 / math.sqrt(d)
    down = keep("mlp.w_down", normal(
        gen, (f, d), dt, 1.0 / math.sqrt(f) / math.sqrt(cfg.n_layers)))
    if cfg.fused_proj:
        return Params(w_gateup=keep("mlp.w_gateup",
                                    normal(gen, (d, 2 * f), dt, s)),
                      w_down=down)
    return Params(w_gate=keep("mlp.w_gate", normal(gen, (d, f), dt, s)),
                  w_up=keep("mlp.w_up", normal(gen, (d, f), dt, s)),
                  w_down=down)


def activation(cfg: ArchConfig, gate):
    return F.gelu(gate, approximate="tanh") if cfg.mlp_act == "geglu" \
        else F.silu(gate)


def mlp_block(p, x, cfg: ArchConfig, tp=None):
    """The gated MLP; with ``tp``, this rank's ``d_ff / R`` columns of
    ``w_gate`` / ``w_up`` (of each half of the fused ``w_gateup``, held
    whole) and rows of ``w_down``, one all-reduce."""
    split = None if tp is None else sharding.channel_split(cfg.d_ff, tp.size)
    if split is not None:
        x = transport.sum_backward(x, tp.group)
    if "w_gateup" in p:
        w = p["w_gateup"]
        if split is not None:
            lo, n = split[tp.rank]
            cols = torch.cat([torch.arange(lo, lo + n, device=x.device),
                              cfg.d_ff + torch.arange(lo, lo + n,
                                                      device=x.device)])
            w = transport.sum_backward(w, tp.group).index_select(1, cols)
        gate, up = (x @ w).chunk(2, dim=-1)
    else:
        gate, up = x @ p["w_gate"], x @ p["w_up"]
    return _out((activation(cfg, gate) * up) @ p["w_down"], tp, split)


# ----------------------------------------------------------------- embedding
def init_embedding(cfg: ArchConfig, gen: torch.Generator,
                   keep=whole) -> Params:
    """Table/head sized to ``padded_vocab``; padding logits are masked in
    ``unembed``, padding rows are never gathered."""
    dt = dtype_of(cfg)
    v = cfg.padded_vocab
    p = {"table": keep("embed.table",
                       normal(gen, (v, cfg.d_model), dt, 0.02))}
    if not cfg.tie_embeddings:
        p["lm_head"] = keep("embed.lm_head", normal(
            gen, (cfg.d_model, v), dt, 1.0 / math.sqrt(cfg.d_model)))
    return Params(**p)


def embed(p, tokens, tp=None, lo: int = 0):
    """The table's rows of ``tokens``; with ``tp``, from this rank's rows
    ``[lo, lo + len(table))`` of a vocab-sharded table, all-reduced
    (``transport.vocab_embed``)."""
    if tp is None:
        return p["table"][tokens]
    return transport.vocab_embed(p["table"], tokens, lo, tp.group)


def unembed(p, x, vocab_size: Optional[int] = None, tp=None, lo: int = 0):
    """Logits of the head (or the tied table); with ``tp``, this rank's
    vocab columns ``[lo, lo + n)``, not gathered.  Padding logits are
    masked by their global vocab index."""
    if tp is not None:
        x = transport.sum_backward(x, tp.group)
    logits = x @ p["lm_head"] if "lm_head" in p else x @ p["table"].T
    v = logits.shape[-1]
    if vocab_size is not None and vocab_size < lo + v:
        pad = lo + torch.arange(v, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits
