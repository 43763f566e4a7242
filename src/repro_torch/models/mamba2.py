"""Mamba-2 mixer (granite-4.0-h layers); the JAX package has none.

Per head ``h`` of ``H``, each of ``P`` channels wide, with the group's
``B_t``, ``C_t`` (``N`` each) shared by the ``H / G`` heads of the group:

    S_t[h] = exp(dt_t[h] A[h]) S_{t-1}[h] + dt_t[h] x_t[h] (x) B_t    (P, N)
    y_t[h] = S_t[h] C_t + D[h] x_t[h]

``in_proj`` gives ``[z | xBC | dt]``; ``xBC`` (``d_inner + 2 G N``) passes a
depthwise causal conv (width ``ssm_conv``, with bias) and SiLU and splits
into ``x``, ``B`` and ``C``; ``dt = softplus(dt + dt_bias)`` and ``A =
-exp(A_log)`` per head.  The output is ``out_proj(rmsnorm(y * silu(z)) *
norm)``, the norm over each group's ``d_inner / G`` channels.

Prefill runs the chunked form (:func:`ssd_scan`, chunks of ``ssm_chunk``):
each chunk's outputs from its own inputs by matrix products, the state at
each chunk's start by one pass over the chunks, and their contribution to
the chunk's outputs; a length the chunk does not divide is padded at its
end with ``dt = 0`` steps, which leave the state as it is.  Decode
(:func:`mamba2_decode`) is one step of the recurrence from a
:class:`Mamba2State` (the last ``K - 1`` conv inputs and the float32
state) and returns a new one, as ``models.mamba.mamba_decode`` does.  The
state update and its readout run inside the span ``lm.mamba2.state``.
The mixer runs whole on one device: no tensor or sequence split.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import spans
from .config import ArchConfig
from .layers import Params, dtype_of, normal, whole
from .mamba import _causal_conv


class Mamba2State(NamedTuple):
    """Decode-time carry for one Mamba-2 layer."""

    conv: torch.Tensor  # (B, K-1, conv_dim) — last K-1 conv inputs
    ssm: torch.Tensor   # (B, H, P, N) — recurrent state, f32


def conv_dim(cfg: ArchConfig) -> int:
    """Channels through the conv: ``x``, ``B`` and ``C``."""
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def check(cfg: ArchConfig) -> None:
    if cfg.ssm_heads * cfg.ssm_head_dim != cfg.d_inner \
            or cfg.ssm_heads % cfg.ssm_groups:
        raise ValueError(f"{cfg.name}: {cfg.ssm_heads} Mamba-2 heads of "
                         f"{cfg.ssm_head_dim} over {cfg.ssm_groups} groups "
                         f"do not make d_inner {cfg.d_inner}")


def init_mamba2(cfg: ArchConfig, gen: torch.Generator, keep=whole) -> Params:
    """``in_proj`` ``(d, 2 d_inner + 2 G N + H)``, ``conv_w`` / ``conv_b``,
    ``dt_bias``, ``A_log``, ``D`` (per head, f32), the gated norm's
    ``norm`` and ``out_proj``.  ``A`` is uniform in [1, 16] and
    ``softplus(dt_bias)`` log-uniform in [1e-3, 1e-1], as Mamba-2
    initialises them."""
    check(cfg)
    d, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    K, cd = cfg.ssm_conv, conv_dim(cfg)
    dt, dev, f32 = dtype_of(cfg), gen.device, torch.float32
    p = {"in_proj": normal(gen, (d, di + cd + H), dt, 1.0 / math.sqrt(d)),
         "conv_w": normal(gen, (K, cd), dt, 1.0 / math.sqrt(K)),
         "conv_b": normal(gen, (cd,), dt, 1.0 / math.sqrt(K))}
    a = torch.empty((H,), dtype=f32, device=dev).uniform_(1.0, 16.0,
                                                          generator=gen)
    u = torch.rand((H,), generator=gen, dtype=f32, device=dev)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3)).clamp_min(1e-4)
    p.update(dt_bias=dt_init + torch.log(-torch.expm1(-dt_init)),
             A_log=torch.log(a), D=torch.ones((H,), dtype=f32, device=dev),
             norm=torch.ones((di,), dtype=dt, device=dev),
             out_proj=normal(gen, (di, d), dt,
                             1.0 / math.sqrt(di) / math.sqrt(cfg.n_layers)))
    return Params(**{k: keep(f"mamba2.{k}", v) for k, v in p.items()})


def segsum(a):
    """``out[..., i, j] = a[..., j+1] + ... + a[..., i]`` for ``i >= j``,
    ``-inf`` above the diagonal: ``exp`` of it is the decay from step
    ``j`` to step ``i``."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)                 # x[.., i, j] = a_i
    low = torch.ones((T, T), dtype=torch.bool, device=a.device).tril()
    x = x.masked_fill(~low.tril(-1), 0.0).cumsum(-2)
    return x.masked_fill(~low, -math.inf)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """The recurrence over a whole sequence, chunk by chunk, in matrix
    products.  ``x`` (b, L, H, P), ``dt`` (b, L, H), ``Bm`` / ``Cm`` (b, L,
    G, N), all float32; ``A`` (H,); ``h0`` (b, H, P, N) or zero.  Returns
    ``y`` (b, L, H, P) without the ``D x`` term, and the final state."""
    b, L, H, P = x.shape
    G, N = Bm.shape[2:]
    J = H // G
    pad = -L % chunk
    if pad:                 # dt = 0 steps: no decay, nothing written
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                         for t in (x, dt, Bm, Cm))
    c, l = (L + pad) // chunk, chunk
    X = (x * dt[..., None]).reshape(b, c, l, G, J, P)
    a = (dt * A).reshape(b, c, l, G, J).permute(0, 3, 4, 1, 2)  # b g j c l
    Bc = Bm.reshape(b, c, l, G, N)
    Cc = Cm.reshape(b, c, l, G, N)
    a_cum = a.cumsum(-1)
    # 1. each chunk's outputs from its own inputs
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)
    W = CB[:, :, :, None] * torch.exp(segsum(a)).permute(0, 3, 1, 2, 4, 5)
    y = torch.einsum("bcgjls,bcsgjp->bclgjp", W, X)
    del W
    # 2. each chunk's state from its own inputs
    decay = torch.exp(a_cum[..., -1:] - a_cum).permute(0, 3, 4, 1, 2)
    states = torch.einsum("bclgn,bclgjp->bcgjpn", Bc, X * decay[..., None])
    # 3. the state at each chunk's start, one pass over the chunks
    start = x.new_zeros((b, 1, G, J, P, N)) if h0 is None \
        else h0.reshape(b, 1, G, J, P, N)
    states = torch.cat([start, states], 1)               # (b, c+1, g,j,p,n)
    ends = F.pad(a_cum[..., -1], (1, 0))                 # (b, g, j, c+1)
    carry = torch.exp(segsum(ends))                      # (b, g, j, z, c+1)
    states = torch.einsum("bgjzc,bcgjpn->bzgjpn", carry, states)
    final = states[:, -1].reshape(b, H, P, N)
    # 4. the starting states' part of each chunk's outputs
    out = torch.exp(a_cum).permute(0, 3, 4, 1, 2)        # (b, c, l, g, j)
    y = y + torch.einsum("bclgn,bcgjpn->bclgjp", Cc,
                         states[:, :-1]) * out[..., None]
    return y.reshape(b, c * l, H, P)[:, :L], final


def _gated_norm(y, z, w, groups: int, eps: float):
    """``rmsnorm(y * silu(z))`` over each group's channels, in float32,
    then cast to ``z``'s dtype and scaled by ``w``."""
    h = y.float() * F.silu(z.float())
    g = h.reshape(*h.shape[:-1], groups, -1)
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps)
    return g.reshape(h.shape).to(z.dtype) * w


def _split(p, x, cfg: ArchConfig):
    """``in_proj`` of x: (z, xBC, dt)."""
    di, H = cfg.d_inner, cfg.ssm_heads
    return (x @ p["in_proj"]).split([di, conv_dim(cfg), H], dim=-1)


def _mix(p, x, cfg: ArchConfig):
    """Full-sequence mixer: (out (B, L, d), conv inputs (B, L, conv_dim),
    final state (B, H, P, N) f32)."""
    Bsz, L, _ = x.shape
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    z, conv_in, dtr = _split(p, x, cfg)
    xBC = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = xBC.float().split([di, G * N, G * N], dim=-1)
    dt = F.softplus(dtr.float() + p["dt_bias"])            # (B, L, H)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(Bsz, L, H, P)
    y, h = ssd_scan(xh, dt, A, Bm.reshape(Bsz, L, G, N),
                    Cm.reshape(Bsz, L, G, N), cfg.ssm_chunk)
    y = (y + xh * p["D"][:, None]).reshape(Bsz, L, di)
    y = _gated_norm(y, z, p["norm"], G, cfg.norm_eps)
    return y @ p["out_proj"], conv_in, h


def mamba2_block(p, x, cfg: ArchConfig):
    """Full-sequence mixer.  x: (B, L, d) -> (B, L, d)."""
    return _mix(p, x, cfg)[0]


def mamba2_prefill(p, x, cfg: ArchConfig):
    """Like :func:`mamba2_block` but also returns the decode state: the
    last K-1 conv inputs (zeros before the first, as the causal conv pads)
    and the final state."""
    out, conv_in, h = _mix(p, x, cfg)
    K = cfg.ssm_conv
    tail = F.pad(conv_in, (0, 0, max(0, K - 1 - conv_in.shape[1]), 0))
    return out, Mamba2State(conv=tail[:, tail.shape[1] - (K - 1):], ssm=h)


def mamba2_decode(p, x, cfg: ArchConfig, state: Mamba2State):
    """Single-token step.  x: (B, 1, d) -> (B, 1, d), a new state; the
    given one is not written."""
    Bsz = x.shape[0]
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    z, xBC, dtr = _split(p, x, cfg)
    window = torch.cat([state.conv, xBC], dim=1)           # (B, K, conv)
    conv = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xs, Bt, Ct = F.silu(conv).float().split([di, G * N, G * N], dim=-1)
    dt = F.softplus(dtr[:, 0].float() + p["dt_bias"])      # (B, H)
    xh = xs.reshape(Bsz, G, H // G, P)
    with spans.span("lm.mamba2.state"):
        da = torch.exp(dt * -torch.exp(p["A_log"])).reshape(Bsz, G, -1)
        u = dt.reshape(Bsz, G, -1)[..., None] * xh        # (B, G, J, P)
        S = state.ssm.reshape(Bsz, G, H // G, P, N) * da[..., None, None]
        S.addcmul_(u[..., None], Bt.reshape(Bsz, G, 1, 1, N))
        y = torch.einsum("bgjpn,bgn->bgjp", S, Ct.reshape(Bsz, G, N))
        y = y + xh * p["D"].reshape(G, -1)[..., None]
    y = _gated_norm(y.reshape(Bsz, 1, di), z, p["norm"], G, cfg.norm_eps)
    return y @ p["out_proj"], Mamba2State(conv=window[:, 1:],
                                          ssm=S.reshape(Bsz, H, P, N))


def init_mamba2_state(cfg: ArchConfig, batch: int, device) -> Mamba2State:
    """Zero states."""
    return Mamba2State(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim(cfg)),
                         dtype=dtype_of(cfg), device=device),
        ssm=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=device))
