"""Mamba-1 (selective state-space) mixer — falcon-mamba / jamba layers.

The forward parts of the JAX package's ``models/mamba.py``:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t
with input-dependent (selective) dt/B/C, a depthwise causal conv front-end
and a SiLU-gated output path.  ``use_kernel`` runs the recurrence on the
CUDA kernel of ``kernels.mamba_scan``; the plain path is its sequential
version.  Under grad the plain path is :func:`selective_scan`, the same
steps checkpointed per chunk of :data:`SCAN_CHUNK`, as the reference's
``selective_scan``: the backward pass keeps the state at chunk boundaries
only, not every step's ``(B, d, N)`` state.
Prefill also returns the decode state, ``MambaState``: the last K-1 conv
inputs and the scan's final state; single-token decode carries it.

Tensor parallelism (``tp``): each rank holds a block of the ``d_inner``
channels of every channel leaf — ``in_proj``'s columns of ``x`` and the
same columns of ``z`` (the spec's contiguous split of ``[x | z]`` would
give rank 0 only ``x``), ``conv_w`` / ``conv_b``, ``dt_proj`` /
``dt_bias``, ``A_log``, ``D``, and the rows of ``x_proj`` and
``out_proj`` — and keeps channel-sharded states.  ``x_proj``'s (B, L,
r + 2N) partial sums are added in float32 over the ``model`` group before
``dt_low`` / ``B`` / ``C`` are split (every rank's channels read all of
them, so their gradient is summed back too), then rounded to the model's
dtype as the whole product is; ``out_proj``'s output is the one other
all-reduce.

Sequence sharding (``seq``, the ``"fsdp_seq"`` layout): each ``model``
rank holds a contiguous block of the positions and every channel.  The
depthwise conv reads the previous rank's last K-1 conv inputs (one
all-gather of every rank's tail; rank 0 reads zeros, as the causal pad
does).  The scan carries the state across blocks in two passes: pass 1
scans the block from zero, giving ``h_end`` and the block's decay ``P =
exp(A * sum_t dt_t)``; one all-gather of ``(h_end, P)`` gives rank r the
state its block starts from, ``h_in = fold_{j<r}(h <- P_j h + h_end_j)``;
pass 2 rescans the block from ``h_in`` (the kernel's ``h0``).  Both
gathers' backward passes reduce-scatter, carrying the gradients into the
earlier ranks' blocks.  Rank 0 runs one pass where no graph is built;
under grad it rescans too, from its (zero) ``h_in``, so that every rank's
graph holds the same collectives.  The decode state (the conv tail and the
final state) is rank R-1's, held whole on every ``model`` rank.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.mamba_scan import ops as ms_ops
from ..kernels.mamba_scan.ref import mamba_scan_ref, scan_steps
from ..parallel import sharding, transport
from .config import ArchConfig
from .layers import Params, dtype_of, normal, whole


def dt_rank(cfg: ArchConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


class MambaState(NamedTuple):
    """Decode-time carry for one mamba layer."""

    conv: torch.Tensor  # (B, K-1, d_inner) — last K-1 conv inputs
    ssm: torch.Tensor   # (B, d_inner, N) — recurrent state, f32


def init_mamba(cfg: ArchConfig, gen: torch.Generator, keep=whole) -> Params:
    """``in_proj``, ``conv_w``/``conv_b``, ``x_proj``, ``dt_proj``/
    ``dt_bias``, ``A_log``, ``D`` and ``out_proj``; ``keep(name, tensor)``
    the block of each to hold."""
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    r = dt_rank(cfg)
    dt = dtype_of(cfg)
    dev = gen.device
    s = 1.0 / math.sqrt(d)
    # S4D-real initialization of A; dt bias such that softplus(bias) spans
    # [1e-3, 1e-1] as in the reference implementation.
    a = torch.arange(1, N + 1, dtype=torch.float32, device=dev)[None, :] \
        .repeat(di, 1)
    u = torch.rand((di,), generator=gen, dtype=torch.float32, device=dev)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    # each tensor drawn whole, in the whole model's order, and cut at once
    p = {"in_proj": normal(gen, (d, 2 * di), dt, s)}
    p["in_proj"] = keep("mamba.in_proj", p["in_proj"])
    p["conv_w"] = keep("mamba.conv_w",
                       normal(gen, (K, di), dt, 1.0 / math.sqrt(K)))
    p["x_proj"] = keep("mamba.x_proj", normal(gen, (di, r + 2 * N), dt,
                                              1.0 / math.sqrt(di)))
    p["dt_proj"] = keep("mamba.dt_proj",
                        normal(gen, (r, di), dt, r ** -0.5))
    p["out_proj"] = keep("mamba.out_proj", normal(
        gen, (di, d), dt, 1.0 / math.sqrt(di) / math.sqrt(cfg.n_layers)))
    fixed = {"conv_b": torch.zeros((di,), dtype=dt, device=dev),
             "dt_bias": dt_bias, "A_log": torch.log(a),  # (di, N) f32
             "D": torch.ones((di,), dtype=torch.float32, device=dev)}
    p.update({k: keep(f"mamba.{k}", v) for k, v in fixed.items()})
    return Params(**{k: p[k] for k in ("in_proj", "conv_w", "conv_b",
                                        "x_proj", "dt_proj", "dt_bias",
                                        "A_log", "D", "out_proj")})


def _causal_conv(x, w, b, prev=None):
    """Depthwise causal conv along time.  x: (B, L, di), w: (K, di);
    ``prev`` (B, K-1, di): the K-1 inputs before x's first (zeros when
    ``None``)."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0)) if prev is None \
        else torch.cat([prev, x], dim=1)
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + pad[:, k: k + x.shape[1], :] * w[k]
    return out + b


def channels(cfg: ArchConfig, tp):
    """``tp`` where the ``d_inner`` channels split over its ranks, else
    ``None`` (the mixer runs whole)."""
    if tp is None or sharding.channel_split(cfg.d_inner, tp.size) is None:
        return None
    return tp


def _ssm_inputs(p, x, cfg: ArchConfig, tp=None):
    """x: (B, L, di) post-conv activations -> (dt, B_t, C_t) f32 (with
    ``tp``: x and dt are this rank's channels; B_t, C_t whole)."""
    r, N = dt_rank(cfg), cfg.ssm_state
    proj = x @ p["x_proj"]                                # (B, L, r + 2N)
    if tp is not None:
        # summed in float32 and rounded to x's dtype, as the whole product
        # is before the reference casts it; its gradient summed backward
        proj = transport.sum_backward(transport.row_sum(proj, tp.group),
                                      tp.group)
    proj = proj.float()
    dt_low, Bt, Ct = proj.split([r, N, N], dim=-1)
    pre = dt_low @ p["dt_proj"].float() + p["dt_bias"]
    dt = torch.logaddexp(pre, pre.new_zeros(()))          # softplus
    return dt, Bt, Ct


#: Steps per checkpointed chunk of :func:`selective_scan` (the
#: reference's ``chunk``).
SCAN_CHUNK = 128


def selective_scan(x, dt, Bt, Ct, A, D, chunk: int = SCAN_CHUNK, h0=None):
    """``mamba_scan_ref`` from the state ``h0`` (zero when ``None``), each
    chunk of ``chunk`` steps checkpointed (a length that ``chunk`` does not
    divide is one chunk, as in the reference).  The same values, bit for
    bit."""
    Bsz, L, d = x.shape
    if L % chunk:
        chunk = max(L, 1)
    xf = x.float()
    h = torch.zeros((Bsz, d, A.shape[-1]), dtype=torch.float32,
                    device=x.device) if h0 is None else h0
    ys = []
    for s in range(0, L, chunk):
        y, h = checkpoint(scan_steps, xf[:, s:s + chunk], dt[:, s:s + chunk],
                          Bt[:, s:s + chunk], Ct[:, s:s + chunk], A, h,
                          use_reentrant=False)
        ys.append(y)
    y = torch.cat(ys, 1) if ys else xf[:, :0]
    return y + xf * D, h


def _scan(xi, dt, Bt, Ct, A, D, use_kernel: bool, h0=None):
    """The scan of one (block of a) sequence from ``h0``: the kernel (its
    chunk the whole block), the checkpointed plain scan under grad, or the
    plain scan."""
    if use_kernel:
        return ms_ops.mamba_scan(xi.float(), dt, Bt, Ct, A, D,
                                 chunk=max(1, xi.shape[1]), h0=h0)
    if torch.is_grad_enabled():
        return selective_scan(xi, dt, Bt, Ct, A, D, h0=h0)
    return mamba_scan_ref(xi, dt, Bt, Ct, A, D, h0)


def _prev_tails(conv_in, K: int, seq):
    """Every rank's last K-1 conv inputs, gathered along the sequence over
    ``model`` (B, R (K-1), di), and the K-1 before this rank's block (the
    previous rank's; zeros on rank 0, kept in the graph so that every
    rank's backward runs the gather's reduce-scatter)."""
    if conv_in.shape[1] < K - 1:
        raise ValueError(f"a block of {conv_in.shape[1]} positions is "
                         f"shorter than the conv's {K - 1}-input tail")
    tails = transport.gather_blocks(conv_in[:, conv_in.shape[1] - (K - 1):],
                                    seq.group, 1)
    r = seq.rank
    prev = tails.narrow(1, max(r - 1, 0) * (K - 1), K - 1)
    return tails, prev if r else prev * 0.0


def _seq_scan(xi, dt, Bt, Ct, A, D, seq, use_kernel: bool):
    """The two-pass scan of this rank's block (module docstring)."""
    y, h = _scan(xi, dt, Bt, Ct, A, D, use_kernel)
    decay = torch.exp(A * dt.sum(1)[..., None])               # (B, di, N)
    ends = transport.gather_blocks(torch.stack([h, decay]), seq.group, 0)
    h_in = torch.zeros_like(h)
    before = torch.arange(seq.size, device=h.device) < seq.rank
    for j in range(seq.size):
        h_in = torch.where(before[j], ends[2 * j + 1] * h_in + ends[2 * j],
                           h_in)
    if seq.rank or torch.is_grad_enabled():
        y, h = _scan(xi, dt, Bt, Ct, A, D, use_kernel, h_in)
    return y, h


def _mix(p, x, cfg: ArchConfig, use_kernel: bool, tp=None, seq=None):
    """Full-sequence mixer: (out (B, L, d), conv inputs (B, L, di), final
    scan state (B, di, N) f32, and with ``seq`` every rank's conv tail,
    else ``None``).  The kernel's chunk is the whole sequence, which
    divides any length (the CUDA kernel tiles on its own), so a prompt of
    any length runs on it, unpadded: padding would enter the final state.
    With ``tp``: di is this rank's channels; with ``seq``: this rank's
    block of the positions, the final state its block's."""
    tp = channels(cfg, tp)
    if tp is not None:
        x = transport.sum_backward(x, tp.group)
    # the rank's in_proj block is [x_r | z_r], so one chunk splits it too
    conv_in, z = (x @ p["in_proj"]).chunk(2, dim=-1)      # (B, L, di) each
    tails = prev = None
    if seq is not None:
        tails, prev = _prev_tails(conv_in, cfg.ssm_conv, seq)
    xi = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"], prev))
    dt, Bt, Ct = _ssm_inputs(p, xi, cfg, tp)
    A = -torch.exp(p["A_log"])
    if seq is not None:
        y, h = _seq_scan(xi, dt, Bt, Ct, A, p["D"], seq, use_kernel)
    else:
        y, h = _scan(xi, dt, Bt, Ct, A, p["D"], use_kernel)
    y = y.to(x.dtype) * F.silu(z)
    return _out(y @ p["out_proj"], tp), conv_in, h, tails


def _out(y, tp):
    return y if tp is None else transport.row_sum(y, tp.group)


def mamba_block(p, x, cfg: ArchConfig, use_kernel: bool = False, tp=None,
                seq=None):
    """Full-sequence mixer.  x: (B, L, d) -> (B, L, d)."""
    return _mix(p, x, cfg, use_kernel, tp, seq)[0]


def mamba_prefill(p, x, cfg: ArchConfig, use_kernel: bool = False, tp=None,
                  seq=None):
    """Like ``mamba_block`` but also returns the decode state: the last
    K-1 conv inputs (zeros before the first, as the causal conv pads) and
    the scan's final state (with ``tp``: this rank's channels; with
    ``seq``: rank R-1's, whole on every rank: its tail from the gathered
    tails, its final state through one all-gather)."""
    out, conv_in, h, tails = _mix(p, x, cfg, use_kernel, tp, seq)
    K = cfg.ssm_conv
    if seq is not None:
        last = transport.all_gather(h, seq.group)[-1]
        return out, MambaState(conv=tails[:, tails.shape[1] - (K - 1):],
                               ssm=last)
    tail = F.pad(conv_in, (0, 0, max(0, K - 1 - conv_in.shape[1]), 0))
    return out, MambaState(conv=tail[:, tail.shape[1] - (K - 1):], ssm=h)


def mamba_decode(p, x, cfg: ArchConfig, state: MambaState, tp=None):
    """Single-token step.  x: (B, 1, d) -> (B, 1, d), new state."""
    tp = channels(cfg, tp)
    if tp is not None:
        x = transport.sum_backward(x, tp.group)
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)           # (B, 1, di)
    window = torch.cat([state.conv, xi], dim=1)           # (B, K, di)
    conv = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xi_t = F.silu(conv)[:, None, :]                       # (B, 1, di)
    dt, Bt, Ct = _ssm_inputs(p, xi_t, cfg, tp)
    A = -torch.exp(p["A_log"])
    x0 = xi_t[:, 0].float()
    da = torch.exp(dt[:, 0, :, None] * A)                 # (B, di, N)
    h = da * state.ssm + (dt[:, 0] * x0)[..., None] * Bt[:, 0, None, :]
    y = torch.einsum("bdn,bn->bd", h, Ct[:, 0]) + x0 * p["D"]
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    return _out(y @ p["out_proj"], tp), MambaState(conv=window[:, 1:], ssm=h)


def init_mamba_state(cfg: ArchConfig, batch: int, device,
                     tp=None) -> MambaState:
    """Zero states; with ``tp``, of this rank's channels."""
    tp = channels(cfg, tp)
    di = cfg.d_inner if tp is None else cfg.d_inner // tp.size
    return MambaState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di),
                         dtype=dtype_of(cfg), device=device),
        ssm=torch.zeros((batch, di, cfg.ssm_state),
                        dtype=torch.float32, device=device))
