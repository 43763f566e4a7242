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


def _causal_conv(x, w, b):
    """Depthwise causal conv along time.  x: (B, L, di), w: (K, di)."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
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


def selective_scan(x, dt, Bt, Ct, A, D, chunk: int = SCAN_CHUNK):
    """``mamba_scan_ref`` from a zero state, each chunk of ``chunk`` steps
    checkpointed (a length that ``chunk`` does not divide is one chunk, as
    in the reference).  The same values, bit for bit."""
    Bsz, L, d = x.shape
    if L % chunk:
        chunk = max(L, 1)
    xf = x.float()
    h = torch.zeros((Bsz, d, A.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for s in range(0, L, chunk):
        y, h = checkpoint(scan_steps, xf[:, s:s + chunk], dt[:, s:s + chunk],
                          Bt[:, s:s + chunk], Ct[:, s:s + chunk], A, h,
                          use_reentrant=False)
        ys.append(y)
    y = torch.cat(ys, 1) if ys else xf[:, :0]
    return y + xf * D, h


def _mix(p, x, cfg: ArchConfig, use_kernel: bool, tp=None):
    """Full-sequence mixer: (out (B, L, d), conv inputs (B, L, di), final
    scan state (B, di, N) f32).  The kernel's chunk is the whole sequence,
    which divides any length (the CUDA kernel tiles on its own), so a
    prompt of any length runs on it, unpadded: padding would enter the
    final state.  With ``tp``: di is this rank's channels."""
    tp = channels(cfg, tp)
    if tp is not None:
        x = transport.sum_backward(x, tp.group)
    # the rank's in_proj block is [x_r | z_r], so one chunk splits it too
    conv_in, z = (x @ p["in_proj"]).chunk(2, dim=-1)      # (B, L, di) each
    xi = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    dt, Bt, Ct = _ssm_inputs(p, xi, cfg, tp)
    A = -torch.exp(p["A_log"])
    if use_kernel:
        y, h = ms_ops.mamba_scan(xi.float(), dt, Bt, Ct, A, p["D"],
                                 chunk=max(1, xi.shape[1]))
    elif torch.is_grad_enabled():
        y, h = selective_scan(xi, dt, Bt, Ct, A, p["D"])
    else:
        y, h = mamba_scan_ref(xi, dt, Bt, Ct, A, p["D"])
    y = y.to(x.dtype) * F.silu(z)
    return _out(y @ p["out_proj"], tp), conv_in, h


def _out(y, tp):
    return y if tp is None else transport.row_sum(y, tp.group)


def mamba_block(p, x, cfg: ArchConfig, use_kernel: bool = False, tp=None):
    """Full-sequence mixer.  x: (B, L, d) -> (B, L, d)."""
    return _mix(p, x, cfg, use_kernel, tp)[0]


def mamba_prefill(p, x, cfg: ArchConfig, use_kernel: bool = False, tp=None):
    """Like ``mamba_block`` but also returns the decode state: the last
    K-1 conv inputs (zeros before the first, as the causal conv pads) and
    the scan's final state (with ``tp``: this rank's channels)."""
    out, conv_in, h = _mix(p, x, cfg, use_kernel, tp)
    K = cfg.ssm_conv
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
