"""Analytic (napkin-math) roofline inputs per (arch x shape x mesh) cell.

Why this exists: ``cost_analysis()`` FLOPs are reliable after loop
correction (validated in tests), but its byte counts on the CPU backend
reflect CPU fusion decisions — far more materialized intermediates than the
TPU compiler would leave.  The memory term therefore comes from this
analytic model of HBM round-trips under TPU-like fusion; the HLO-parsed
numbers are kept as diagnostics.  Coefficients are intentionally simple and
documented — the roofline's job is bottleneck identification, not 1%
accuracy.

Also provides MODEL_FLOPS (6·N·D dense / 6·N_active·D MoE) for the
"useful compute" ratio of EXPERIMENTS.md §Roofline.

The port's own copy of the JAX package's ``repro.core.analytic``, on the
port's ``models.factory.abstract_params`` (meta tensors by parameter name)
and ``models.blocks``.  The port keeps its layers one by one rather than
stacked over blocks, so an expert weight is 3-D here where the JAX
package's is 4-D; the counts are the same.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

from ..models import factory
from ..models.config import ArchConfig, ShapeConfig


@functools.lru_cache(maxsize=64)
def param_counts(cfg: ArchConfig) -> tuple:
    """(total_params, active_params) from the abstract params: an expert
    weight (``(E, d, f)`` under a ``w_gate`` / ``w_up`` / ``w_down`` name)
    counts ``experts_per_token`` of its ``n_experts`` experts as active."""
    total, active = 0, 0
    for name, leaf in factory.abstract_params(cfg).items():
        size = leaf.numel()
        total += size
        if cfg.n_experts and leaf.ndim == 3 \
                and name.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down"):
            active += (size // cfg.n_experts) * cfg.experts_per_token
        else:
            active += size
    return total, active


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS per step, whole-job (all devices together).

    train:   6 * N_active * tokens   (fwd 2ND + bwd 4ND)
    prefill: 2 * N_active * tokens
    decode:  2 * N_active * batch    (one token per sequence)
    """
    _, active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch


@dataclass(frozen=True)
class MemoryEstimate:
    """Per-device HBM traffic (bytes/step) and its components."""

    weights: float
    optimizer: float
    gradients: float
    activations: float
    caches: float
    head: float

    @property
    def total(self) -> float:
        return (self.weights + self.optimizer + self.gradients
                + self.activations + self.caches + self.head)

    def as_dict(self) -> dict:
        return {"weights": self.weights, "optimizer": self.optimizer,
                "gradients": self.gradients, "activations": self.activations,
                "caches": self.caches, "head": self.head, "total": self.total}


def _layer_act_width(cfg: ArchConfig, tp: int) -> float:
    """Bytes of activation traffic per token per layer (bf16, TPU-fused).

    Counts the flows that must round-trip HBM between fusions: the residual
    stream in/out of each sub-block (4·d), the TP-sharded inner flows
    (qkv+o heads, FFN gate/up/down), and mamba's d_inner flows.  MoE layers
    see capacity_factor-inflated expert flows.
    """
    d = cfg.d_model
    flows = 4.0 * d                                    # residual in/out, 2 subs
    if cfg.n_heads:
        hd = cfg.resolved_head_dim
        flows += (cfg.n_heads + 2 * cfg.n_kv_heads + cfg.n_heads) * hd / tp
    if cfg.ssm_state:
        flows += 6.0 * cfg.d_inner / tp                # xz, conv, scan y, gate
    if cfg.d_ff:
        ff_mult = 1.0
        if cfg.n_experts:
            ff_mult = cfg.capacity_factor * cfg.experts_per_token
        flows += 3.0 * cfg.d_ff * ff_mult / tp
    return flows * 2.0                                 # bf16


def analytic_memory(cfg: ArchConfig, shape: ShapeConfig, dp: int, tp: int,
                    n_micro: int = 1) -> MemoryEstimate:
    """Per-device HBM bytes for one step of this cell."""
    total, active = param_counts(cfg)
    p_loc = total * 2.0 / tp                           # bf16 shard
    p_act_loc = active * 2.0 / tp
    tokens_global = shape.global_batch * (1 if shape.is_decode
                                          else shape.seq_len)
    t_loc = tokens_global / dp                         # per-device tokens/step
    t_micro = t_loc / n_micro
    L = cfg.n_layers
    act_w = _layer_act_width(cfg, tp)

    if shape.kind == "train":
        # weights: read in fwd + remat-recompute + bwd, each microbatch
        weights = 3.0 * n_micro * p_loc
        # grad accumulation buffer rw (f32) per microbatch + final read
        gradients = (2.0 * n_micro + 1.0) * total * 4.0 / tp
        # AdamW: read mu,nu + write mu,nu (f32, ZeRO-1 sharded over dp)
        # + param read/write
        optimizer = 4.0 * total * 4.0 / (tp * dp) + 2.0 * p_loc
        # activations: fwd write + bwd read of the per-layer flows, plus the
        # remat recompute re-writing them once -> 3 passes
        activations = 3.0 * L * t_loc * act_w
        head = 3.0 * t_loc * cfg.vocab_size / tp * 2.0 \
            * (cfg.n_codebooks or 1)                   # logits fwd+bwd (bf16)
        caches = 0.0
    elif shape.kind == "prefill":
        weights = p_loc
        gradients = 0.0
        optimizer = 0.0
        activations = L * t_loc * act_w
        head = t_loc / shape.seq_len * cfg.vocab_size / tp * 2.0 \
            * (cfg.n_codebooks or 1)                   # last-position logits
        caches = _cache_bytes(cfg, shape, dp, tp)      # cache write
    else:                                              # decode
        weights = p_act_loc                            # every weight read once
        gradients = 0.0
        optimizer = 0.0
        activations = L * t_loc * act_w
        head = t_loc * cfg.vocab_size / tp * 2.0 * (cfg.n_codebooks or 1)
        caches = _cache_bytes(cfg, shape, dp, tp)      # full cache read + upd
    return MemoryEstimate(weights=weights, optimizer=optimizer,
                          gradients=gradients, activations=activations,
                          caches=caches, head=head)


def _cache_bytes(cfg: ArchConfig, shape: ShapeConfig, dp: int,
                 tp: int) -> float:
    """Per-device decode-cache traffic: attention KV streams the whole
    cache per step; mamba state is O(1) per token."""
    if not cfg.n_heads and not cfg.ssm_state:
        return 0.0
    from ..models import blocks
    pattern = blocks.layer_pattern(cfg)
    nb = blocks.n_blocks(cfg)
    hd = cfg.resolved_head_dim
    B = shape.global_batch
    total = 0.0
    for spec in pattern:
        if spec.mixer == "attn":
            kv = 2.0 * B * shape.seq_len * cfg.n_kv_heads * hd * 2.0  # bf16
            total += nb * kv
        elif spec.mixer == "mamba":
            st = B * cfg.d_inner * cfg.ssm_state * 4.0 * 2.0          # rw f32
            total += nb * st
    shards = dp * tp if shape.global_batch == 1 else dp
    return total / shards


def analytic_live_bytes(cfg: ArchConfig, shape: ShapeConfig, dp: int,
                        tp: int, n_micro: int = 1, fsdp: bool = False,
                        optimizer: str = "adamw") -> dict:
    """Per-device HBM FOOTPRINT (bytes live at peak) for the TPU target.

    Needed because XLA-CPU's memory_analysis includes f32 materializations
    of bf16 weights/activations that do not exist on TPU (float
    normalization; verified — e.g. a full f32 copy of all weights hoisted
    out of the decode loop).  Components:
      params (bf16, TP- and optionally FSDP-sharded), optimizer state,
      gradient accumulator, remat residual stack, decode caches, and a
      working-set allowance of 4 activation flows at the widest layer dim.
    """
    total, _ = param_counts(cfg)
    shard = tp * (dp if fsdp else 1)
    params = total * 2.0 / shard
    tokens_global = shape.global_batch * (1 if shape.is_decode
                                          else shape.seq_len)
    t_micro = tokens_global / dp / n_micro
    from ..models import blocks
    nb = blocks.n_blocks(cfg)

    opt = grads = residual = 0.0
    if shape.kind == "train":
        if optimizer == "adafactor":
            opt = total * 4.0 / 5000.0          # factored: ~(m+n) per (m,n)
            grads = total * 2.0 / shard         # bf16 accumulation
        else:
            opt = total * 8.0 / (tp * dp)       # ZeRO-1 f32 moments
            grads = total * 4.0 / shard         # f32 accumulation
        grads *= 2.0                            # accumulator + per-micro
        residual = nb * t_micro * cfg.d_model * 2.0
    # footprint: the cache shards over data AND model (batch/heads/seq —
    # cache_pspecs always finds two axes); _cache_bytes returns TRAFFIC
    # shards over dp only, so rescale.
    caches = _cache_bytes(cfg, shape, dp, tp)
    if shape.global_batch != 1:
        caches = caches / tp
    if shape.is_decode:
        caches = caches / 2.0                   # traffic counts read+update
    widest = max(cfg.d_model, (cfg.d_ff or 0) / tp,
                 (cfg.d_inner if cfg.ssm_state else 0) / tp,
                 cfg.padded_heads * cfg.resolved_head_dim / tp
                 if cfg.n_heads else 0)
    working = 4.0 * t_micro * widest * 2.0      # bf16 activation flows
    out = {"params": params, "optimizer": opt, "gradients": grads,
           "residuals": residual, "caches": caches, "working": working}
    out["total"] = sum(out.values())
    return out


def cell_summary(cfg: ArchConfig, shape: ShapeConfig, dp: int, tp: int,
                 n_micro: int = 1, n_chips: int | None = None) -> dict:
    n_chips = n_chips or dp * tp
    mf = model_flops(cfg, shape)
    mem = analytic_memory(cfg, shape, dp, tp, n_micro)
    total, active = param_counts(cfg)
    return {"model_flops_global": mf,
            "model_flops_per_chip": mf / n_chips,
            "params_total": total, "params_active": active,
            "analytic_hbm_bytes": mem.total,
            "analytic_hbm_breakdown": mem.as_dict()}
