"""Architecture configuration covering all assigned families
(dense / MoE / hybrid / SSM / VLM / audio LM backbones).

The JAX package's ``models/config.py`` with the same fields, defaults and
``reduced()``, so one config means the same model on both sides, plus the
fields only the port has (:data:`PORT_ONLY_FIELDS`): the Mamba-2 mixer
(``ssm_version=2`` with ``ssm_heads``, ``ssm_head_dim``, ``ssm_groups``,
``ssm_chunk``), a shared expert beside the routed ones (``shared_ff``),
routing that drops no assignment (``moe_dropless``), attention with no
positional encoding (``rope=False``) and a softmax scale of its own
(``attn_scale``), and the embedding, residual and logits multipliers.  At
their defaults they change nothing, so every config the JAX package has
computes the same function in both; a config that sets one has no JAX
counterpart (:meth:`ArchConfig.port_only`).  The port's forward reads
every field that shapes the function.  ``remat``
selects activation checkpointing under grad (each pattern period of the
stack, as the JAX package's ``jax.checkpoint`` of its scanned block); it
changes no value.  ``scan_layers`` (how the JAX package compiles the stack)
changes nothing; ``attn_expand_kv`` repeats k / v to one per query head
on each tensor-parallel rank (``models.layers``), which changes no value
either.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                   # 0 => attention-free (pure SSM)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads
    vocab_pad: int = 0             # table/head padding rows so the vocab
                                   # dim shards evenly; logits masked to
                                   # -inf over the padding (see lm._head)

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba-1) -------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2

    # --- port only: Mamba-2, shared expert, multipliers (PORT_ONLY_FIELDS) --
    ssm_version: int = 1           # 1 => Mamba-1; 2 => Mamba-2 (models.mamba2)
    ssm_heads: int = 0             # Mamba-2 heads; heads * head_dim = d_inner
    ssm_head_dim: int = 0
    ssm_groups: int = 1            # B / C groups shared by the heads
    ssm_chunk: int = 256           # Mamba-2 prefill's chunk length
    shared_ff: int = 0             # width of a shared expert (0 => none)
    moe_dropless: bool = False     # no assignment dropped (capacity T)
    rope: bool = True              # False => no positional encoding (NoPE)
    attn_scale: float = 0.0        # softmax scale; 0 => 1/sqrt(head_dim)
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0    # logits divided by it

    # --- hybrid interleave (Jamba: attn every 8th layer, MoE every 2nd) -----
    attn_period: int = 0           # 0 => all layers attend (or none if n_heads=0)
    attn_offset: int = 0
    moe_period: int = 0            # 0 => never MoE (or always for family=moe)
    moe_offset: int = 1

    # --- misc ----------------------------------------------------------------
    mlp_act: str = "swiglu"        # swiglu | geglu
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: Optional[str] = None  # "vision" | "audio" (stub frontends)
    frontend_dim: int = 0           # raw patch/frame feature width
    img_seq: int = 0                # vision: patch positions per sequence
    n_codebooks: int = 0            # audio: EnCodec codebooks
    dtype: str = "bfloat16"
    remat: bool = True              # activation checkpointing in train_step
    scan_layers: bool = True        # lax.scan over the (homogeneous) stack
    fused_proj: bool = False        # fuse [q|k|v] and [gate|up] projections:
                                    # coalesces the backward dx all-reduces
                                    # (EXPERIMENTS.md §Perf iteration A2)
    attn_expand_kv: bool = False    # materialize KV at full query-head
                                    # count and pin head-sharding: keeps the
                                    # blockwise-attention einsums rank-local
                                    # instead of AR-per-tile when kv_heads <
                                    # model-axis size (§Perf iteration B2)
    head_pad_multiple: int = 0      # zero-pad q heads (wq cols / wo rows) to
                                    # a multiple of the TP size: projection
                                    # output is then whole-head aligned, so
                                    # the reshape to (B,S,H,D) is local — no
                                    # all-to-all (§Perf iteration B3; exact:
                                    # padded lanes are zero-saddled)

    @property
    def padded_vocab(self) -> int:
        return self.vocab_size + self.vocab_pad

    @property
    def padded_heads(self) -> int:
        """Query-head count incl. TP-alignment padding (§Perf B3).

        Must stay divisible by n_kv_heads (padding is per KV group to
        preserve the GQA grouping); the smallest count satisfying both
        constraints is chosen."""
        if not self.head_pad_multiple or not self.n_heads:
            return self.n_heads
        m = self.head_pad_multiple
        nkv = max(self.n_kv_heads, 1)
        n = -(-self.n_heads // m) * m
        while n % nkv:
            n += m
        return n

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def port_only(self) -> tuple:
        """The fields of :data:`PORT_ONLY_FIELDS` this config sets away
        from their defaults: empty where the JAX package has the same
        model."""
        return tuple(f for f in PORT_ONLY_FIELDS
                     if getattr(self, f) != _DEFAULTS[f])

    def is_attn_layer(self, layer: int) -> bool:
        if self.n_heads == 0:
            return False
        if self.attn_period == 0:
            return True
        return layer % self.attn_period == self.attn_offset

    def is_moe_layer(self, layer: int) -> bool:
        if self.n_experts == 0:
            return False
        if self.moe_period == 0:
            return True
        return layer % self.moe_period == self.moe_offset

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, n_layers: int = 2, d_model: int = 64, d_ff: int = 128,
                vocab_size: int = 256, n_experts: int = 4,
                ssm_state: int = 8) -> "ArchConfig":
        """Smoke-test-sized config of the same family/topology."""
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = max(1, min(self.n_kv_heads, n_heads)) if n_heads else 0
        extra = {}
        if self.ssm_version == 2:       # Mamba-2: heads of 16 channels
            di = self.ssm_expand * d_model
            extra = dict(ssm_head_dim=16, ssm_heads=di // 16, ssm_chunk=8)
        if self.shared_ff:
            extra["shared_ff"] = d_ff
        return self.replace(**extra,
            name=self.name + "-smoke",
            n_layers=n_layers, d_model=d_model, d_ff=d_ff,
            vocab_size=vocab_size, vocab_pad=0,
            n_heads=n_heads, n_kv_heads=n_kv, head_dim=0,
            n_experts=min(self.n_experts, n_experts) if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            ssm_state=min(self.ssm_state, ssm_state) if self.ssm_state else 0,
            attn_period=min(self.attn_period, n_layers) if self.attn_period else 0,
            attn_offset=min(self.attn_offset, n_layers - 1),
            moe_period=self.moe_period and 2,
            frontend_dim=min(self.frontend_dim, 32) if self.frontend_dim else 0,
            img_seq=min(self.img_seq, 16) if self.img_seq else 0,
            dtype="float32", remat=False)


#: The fields only the port has (module docstring).
PORT_ONLY_FIELDS = ("ssm_version", "ssm_heads", "ssm_head_dim", "ssm_groups",
                    "ssm_chunk", "shared_ff", "moe_dropless", "rope",
                    "attn_scale", "embedding_multiplier",
                    "residual_multiplier", "logits_scaling")
_DEFAULTS = {f.name: f.default for f in dataclasses.fields(ArchConfig)}


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
