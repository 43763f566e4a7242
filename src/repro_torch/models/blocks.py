"""Layer-pattern machinery: every assigned architecture is a stack of
``n_layers`` layers, each layer = mixer (attention | mamba | mamba2 |
none) + FFN (dense | MoE | none), all pre-norm residual.  The mixer kind
``mamba2`` (``models.mamba2``, ``cfg.ssm_version == 2``) and an MoE with
a shared expert are the port's alone (``ArchConfig.port_only``), as is
``cfg.residual_multiplier``, which scales what each half of a layer adds
to the residual; a Mamba-2 layer runs whole on one device (no ``mesh``
model axis, no ``seq``).

Spans (``repro_torch.spans``): ``lm.attn`` around an attention mixer,
``lm.mamba2`` around a Mamba-2 mixer, ``lm.moe`` around an MoE FFN (the
router, the routed experts and a shared expert).

The JAX package finds the smallest repeating *pattern* of layers and
compiles the stack as a ``lax.scan`` over homogeneous super-blocks, its
parameters stacked along a leading ``n_blocks`` axis per pattern position.
PyTorch runs eagerly, so the port keeps the layers in a ``ModuleList`` in
depth order and loops over them: layer ``i * len(pattern) + pos`` is the
reference's block ``i``, position ``pos`` (``models.convert`` maps one to
the other).

``mesh``: the ``DeviceMesh`` whose ``model`` axis carries tensor and
expert parallelism; every function here threads it to the layers.  The
reference pins the residual stream to its activation spec at each block
boundary (``_pin_act``, a GSPMD hint); here the residual is whole on
every model rank by construction (every row-parallel output is summed),
so nothing stands in for it.

FSDP: a layer whose parameters hold blocks over the data axes is read
through ``parallel.fsdp.view``, which gathers each tensor whole on first
use: ``stack_apply`` inside a pattern period's checkpointed ``_block``
(the recompute gathers again in the backward pass, as XLA re-gathers a
scanned layer, and only one period is whole at a time), ``stack_prefill``
and ``stack_decode`` layer by layer.

``seq`` (a ``sharding.SeqAxis``, the ``"fsdp_seq"`` layout, with no
``mesh``): the residual is this rank's block of the positions (the
reference pins it to ``P(data, model, None)``), ``positions`` its global
positions; every mixer hands off over ``model`` (``models.layers``,
``models.mamba``), the MoE layers route the global batch
(``models.moe``), and the decode caches hold L / R positions a rank.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import spans
from ..parallel import fsdp, sharding
from . import layers, mamba, mamba2, moe
from .config import ArchConfig


@dataclass(frozen=True)
class LayerSpec:
    mixer: str          # "attn" | "mamba" | "mamba2" (port only) | "none"
    ffn: str            # "dense" | "moe" | "none"


def layer_specs(cfg: ArchConfig) -> tuple:
    """Per-layer (mixer, ffn) kinds for the full stack."""
    out = []
    for i in range(cfg.n_layers):
        if cfg.is_attn_layer(i):
            mixer = "attn"
        elif cfg.ssm_state:
            mixer = "mamba2" if cfg.ssm_version == 2 else "mamba"
        else:
            raise ValueError(f"layer {i} of {cfg.name} has no mixer")
        if cfg.d_ff == 0:
            ffn = "none"
        elif cfg.is_moe_layer(i):
            ffn = "moe"
        else:
            ffn = "dense"
        out.append(LayerSpec(mixer, ffn))
    return tuple(out)


def layer_pattern(cfg: ArchConfig) -> tuple:
    """Smallest repeating prefix of ``layer_specs`` that tiles the stack."""
    specs = layer_specs(cfg)
    n = len(specs)
    for p in range(1, n + 1):
        if n % p == 0 and all(specs[i] == specs[i % p] for i in range(n)):
            return specs[:p]
    return specs


def n_blocks(cfg: ArchConfig) -> int:
    return cfg.n_layers // len(layer_pattern(cfg))


# ------------------------------------------------------------------- params
class Layer(layers.Params):
    """One layer: ``mixer_norm`` + ``attn`` | ``mamba``, ``ffn_norm`` +
    ``mlp`` | ``moe`` (each present only where ``spec`` has it)."""

    def __init__(self, spec: LayerSpec, **entries):
        super().__init__(**entries)
        self.spec = spec


def init_layer(cfg: ArchConfig, spec: LayerSpec, gen: torch.Generator,
               keep=layers.whole) -> Layer:
    dt = layers.dtype_of(cfg)
    ones = lambda name: keep(name, torch.ones((cfg.d_model,), dtype=dt,
                                              device=gen.device))
    p = {}
    if spec.mixer == "attn":
        p.update(mixer_norm=ones("mixer_norm"),
                 attn=layers.init_attention(cfg, gen, keep))
    elif spec.mixer == "mamba":
        p.update(mixer_norm=ones("mixer_norm"),
                 mamba=mamba.init_mamba(cfg, gen, keep))
    elif spec.mixer == "mamba2":
        p.update(mixer_norm=ones("mixer_norm"),
                 mamba2=mamba2.init_mamba2(cfg, gen, keep))
    if spec.ffn == "dense":
        p.update(ffn_norm=ones("ffn_norm"),
                 mlp=layers.init_mlp(cfg, gen, keep=keep))
    elif spec.ffn == "moe":
        p.update(ffn_norm=ones("ffn_norm"),
                 moe=moe.init_moe(cfg, gen, keep=keep))
    return Layer(spec, **p)


def init_stack(cfg: ArchConfig, gen: torch.Generator,
               keep=layers.whole) -> nn.ModuleList:
    """Every layer of the stack, in depth order (``keep(name, tensor)``:
    the block of each tensor a rank holds)."""
    return nn.ModuleList(init_layer(cfg, spec, gen, keep)
                         for spec in layer_specs(cfg))


# -------------------------------------------------------------------- apply
def _add(x, out, cfg: ArchConfig):
    """The residual: ``x + out``, ``out`` scaled by
    ``cfg.residual_multiplier`` where that is not 1."""
    m = cfg.residual_multiplier
    return x + out if m == 1.0 else x + out * m


def _mamba2_alone(cfg: ArchConfig, tp, seq):
    if seq is not None or tp is not None:
        raise NotImplementedError(f"{cfg.name}: a Mamba-2 layer runs whole "
                                  "on one device (no model axis, no seq)")


def _ffn(p, spec: LayerSpec, x, cfg: ArchConfig, moe_impl: str,
         per_row: bool = False, mesh=None, seq=None,
         replicated: bool = False, need_aux: bool = True):
    """The layer's FFN half: (x, MoE aux loss or 0)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "dense":
        h = layers.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
        x = _add(x, layers.mlp_block(p["mlp"], h, cfg,
                                     tp=sharding.model_axis(mesh)), cfg)
    elif spec.ffn == "moe":
        with spans.span("lm.moe"):
            h = layers.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
            y, aux = moe.moe_ffn(p["moe"], h, cfg, impl=moe_impl,
                                 per_row=per_row, mesh=mesh, seq=seq,
                                 replicated=replicated, need_aux=need_aux)
            x = _add(x, y, cfg)
    return x, aux


def _apply_layer(p, spec: LayerSpec, x, cfg: ArchConfig, positions,
                 use_kernel: bool, moe_impl: str, mesh=None, seq=None):
    tp = sharding.model_axis(mesh)
    if spec.mixer == "attn":
        with spans.span("lm.attn"):
            h = layers.rms_norm(x, p["mixer_norm"], cfg.norm_eps)
            x = _add(x, layers.attention_block(
                p["attn"], h, cfg, positions, use_kernel=use_kernel, tp=tp,
                seq=seq), cfg)
    elif spec.mixer == "mamba":
        h = layers.rms_norm(x, p["mixer_norm"], cfg.norm_eps)
        x = _add(x, mamba.mamba_block(p["mamba"], h, cfg,
                                      use_kernel=use_kernel, tp=tp, seq=seq),
                 cfg)
    elif spec.mixer == "mamba2":
        _mamba2_alone(cfg, tp, seq)
        with spans.span("lm.mamba2"):
            h = layers.rms_norm(x, p["mixer_norm"], cfg.norm_eps)
            x = _add(x, mamba2.mamba2_block(p["mamba2"], h, cfg), cfg)
    return _ffn(p, spec, x, cfg, moe_impl, mesh=mesh, seq=seq)


def _block(layers_, x, aux, cfg: ArchConfig, positions, use_kernel: bool,
           moe_impl: str, mesh=None, seq=None):
    """The layers of one pattern period; the aux loss is carried through,
    as the reference's scan carries it."""
    for layer in map(fsdp.view, layers_):
        x, a = _apply_layer(layer, layer.spec, x, cfg, positions, use_kernel,
                            moe_impl, mesh, seq)
        aux = aux + a
    return x, aux


def stack_apply(stack, x, cfg: ArchConfig, positions=None,
                use_kernel: bool = False, moe_impl: str = "scatter",
                mesh=None, seq=None):
    """Forward through the whole stack.  Returns (x, total_aux_loss).
    ``mesh``: tensor and expert parallelism over its ``model`` axis;
    ``seq``: sequence sharding (``x`` this rank's block, ``positions``
    global).

    With ``cfg.remat`` and grad enabled, each pattern period (the
    reference's scanned block) is checkpointed: only its input is kept for
    the backward pass, which recomputes the rest, as the reference's
    ``jax.checkpoint(block_body)`` does.  The values are the same either
    way.  A recomputed period runs its collectives again, inside the
    backward pass; every rank builds the same graph, so they run in the
    same order on every rank."""
    P = len(layer_pattern(cfg))
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, len(stack), P):
        args = (stack[i:i + P], x, aux, cfg, positions, use_kernel, moe_impl,
                mesh, seq)
        x, aux = checkpoint(_block, *args, use_reentrant=False) if remat \
            else _block(*args)
    return x, aux


# ----------------------------------------------------------- prefill/decode
def init_caches(cfg: ArchConfig, batch: int, max_len: int, device,
                tp=None, seq=None, cache=None):
    """Zeroed decode caches, one entry per layer: attention -> {"k": (B,
    max_len, Hkv, D), "v": ...}; mamba -> MambaState; mamba2 ->
    Mamba2State; FFN-only -> None.
    ``batch`` is the rows this rank holds.  With ``tp`` (a
    ``sharding.ModelAxis``): the mamba states' channels of this rank, and
    the attention caches' kv heads its query heads read; with ``cache`` (a
    ``sharding.CacheBlock`` of ``batch`` rows): the attention caches are
    that block of ``max_len`` positions; with ``seq``: the attention
    caches' block of ``max_len / R`` positions, the mamba states whole."""
    dt = layers.dtype_of(cfg)
    heads = layers.attn_heads(cfg, tp)
    nkv = cfg.n_kv_heads if heads is None else len(heads.kv)
    if cache is not None:
        if cache.rows != batch:
            raise ValueError(f"{cfg.name}: a cache block of {cache.rows} "
                             f"rows for {batch}")
        nkv, max_len = len(cache.heads), cache.length
    if seq is not None:
        max_len = seq.block(max_len, f"{cfg.name}'s decode cache")
    shape = (batch, max_len, nkv, cfg.resolved_head_dim)
    caches = []
    for spec in layer_specs(cfg):
        if spec.mixer == "attn":
            caches.append({"k": torch.zeros(shape, dtype=dt, device=device),
                           "v": torch.zeros(shape, dtype=dt, device=device)})
        elif spec.mixer == "mamba":
            caches.append(mamba.init_mamba_state(cfg, batch, device, tp))
        elif spec.mixer == "mamba2":
            _mamba2_alone(cfg, tp, seq)
            caches.append(mamba2.init_mamba2_state(cfg, batch, device))
        else:
            caches.append(None)
    return caches


def stack_prefill(stack, x, cfg: ArchConfig, max_len: int,
                  use_kernel: bool = False, moe_impl: str = "scatter",
                  mesh=None, seq=None, positions=None, cache=None):
    """Forward producing decode caches (k/v padded to ``max_len``; with
    ``cache``, a ``sharding.CacheBlock``, its positions of them, and where
    L is split over ``model`` every kv head, gathered; with ``seq``, this
    rank's block of ``max_len / R`` positions of them, cut from the k / v
    its attention gathered, with no more communication)."""
    tp = sharding.model_axis(mesh)
    lo, Lc = 0, max_len
    if seq is not None:
        Lc = seq.block(max_len, f"{cfg.name}'s decode cache")
        lo = seq.rank * Lc
    elif cache is not None and cache.split:
        lo, Lc = cache.lo, cache.length
    caches = []
    for layer in map(fsdp.view, stack):
        spec = layer.spec
        if spec.mixer == "attn":
            with spans.span("lm.attn"):
                h = layers.rms_norm(x, layer["mixer_norm"], cfg.norm_eps)
                out, k, v = layers.attention_prefill(layer["attn"], h, cfg,
                                                     use_kernel, tp, seq,
                                                     positions, cache)
                x = _add(x, out, cfg)
            pad = (0, 0, 0, 0, 0, max_len - k.shape[1])
            k, v = F.pad(k, pad), F.pad(v, pad)
            if Lc != max_len:
                k = k[:, lo:lo + Lc].contiguous()
                v = v[:, lo:lo + Lc].contiguous()
            caches.append({"k": k, "v": v})
        elif spec.mixer == "mamba":
            h = layers.rms_norm(x, layer["mixer_norm"], cfg.norm_eps)
            out, state = mamba.mamba_prefill(layer["mamba"], h, cfg,
                                             use_kernel, tp, seq)
            x = _add(x, out, cfg)
            caches.append(state)
        elif spec.mixer == "mamba2":
            _mamba2_alone(cfg, tp, seq)
            with spans.span("lm.mamba2"):
                h = layers.rms_norm(x, layer["mixer_norm"], cfg.norm_eps)
                out, state = mamba2.mamba2_prefill(layer["mamba2"], h, cfg)
                x = _add(x, out, cfg)
            caches.append(state)
        else:
            caches.append(None)
        x, _ = _ffn(layer, spec, x, cfg, moe_impl, mesh=mesh, seq=seq,
                    need_aux=False)
    return x, caches


def stack_decode(stack, caches, x, cfg: ArchConfig, pos,
                 moe_impl: str = "scatter", mesh=None, seq=None, cache=None,
                 release: bool = False):
    """One step through the stack.  x: (B, S, d); ``pos`` an int (the write
    index of the whole batch) or a (B,) tensor (one per row).  Attention
    caches are written in place; returns (x, caches).  With a position per
    row, each row is a sequence of its own, so the MoE layers route each
    row on its own too (see ``models.moe``).  ``cache``: the attention
    caches' ``sharding.CacheBlock``.  ``release``: the caller hands the
    list ``caches`` over, and each entry is set to ``None`` as its layer
    runs, so that one layer's old state, not the stack's, is live beside
    the new states."""
    per_row = torch.is_tensor(pos) and pos.ndim == 1
    tp = sharding.model_axis(mesh)
    new_caches = []
    for i, layer in enumerate(map(fsdp.view, stack)):
        spec, c = layer.spec, caches[i]
        if release:
            caches[i] = None
        if spec.mixer == "attn":
            with spans.span("lm.attn"):
                h = layers.rms_norm(x, layer["mixer_norm"], cfg.norm_eps)
                out, ck, cv = layers.attention_decode(
                    layer["attn"], h, cfg, c["k"], c["v"], pos, tp, seq,
                    cache)
                x = _add(x, out, cfg)
            new_caches.append({"k": ck, "v": cv})
        elif spec.mixer == "mamba":
            h = layers.rms_norm(x, layer["mixer_norm"], cfg.norm_eps)
            out, state = mamba.mamba_decode(layer["mamba"], h, cfg, c, tp)
            x = _add(x, out, cfg)
            new_caches.append(state)
        elif spec.mixer == "mamba2":
            _mamba2_alone(cfg, tp, seq)
            with spans.span("lm.mamba2"):
                h = layers.rms_norm(x, layer["mixer_norm"], cfg.norm_eps)
                out, state = mamba2.mamba2_decode(layer["mamba2"], h, cfg, c)
                x = _add(x, out, cfg)
            new_caches.append(state)
        else:
            new_caches.append(None)
        x, _ = _ffn(layer, spec, x, cfg, moe_impl, per_row, mesh, seq,
                    replicated=True, need_aux=False)
    return x, new_caches
