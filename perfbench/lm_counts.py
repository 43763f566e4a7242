"""The frozen counts of the LM cells: the bytes and operations that bound a
decode step of granite-4.0-h, and its pieces the per-layer metrics read.

Every count is of what the work needs, not of what the program does: each
weight read once a step, each state read once and written once, the live
key and value rows read once, the logits written once.  ``c`` is the
configuration's file (the published ``config.json`` keys and
``n_layers``, the layers held).
"""
from __future__ import annotations

from perfbench import counts

#: bfloat16 operations/s of one H100 SXM on its tensor cores, dense (NVIDIA
#: data sheet).
BF16_OPS_S = 989e12
BF16, F32 = 2, 4


def layer_kinds(c: dict) -> list:
    """``"mamba"`` or ``"attention"`` for each layer held."""
    return c["layer_types"][:c["n_layers"]]


def _sizes(c: dict) -> tuple:
    d, H, P = c["hidden_size"], c["mamba_n_heads"], c["mamba_d_head"]
    G, N = c["mamba_n_groups"], c["mamba_d_state"]
    di = H * P
    return d, H, P, G, N, di, di + 2 * G * N


def mamba2_weight_bytes(c: dict) -> int:
    """One Mamba-2 mixer's weights with its norm: ``in_proj``, the conv and
    its bias, ``out_proj``, the gated norm in bfloat16; ``dt_bias``,
    ``A_log`` and ``D`` in float32.  102.3 M parameters at the published
    widths."""
    d, H, P, G, N, di, cd = _sizes(c)
    K = c["mamba_d_conv"]
    return BF16 * (d * (di + cd + H) + K * cd + cd + di + di * d + d) \
        + F32 * 3 * H


def attention_weight_bytes(c: dict) -> int:
    """One attention mixer's ``wq``, ``wk``, ``wv``, ``wo`` with its norm:
    41.9 M parameters."""
    d, nq, nkv = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"]
    hd = d // nq
    return BF16 * (2 * d * nq * hd + 2 * d * nkv * hd + d)


def moe_weight_bytes(c: dict) -> int:
    """One MoE layer's weights, every expert touched once: the 72 experts
    (679.5 M), the shared expert (18.9 M), the float32 router and the
    norm."""
    d, E = c["hidden_size"], c["num_local_experts"]
    f, fs = c["intermediate_size"], c["shared_intermediate_size"]
    return BF16 * (3 * E * d * f + 3 * d * fs + d) + F32 * d * E


def head_weight_bytes(c: dict) -> int:
    """The tied table read once as the head, and the final norm."""
    return BF16 * (c["vocab_size"] + 1) * c["hidden_size"]


def state_bytes(c: dict, slots: int) -> int:
    """One layer's float32 Mamba-2 states of ``slots`` rows: 4.19 MB a
    row at the published widths."""
    d, H, P, G, N, di, cd = _sizes(c)
    return F32 * slots * H * P * N


def conv_state_bytes(c: dict, slots: int) -> int:
    """One layer's bfloat16 conv states: the last K-1 conv inputs."""
    d, H, P, G, N, di, cd = _sizes(c)
    return BF16 * slots * (c["mamba_d_conv"] - 1) * cd


def kv_row_bytes(c: dict) -> int:
    """One position's key and value in one attention layer, bfloat16."""
    d, nq, nkv = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"]
    return BF16 * 2 * nkv * (d // nq)


def mamba2_state_call_bytes(c: dict, slots: int) -> int:
    """One decode call's state update and readout: the state read once
    and written once, ``x``, ``dt``, ``B`` and ``C`` in, ``y`` out, all
    float32."""
    d, H, P, G, N, di, cd = _sizes(c)
    return 2 * state_bytes(c, slots) \
        + F32 * slots * (di + H + 2 * G * N + di)


def step_bytes(c: dict, slots: int, positions) -> int:
    """A decode step of ``slots`` rows, row ``b`` writing position
    ``positions[b]``: every weight once, every Mamba-2 and conv state read
    and written once, each attention layer's live keys and values read
    once (the new row written once), the logits written once.  About
    37.7 GB at the cell's size."""
    kinds = layer_kinds(c)
    n_m, n_a = kinds.count("mamba"), kinds.count("attention")
    live = sum(int(p) + 1 for p in positions)
    return (n_m * mamba2_weight_bytes(c) + n_a * attention_weight_bytes(c)
            + len(kinds) * moe_weight_bytes(c) + head_weight_bytes(c)
            + n_m * 2 * (state_bytes(c, slots) + conv_state_bytes(c, slots))
            + n_a * (live + slots) * kv_row_bytes(c)
            + BF16 * slots * c["vocab_size"])


def step_ops(c: dict, slots: int, positions) -> int:
    """Operations of a decode step: two a multiply-add of every product a
    token takes (the mixers' projections, its 10 experts and the shared
    one, the router, the head), the attention's scores and sums over the
    live positions, and the state update's five a state entry.  About 1.3
    TFLOP at the cell's size."""
    d, H, P, G, N, di, cd = _sizes(c)
    nq, nkv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // nq
    E, k = c["num_local_experts"], c["num_experts_per_tok"]
    f, fs = c["intermediate_size"], c["shared_intermediate_size"]
    kinds = layer_kinds(c)
    n_m, n_a = kinds.count("mamba"), kinds.count("attention")
    live = sum(int(p) + 1 for p in positions)
    per_token = (n_m * (2 * (d * (di + cd + H) + di * d) + 5 * H * P * N)
                 + n_a * 2 * (2 * d * nq * hd + 2 * d * nkv * hd)
                 + len(kinds) * 2 * (3 * k * d * f + 3 * d * fs + d * E)
                 + 2 * d * c["vocab_size"])
    return slots * per_token + n_a * 4 * nq * hd * live


def least_s(nbytes: float, ops: float) -> float:
    """The larger of bytes over the HBM bandwidth and operations over the
    bfloat16 tensor-core peak."""
    return max(nbytes / counts.HBM_BYTES_S, ops / BF16_OPS_S)
