"""A plain reference of granite-4.0-h (``granitemoehybrid``): the forward
of one sequence in float32, with no cache, batching or dispatch, from
the equations of the published model.  It imports nothing but ``torch``
and turns TF32 off while it runs, so that a float32 product on a card is
float32.

Each layer, with ``m`` the residual multiplier::

    x = x + m * mixer(rmsnorm(x))          # Mamba-2 or attention
    h = rmsnorm(x)
    x = x + m * (moe(h) + shared(h))

The embedding is scaled by ``embedding_multiplier``; the logits are the
tied table's, of ``rmsnorm(x)``, over ``logits_scaling``.

- Attention: GQA with no positional encoding, scores ``q . k`` times
  ``attention_multiplier``, causal.
- Mamba-2: ``[z | xBC | dt] = h W_in``; ``xBC`` through a depthwise causal
  conv with bias and SiLU, split into ``x`` (heads x head_dim), ``B`` and
  ``C`` (one group each); ``dt = softplus(dt + dt_bias)``, ``A =
  -exp(A_log)``; step by step ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t (x)
  B_t``, ``y_t = S_t C_t + D x_t``; then ``rmsnorm(y * silu(z))`` over each
  group's channels times ``norm``, and ``W_out``.
- MoE: the top ``experts_per_token`` of ``h W_r``, a softmax over those
  logits, each chosen expert's ``W_down(silu(h W_gate) * h W_up)`` weighted
  by it; no token is dropped.  The shared expert is the same MLP on every
  token.

Weights (any dtype; each layer's are cast to float32 as it runs), every
matrix ``(in, out)``: ``{"embed": (V, d), "final_norm": (d,), "layers":
[...]}``, a layer a dict of ``mixer_norm``, ``ffn_norm``, either
``attn.wq`` / ``attn.wk`` / ``attn.wv`` / ``attn.wo`` or ``mamba2.in_proj``
/ ``conv_w`` (K, channels) / ``conv_b`` / ``dt_bias`` / ``A_log`` / ``D`` /
``norm`` / ``out_proj``, and ``moe.router`` (d, E), ``moe.w_gate`` /
``moe.w_up`` (E, d, f), ``moe.w_down`` (E, f, d), ``moe.shared_gate`` /
``moe.shared_up`` / ``moe.shared_down``.  ``cfg`` is a dict of the sizes
and multipliers :func:`forward` reads.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _mlp(h, gate, up, down):
    return (torch.nn.functional.silu(h @ gate) * (h @ up)) @ down


def _attention(h, w, cfg):
    T = h.shape[0]
    H, Hkv, D = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = (h @ w["attn.wq"]).reshape(T, H, D).transpose(0, 1)
    k = (h @ w["attn.wk"]).reshape(T, Hkv, D).transpose(0, 1)
    v = (h @ w["attn.wv"]).reshape(T, Hkv, D).transpose(0, 1)
    k = k.repeat_interleave(H // Hkv, 0)
    v = v.repeat_interleave(H // Hkv, 0)
    s = (q @ k.transpose(1, 2)) * cfg["attention_multiplier"]
    future = torch.ones((T, T), dtype=torch.bool, device=h.device).triu(1)
    p = torch.softmax(s.masked_fill(future, float("-inf")), -1)
    return (p @ v).transpose(0, 1).reshape(T, H * D) @ w["attn.wo"]


def _mamba2(h, w, cfg):
    T = h.shape[0]
    H, P = cfg["ssm_heads"], cfg["ssm_head_dim"]
    G, N = cfg["ssm_groups"], cfg["ssm_state"]
    di = H * P
    zxbcdt = h @ w["mamba2.in_proj"]
    z, xBC, dt = zxbcdt.split([di, di + 2 * G * N, H], -1)
    K = w["mamba2.conv_w"].shape[0]
    pad = torch.cat([xBC.new_zeros((K - 1, xBC.shape[1])), xBC])
    conv = sum(pad[k:k + T] * w["mamba2.conv_w"][k] for k in range(K))
    xBC = torch.nn.functional.silu(conv + w["mamba2.conv_b"])
    x, B, C = xBC.split([di, G * N, G * N], -1)
    x = x.reshape(T, H, P)
    heads = torch.arange(H, device=h.device) // (H // G)
    B = B.reshape(T, G, N)[:, heads]                         # (T, H, N)
    C = C.reshape(T, G, N)[:, heads]
    dt = torch.nn.functional.softplus(dt + w["mamba2.dt_bias"])   # (T, H)
    A = -torch.exp(w["mamba2.A_log"])
    decay = torch.exp(dt * A)
    S = h.new_zeros((H, P, N))
    y = torch.empty_like(x)
    for t in range(T):
        S = decay[t][:, None, None] * S \
            + (dt[t][:, None] * x[t])[:, :, None] * B[t][:, None, :]
        y[t] = (S @ C[t][:, :, None])[..., 0] + w["mamba2.D"][:, None] * x[t]
    g = (y.reshape(T, di) * torch.nn.functional.silu(z)).reshape(T, G, -1)
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + cfg["eps"])
    return (g.reshape(T, di) * w["mamba2.norm"]) @ w["mamba2.out_proj"]


def _moe(h, w, cfg):
    logits = h @ w["moe.router"]
    top, idx = logits.topk(cfg["experts_per_token"], dim=-1)
    gates = torch.softmax(top, -1)
    y = torch.zeros_like(h)
    for e in range(w["moe.router"].shape[1]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            out = _mlp(h[tok], w["moe.w_gate"][e], w["moe.w_up"][e],
                       w["moe.w_down"][e])
            y.index_add_(0, tok, gates[tok, slot][:, None] * out)
    return y + _mlp(h, w["moe.shared_gate"], w["moe.shared_up"],
                    w["moe.shared_down"])


def forward(tokens, weights: dict, cfg: dict, last: int | None = None):
    """Logits (T, V) in float32 of the token ids ``tokens`` (T,), or of
    the ``last`` positions only."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        return _forward(tokens, weights, cfg, last)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = before


def _forward(tokens, weights, cfg, last):
    eps, m = cfg["eps"], cfg["residual_multiplier"]
    table = weights["embed"].to(F32)
    x = table[tokens] * cfg["embedding_multiplier"]
    for layer in weights["layers"]:
        w = {k: v.to(F32) for k, v in layer.items()}
        h = _rmsnorm(x, w["mixer_norm"], eps)
        mix = _attention if "attn.wq" in w else _mamba2
        x = x + m * mix(h, w, cfg)
        x = x + m * _moe(_rmsnorm(x, w["ffn_norm"], eps), w, cfg)
        del w
    if last is not None:
        x = x[x.shape[0] - last:]
    x = _rmsnorm(x, weights["final_norm"].to(F32), eps)
    return (x @ table.T) / cfg["logits_scaling"]
