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
dropped on the way in and read back as zeros.  Prefill and decode, which
discard the aux loss, skip it (``need_aux=False``).

With ``cfg.moe_dropless`` (port only) the capacity is ``T``, the most
assignments an expert can get, so none is dropped; the experts' buffers
are then ``E / k`` times the assignments, computed as rows of zeros.
``cfg.shared_ff`` (port only) adds a shared SwiGLU expert of that width,
applied to every token beside the routed ones (:func:`shared_expert`).

Every dispatch counts its assignments and the dropped ones
(:data:`assignments`, :data:`dropped`, read with :func:`snapshot` /
:func:`since`): the assignments on the host from the shapes, the dropped
ones summed on the device into a tensor that is read only when asked, so
counting makes no host sync.  Fake tensors (a capture) count nothing.

``groups`` splits the T tokens into equal groups routed on their own: each
group has its own capacity and its own ranks, as if each were a separate
call.  A continuous engine decodes its slots in one batched call where the
reference maps the model over the slots (``jax.vmap``), so that each
slot's single token sees ``capacity(cfg, 1)`` and is never dropped;
``moe_ffn(..., per_row=True)`` gives each batch row its own group to match.
The experts still run once, over every group's buffer.

``ep_local`` is the expert-parallel dispatch over the ``model`` axis of a
``DeviceMesh``: each model rank holds ``E / R`` of the experts
(``init_moe(..., keep=)``) and dispatches only to them; see
:func:`moe_ffn_ep_local`.  Under tensor parallelism its input is the
replicated residual every model rank holds.

Sequence sharding (``seq``, the ``"fsdp_seq"`` layout,
:func:`moe_ffn_seq`): the experts are gathered whole on every rank, and
each rank holds its data shard's rows and its block of their positions.
The reference routes each microbatch's global batch as one flat ``(B L,
k)`` list, so the capacity is ``capacity(cfg, B_global L)`` and an
assignment's rank within its expert counts every earlier assignment of
the global list: those of the rows before it on every rank, those of its
row's blocks on lower ``model`` ranks, and the earlier ones of this rank;
one all-gather of every rank's per-(row, expert) counts gives them.  The
same tokens drop as in the single-device reference.  The aux loss sums
the top-1 counts and the router probabilities over every rank before the
product.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from ..parallel import sharding, transport
from .config import ArchConfig
from .layers import Params, activation, dtype_of, normal, whole

#: Routed assignments (tokens x experts per token) in this process.
assignments = 0
#: Dropped assignments, ``{device: 0-d int64 tensor}``, summed on the
#: device.
dropped: dict = {}


def _count(keep) -> None:
    """Count one dispatch's assignments, ``keep`` (T*k,) of them kept."""
    global assignments
    if isinstance(keep, FakeTensor) or keep.device.type == "meta":
        return
    assignments += keep.numel()
    total = dropped.get(keep.device)
    if total is None:
        with torch.inference_mode(False):
            total = dropped[keep.device] = torch.zeros(
                (), dtype=torch.int64, device=keep.device)
    total.add_((~keep).sum())


def snapshot() -> tuple:
    """The counters as they stand, for :func:`since` (a device copy of each
    dropped total: no host sync)."""
    return assignments, {d: t.clone() for d, t in dropped.items()}


def since(before: tuple) -> tuple:
    """(assignments, dropped) counted since ``before`` (:func:`snapshot`);
    reading the dropped count waits for the device."""
    n, totals = before
    lost = sum(int(t - totals.get(d, 0)) for d, t in dropped.items())
    return assignments - n, lost


def init_moe(cfg: ArchConfig, gen: torch.Generator, keep=whole) -> Params:
    """The router (``(d, E)``, f32) and the stacked experts ``w_gate``,
    ``w_up`` (``(E, d, f)``) and ``w_down`` (``(E, f, d)``).
    ``keep(name, tensor)`` gives the block a rank holds (its experts): each
    stacked tensor is drawn whole, from the same stream, and cut at once,
    so a rank holds its block of the very weights the whole model draws,
    never more than one whole tensor at a time."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype_of(cfg)
    s = 1.0 / math.sqrt(d)
    router = keep("moe.router", normal(gen, (d, E), torch.float32, s))
    w_gate = keep("moe.w_gate", normal(gen, (E, d, f), dt, s))
    w_up = keep("moe.w_up", normal(gen, (E, d, f), dt, s))
    w_down = keep("moe.w_down", normal(
        gen, (E, f, d), dt, 1.0 / math.sqrt(f) / math.sqrt(cfg.n_layers)))
    p = dict(router=router, w_gate=w_gate, w_up=w_up, w_down=w_down)
    fs = cfg.shared_ff
    if fs:
        p.update(shared_gate=keep("moe.shared_gate",
                                  normal(gen, (d, fs), dt, s)),
                 shared_up=keep("moe.shared_up", normal(gen, (d, fs), dt, s)),
                 shared_down=keep("moe.shared_down", normal(
                     gen, (fs, d), dt,
                     1.0 / math.sqrt(fs) / math.sqrt(cfg.n_layers))))
    return Params(**p)


def shared_expert(p, x, cfg: ArchConfig):
    """The shared expert: ``W_down(silu(x W_gate) * x W_up)`` on every
    token."""
    return (activation(cfg, x @ p["shared_gate"]) * (x @ p["shared_up"])) \
        @ p["shared_down"]


def expert_block(cfg: ArchConfig, mesh) -> slice | None:
    """The experts this rank holds under ``mesh`` (``None``: all of them):
    the ``r``-th of ``R`` equal blocks, ``r`` the rank's coordinate on the
    ``model`` axis of size ``R``."""
    R = _model_size(mesh)
    if R == 1:
        return None
    E = cfg.n_experts
    if E % R:
        raise ValueError(f"{cfg.name}: {E} experts do not split over a "
                         f"model axis of {R}")
    r = mesh.get_local_rank("model")
    return slice(r * E // R, (r + 1) * E // R)


def _model_size(mesh) -> int:
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index("model"))


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Assignments each expert keeps of ``n_tokens`` tokens: ``n_tokens``
    itself where the config drops none (an expert gets at most one of a
    token's ``k`` assignments)."""
    if cfg.moe_dropless:
        return n_tokens
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


def _aux(logits, topi, cfg: ArchConfig, need: bool):
    """The aux loss, or 0 where it is not used (prefill, decode)."""
    if need:
        return aux_load_balance_loss(logits, topi, cfg)
    return logits.new_zeros(())


def moe_ffn_dense(p, x, cfg: ArchConfig, groups: int = 1,
                  need_aux: bool = True):
    """One-hot einsum dispatch (oracle).  x: (T, d)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(cfg, T // groups)
    topw, topi, logits = _route(p, x, cfg)

    flat_e, onehot, rank = _ranks(topi, E, groups)
    onehot = onehot.float()                                      # (T*k, E)
    keep = rank < C
    _count(keep)
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
    return y, _aux(logits, topi, cfg, need_aux)


# ----------------------------------------------------------------- scatter
def moe_ffn_scatter(p, x, cfg: ArchConfig, groups: int = 1,
                    need_aux: bool = True):
    """Rank-within-expert scatter/gather dispatch (production path)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(cfg, T // groups)
    GC = groups * C                              # rows of each expert
    topw, topi, logits = _route(p, x, cfg)

    flat_e, _, rank = _ranks(topi, E, groups)
    keep = rank < C
    _count(keep)
    col = _group_of(T, k, groups, x.device) * C + rank
    slot = torch.where(keep, flat_e * GC + col, E * GC)          # E*GC: drop

    # row E*GC takes every dropped assignment and is cut off
    xr = x.repeat_interleave(k, dim=0)
    buf = x.new_zeros((E * GC + 1, d)).index_copy_(0, slot, xr)[:E * GC]
    out = _expert_mlp(p, buf.reshape(E, GC, d), cfg).reshape(E * GC, d)

    gathered = torch.cat([out, out.new_zeros((1, d))])[slot]     # drop -> 0
    back = gathered.float() * topw.reshape(-1)[:, None] * keep[:, None]
    y = back.reshape(T, k, d).sum(1).to(x.dtype)
    return y, _aux(logits, topi, cfg, need_aux)


# ---------------------------------------------------------------- ep_local
def moe_ffn_ep_local(p, x, cfg: ArchConfig, mesh=None):
    """Expert-parallel LOCAL dispatch over the ``model`` axis of ``mesh``.

    ``x`` (B, S, d) is this rank's token block, the same on every rank of
    its ``model`` group (the rows of its data shard); ``p`` holds the whole
    router and this rank's ``E / R`` experts (``expert_block``).  Each
    model rank routes the tokens, sizes the capacity from its LOCAL token
    count, fills only its own experts' buffers, and the one collective is
    a float32 all-reduce of the combined (T, d) output over the ``model``
    group, cast to ``x``'s dtype after it, as the reference's psum.  The
    aux loss is averaged over the data ranks (the other mesh axes).

    Gradients: each rank's graph holds only its experts, so what flows
    back into the routing weights and the expert inputs is partial; both
    pass an identity whose backward sums over the ``model`` group, and the
    output's all-reduce passes the gradient through.  The aux loss is
    computed from the router logits outside those identities, so its
    (whole) gradient is counted once.

    Without a mesh, or with a ``model`` axis of 1, this is the scatter
    path.  The rest of the layer is tensor parallel over the same axis
    (``models.layers``), so ``x`` is the replicated residual stream, whose
    gradient every model rank holds whole.
    """
    B, S, d = x.shape
    R = _model_size(mesh)
    if R == 1:
        y, aux = moe_ffn_scatter(p, x.reshape(B * S, d), cfg)
        return y.reshape(B, S, d), aux
    group = mesh.get_group("model")
    E, k = cfg.n_experts, cfg.experts_per_token
    E_loc = p["w_gate"].shape[0]
    if E_loc * R != E:
        raise ValueError(f"rank holds {E_loc} experts; {E} over {R} ranks "
                         f"is {E // R}")
    lo = mesh.get_local_rank("model") * E_loc
    T = B * S
    xf = x.reshape(T, d)
    topw, topi, logits = _route(p, xf, cfg)
    aux = aux_load_balance_loss(logits, topi, cfg)
    C = capacity(cfg, T)                   # per data shard: local tokens
    flat_e, _, rank_in_e = _ranks(topi, E, 1)
    _count(rank_in_e < C)
    local = (flat_e >= lo) & (flat_e < lo + E_loc) & (rank_in_e < C)
    slot = torch.where(local, (flat_e - lo) * C + rank_in_e, E_loc * C)

    xr = transport.sum_backward(xf, group).repeat_interleave(k, dim=0)
    buf = xf.new_zeros((E_loc * C + 1, d)).index_copy(0, slot, xr)
    h = _expert_mlp(p, buf[:E_loc * C].reshape(E_loc, C, d), cfg)
    gathered = torch.cat([h.reshape(E_loc * C, d), h.new_zeros((1, d))])[slot]
    w = transport.sum_backward(topw, group).reshape(-1)
    back = gathered.float() * w[:, None] * local[:, None]
    y = transport.sum_forward(back.reshape(T, k, d).sum(1), group)
    dp = [a for a in mesh.mesh_dim_names if a != "model"]
    if math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in dp) > 1:
        aux = transport.mean_forward(aux, sharding.axes_group(mesh, dp))
    return y.reshape(B, S, d).to(x.dtype), aux


# ---------------------------------------------------------------- fsdp_seq
def _global_ranks(topi, E: int, seq, replicated: bool):
    """Each of this rank's assignments' rank within its expert in the
    global flat list ((B S k,), in this rank's flat order), and the global
    token count.

    ``topi`` (B, S, k): this rank's rows and positions.  ``replicated``:
    every ``model`` rank holds the same tokens (decode), so only the data
    ranks' tokens are distinct."""
    B, S, k = topi.shape
    flat = topi.reshape(B, S * k)
    onehot = F.one_hot(flat, E)                                # (B, S k, E)
    in_row = (onehot.cumsum(1) - 1).gather(2, flat[..., None])[..., 0]
    counts = onehot.sum(1)                                     # (B, E)
    R = seq.size
    every = transport.all_gather(counts, seq.world)            # (W, B, E)
    every = every.reshape(seq.n_data, R, B, E)
    d = dist.get_rank(seq.world) // R
    if replicated:
        order = every[:, 0].reshape(seq.n_data * B, E)         # (d, row)
        first = d * B
        tokens = seq.n_data * B * S
    else:                                                      # (d, row, m)
        order = every.permute(0, 2, 1, 3).reshape(seq.n_data * B * R, E)
        first = d * B * R + seq.rank
        tokens = seq.n_data * R * B * S
    before = order.cumsum(0) - order                           # exclusive
    step = 1 if replicated else R
    rows = before[first + step * torch.arange(B, device=topi.device)]
    ranks = rows.gather(1, flat) + in_row                      # (B, S k)
    return ranks.reshape(-1), tokens


def moe_ffn_seq(p, x, cfg: ArchConfig, impl: str, seq,
                replicated: bool = False, need_aux: bool = True):
    """The MoE layer under sequence sharding (module docstring).  ``x``
    (B, S, d): this rank's rows and block of positions (``replicated``:
    the same tokens on every ``model`` rank, as decode runs them); ``p``
    holds every expert.  Each rank fills a buffer of its own kept
    assignments (those of global rank below C are a prefix of its
    assignments to each expert, in order), runs every expert over it and
    combines its tokens; no collective moves activations.  Without
    ``need_aux`` (prefill, decode) the aux loss is 0, with no all-reduce."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    xf = x.reshape(T, d)
    topw, topi, logits = _route(p, xf, cfg)
    ranks, tokens = _global_ranks(topi.reshape(B, S, k), E, seq, replicated)
    C = capacity(cfg, tokens)
    flat_e, onehot, local = _ranks(topi, E, 1)
    keep = ranks < C
    _count(keep)
    Cl = min(C, T * k)                     # this rank's kept, per expert
    xr = xf.repeat_interleave(k, dim=0)
    if impl == "dense":
        slots = torch.arange(E * Cl, device=x.device)
        col = torch.where(keep, flat_e * Cl + local, E * Cl)
        disp = (col[:, None] == slots).float()                 # (T k, E Cl)
        buf = (disp.T @ xr.float()).to(x.dtype).reshape(E, Cl, d)
        out = _expert_mlp(p, buf, cfg).reshape(E * Cl, d)
        back = disp @ out.float()
    else:
        slot = torch.where(keep, flat_e * Cl + local, E * Cl)
        buf = x.new_zeros((E * Cl + 1, d)).index_copy(0, slot, xr)[:E * Cl]
        out = _expert_mlp(p, buf.reshape(E, Cl, d), cfg).reshape(E * Cl, d)
        back = torch.cat([out, out.new_zeros((1, d))])[slot].float()
    back = back * topw.reshape(-1)[:, None] * keep[:, None]
    y = back.reshape(T, k, d).sum(1).to(x.dtype)
    if not need_aux:
        return y.reshape(B, S, d), torch.zeros((), device=x.device)
    # aux: top-1 counts and probability sums over every rank, then E f.p
    probs = torch.softmax(logits, dim=-1)
    part = torch.stack([F.one_hot(topi[:, 0], E).float().sum(0),
                        probs.sum(0)])
    whole = transport.sum_forward_scaled(part, seq.world, seq.n_data)
    n = tokens * (seq.size if replicated else 1)
    aux = E * (whole[0] / n * (whole[1] / n)).sum()
    return y.reshape(B, S, d), aux


def moe_ffn(p, x, cfg: ArchConfig, impl: str = "scatter",
            per_row: bool = False, mesh=None, seq=None,
            replicated: bool = False, need_aux: bool = True):
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar).  ``per_row`` routes
    each batch row on its own (capacity and ranks per row, the aux loss
    over all rows).  ``impl="ep_local"`` dispatches over ``mesh``'s
    ``model`` axis (:func:`moe_ffn_ep_local`).  ``seq``: routes the global
    batch under sequence sharding (:func:`moe_ffn_seq`; ``replicated``:
    the same tokens on every ``model`` rank; ``need_aux``: whether the
    aux loss is used).  A shared expert (``cfg.shared_ff``) adds its
    output to the routed experts'."""
    y, aux = _routed(p, x, cfg, impl, per_row, mesh, seq, replicated,
                     need_aux)
    if cfg.shared_ff:
        y = y + shared_expert(p, x, cfg)
    return y, aux


def _routed(p, x, cfg: ArchConfig, impl: str, per_row: bool, mesh, seq,
            replicated: bool, need_aux: bool):
    B, S, d = x.shape
    if seq is not None:
        if impl not in ("dense", "scatter"):
            raise NotImplementedError(
                f"moe_impl={impl!r} under layout='fsdp_seq': the experts "
                "are gathered whole and tokens route with 'scatter' or "
                "'dense'")
        if per_row:
            raise NotImplementedError("per-row routing has no "
                                      "sequence-sharded path")
        return moe_ffn_seq(p, x, cfg, impl, seq, replicated, need_aux)
    if impl == "ep_local":
        if per_row:
            raise NotImplementedError(
                "moe_impl='ep_local' routes a batch together; per-row "
                "routing (the continuous engines' decode) has no "
                "expert-parallel path")
        return moe_ffn_ep_local(p, x, cfg, mesh)
    if impl not in ("dense", "scatter"):
        raise ValueError(f"unknown moe_impl {impl!r}; known: 'dense', "
                         "'scatter', 'ep_local'")
    fn = moe_ffn_dense if impl == "dense" else moe_ffn_scatter
    y, aux = fn(p, x.reshape(B * S, d), cfg, groups=B if per_row else 1,
                need_aux=need_aux)
    return y.reshape(B, S, d), aux
