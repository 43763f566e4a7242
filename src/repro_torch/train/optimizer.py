"""AdamW with a cosine schedule and global-norm clipping, Adafactor, and
int8 error-feedback gradient compression: the JAX package's
``train/optimizer.py``.

Every function works on the reference's leaves (``models.convert.Leaf``,
from ``reference_leaves(model)``), one tensor per leaf for the gradients
and the state: a stack parameter is one ``(n_blocks, ...)`` leaf, so weight
decay (``ndim >= 2``), Adafactor's factored moments and the int8 scale see
the reference's shapes.  The state is ``{"mu": [...], "nu": [...],
"count": int32}`` (Adafactor: ``{"v": [...], "count"}``), its lists in leaf
order; ``count`` is a 0-d CPU tensor, so the schedule is computed on the
host in float32, as the reference computes it, without waiting on the card.

The reference donates its parameters and state to the jitted step; here
the update writes them in place: the state tensors directly, the
parameters by ``copy_`` block by block, with no second copy of either.
Its arithmetic is the reference's, in float32, element for element.

ZeRO-1 (:func:`zero1_blocks`): over the data ranks of a mesh, AdamW's
``mu`` / ``nu`` of a leaf hold only this rank's block of
``parallel.zero1_pspecs`` (the leaf's largest dim that the data ranks
divide); each rank updates its block of the parameters and the blocks are
all-gathered.  The arithmetic per element is the same as without it.
Under tensor parallelism a leaf is already this rank's block over
``model`` (``Leaf.layout``); ZeRO-1 cuts that block over the data axes.
Under FSDP a leaf with an FSDP block (``Leaf.fsdp``) is already cut over
the data axes: its moments are that block (``zero1_pspecs`` leaves a
data-sharded spec as it is), updated in place with no gather.

Adafactor over ranks (``mesh=``): its row and column statistics are of the
whole leaf, held whole on every rank (the reference's replicated state):
each rank's block contributes its sums (an entry two ``model`` ranks hold
weighted by one half), all-reduced over the ``model`` and data groups that
split the leaf, and each rank cuts the whole statistics back to its
block's rows and columns for its update.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..parallel import sharding

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 20
    total_steps: int = 1000
    min_lr_frac: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac * lr``; a 0-d float32
    CPU tensor, computed as the reference computes it in float32."""
    step = _f32(step).cpu()
    warm = _f32(cfg.lr) * step / max(1, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = _f32(cfg.min_lr_frac * cfg.lr) \
        + _f32((1 - cfg.min_lr_frac) * cfg.lr * 0.5) \
        * (1.0 + torch.cos(_f32(math.pi) * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _count() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


@dataclass(frozen=True)
class Zero1Block:
    """This rank's block of one leaf under ZeRO-1: ``count`` equal blocks
    along ``dim``, this one at ``index``; ``spec`` names the data axes
    that split ``dim`` (for the all-gather)."""

    dim: int
    index: int
    count: int
    spec: tuple

    def take(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[self.dim] // self.count
        return x.narrow(self.dim, self.index * size, size)

    def shape(self, shape) -> tuple:
        shape = list(shape)
        shape[self.dim] //= self.count
        return tuple(shape)


def zero1_blocks(params, mesh) -> list:
    """One :class:`Zero1Block` per leaf (``None`` where no dim divides over
    the data ranks): the data-axes entry of ``zero1_pspecs`` over the
    sanitized ``param_pspecs`` of the whole leaves, as the reference lays
    out its optimizer state (the dim a leaf's executed block splits over
    ``model`` is never picked: ``sharding.executed_pspecs``).  The block
    is of this rank's value of the leaf, whole along that dim.  Under FSDP
    the specs are the FSDP layout's (``sharding.fsdp_specs``, or
    ``sharding.fsdp_seq_specs`` where the blocks are over ``model`` too),
    and a leaf with an FSDP block gets ``None``: its value is its moments'
    block."""
    whole = [sharding.WholeLeaf(leaf.path, leaf.whole_shape)
             for leaf in params]
    fsdp = any(leaf.fsdp is not None for leaf in params)
    seq = any(sharding.MODEL_AXIS in leaf.fsdp.axes for leaf in params
              if leaf.fsdp is not None)
    base = sharding.fsdp_seq_specs(whole, mesh) if seq \
        else sharding.fsdp_specs(whole, mesh) if fsdp \
        else sharding.executed_pspecs(params, mesh)
    dp = sharding.data_axes(mesh)
    coord = mesh.get_coordinate()
    out = []
    for leaf, s in zip(params, sharding.zero1_pspecs(whole, base, mesh)):
        dims = [i for i, e in enumerate(s)
                if set(sharding.axes_of(e)) & set(dp)]
        if not dims or leaf.fsdp is not None:
            out.append(None)
            continue
        entry = s[dims[0]]
        index, count = sharding.block_index(entry, mesh, coord)
        blk = [None] * leaf.ndim
        blk[dims[0]] = entry
        out.append(Zero1Block(dims[0], index, count, sharding.spec(*blk)))
    return out


def adamw_init(params, opt_dtype=F32, blocks=None) -> dict:
    """First and second moments, zero, one per leaf (float32 by default;
    ``opt_dtype=torch.bfloat16`` is the reference's memory recipe for the
    400B-class archs).  ``blocks`` (from :func:`zero1_blocks`): each
    moment only this rank's block of its leaf."""
    blocks = blocks or [None] * len(params)
    zeros = [torch.zeros(b.shape(p.shape) if b else p.shape,
                         dtype=opt_dtype, device=p.device)
             for p, b in zip(params, blocks)]
    return {"mu": zeros, "nu": [torch.zeros_like(z) for z in zeros],
            "count": _count()}


def global_norm(leaves, params=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.  Under tensor
    parallelism (``params``: the leaves' ``Leaf``s, blocks over ``mesh``'s
    ``model`` axis) the squares of the split leaves are summed over the
    ``model`` group, each entry weighted by 1 / the ranks holding it, and
    the leaves whole on every rank are counted once.  Under FSDP the
    squares of the leaves with an FSDP block are also summed over their
    blocks' group (the data axes; every rank under ``"fsdp_seq"``)."""
    axis = sharding.model_axis(mesh)
    fsdp = params is not None and mesh is not None \
        and any(p.fsdp is not None for p in params)
    if not fsdp and (axis is None or params is None
                     or all(p.layout.whole for p in params)):
        norms = [torch.linalg.vector_norm(x, dtype=F32) for x in leaves]
        return torch.linalg.vector_norm(torch.stack(norms))
    # squares by (split over model, split over data)
    sums = {(m, d): [] for m in (False, True) for d in (False, True)}
    for x, p in zip(leaves, params):
        split = axis is not None and not p.layout.whole
        if split:
            w = p.layout.weights(axis.rank, x.ndim, int(p.stacked), x.device)
            sq = (x.float().square() * w).sum()
        else:
            sq = torch.linalg.vector_norm(x, dtype=F32).square()
        sums[(split, p.fsdp is not None)].append(sq)
    total = {k: torch.stack(v).sum() if v else
             torch.zeros((), dtype=F32, device=leaves[0].device)
             for k, v in sums.items()}
    over_model = torch.stack([total[(True, False)], total[(True, True)]])
    if axis is not None:
        sharding.transport.all_reduce(over_model, axis.group)
    out = total[(False, False)] + over_model[0]
    if fsdp:
        over_data = total[(False, True)] + over_model[1]
        group = next(p.fsdp.group for p in params if p.fsdp is not None)
        out = out + sharding.transport.all_reduce(over_data, group)
    return out.sqrt()


def _clip_scale(cfg: AdamWConfig, gnorm: torch.Tensor) -> torch.Tensor:
    return torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def _moment(m: torch.Tensor, beta: float, x: torch.Tensor) -> torch.Tensor:
    """m <- beta * m + (1 - beta) * x in float32, stored in m's dtype.
    ``add`` with ``alpha`` is one fused multiply-add, fma(beta, m, (1 -
    beta) * x), where XLA fuses it too: bfloat16 moments round from the
    same float32 bits as the reference's."""
    return m.copy_(torch.mul(x, 1 - beta).add_(m, alpha=beta))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: dict, params,
                 blocks=None, mesh=None):
    """One AdamW step over the leaves ``params`` with one gradient per
    leaf.  Writes the parameters and ``state`` in place and returns
    ``(params, state, {"grad_norm", "lr"})``.  With ZeRO-1 ``blocks`` (and
    their ``mesh``), a leaf with a block is updated on that block only and
    all-gathered over the data ranks.  Under tensor parallelism ``mesh``
    also gives the global norm its ``model`` group."""
    gnorm = global_norm(grads, params, mesh)
    scale = _clip_scale(cfg, gnorm)
    count = state["count"] + 1
    cf = count.to(F32)
    lr = cosine_schedule(cfg, count)
    bc1 = float(1 - _f32(cfg.b1) ** cf)
    bc2 = float(1 - _f32(cfg.b2) ** cf)
    step_lr = float(lr)
    blocks = blocks or [None] * len(params)
    for leaf, grad, mu, nu, blk in zip(params, grads, state["mu"],
                                       state["nu"], blocks):
        # decoupled weight decay on matrices only (ndim >= 2 of the leaf)
        wd = cfg.weight_decay if leaf.ndim >= 2 else 0.0
        if blk is None:
            for p, g, m, v in zip(leaf.tensors, leaf.parts(grad),
                                  leaf.parts(mu), leaf.parts(nu)):
                _adamw_leaf(cfg, p, g, m, v, scale, bc1, bc2, wd, step_lr)
            continue
        p = blk.take(leaf.value()).clone()
        _adamw_leaf(cfg, p, blk.take(grad), mu, nu, scale, bc1, bc2, wd,
                    step_lr)
        leaf.assign(sharding.gather(p, blk.spec, mesh))
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _adamw_leaf(cfg, p, g, m, v, scale, bc1, bc2, wd, step_lr) -> None:
    """AdamW on one tensor ``p`` and its moments, in place."""
    g = g.float() * scale
    _moment(m, cfg.b1, g)
    _moment(v, cfg.b2, torch.square(g))
    denom = (v.float() / bc2).sqrt_().add_(cfg.eps)
    upd = torch.div(m.float(), bc1, out=g).div_(denom)
    del denom
    p32 = p.float()                 # p itself when p is float32
    if wd:
        upd.add_(p32, alpha=wd)
    p32.add_(upd, alpha=-step_lr)
    if p32 is not p:
        p.copy_(p32)


# -------------------------------------------------------------- adafactor
def adafactor_init(params) -> dict:
    """Factored second moments (Shazeer & Stern, 2018): for a leaf of ndim
    >= 2, row and column statistics ``{"vr", "vc"}``; else ``{"v"}``; no
    first moment.  Of the whole leaf (``Leaf.whole_shape``) where the
    leaves are a rank's blocks."""
    def init(p):
        dev = p.device
        shape = tuple(getattr(p, "whole_shape", p.shape))
        if len(shape) >= 2:
            return {"vr": torch.zeros(shape[:-1], dtype=F32, device=dev),
                    "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32,
                                      device=dev)}
        return {"v": torch.zeros(shape, dtype=F32, device=dev)}
    return {"v": [init(p) for p in params], "count": _count()}


@torch.no_grad()
def adafactor_update(cfg: AdamWConfig, grads, state: dict, params,
                     decay: float = 0.8, mesh=None):
    """One Adafactor step (the reference's simplified form: no update
    clipping, no relative lr).  A stacked leaf is factored as a whole,
    across its blocks where the port's tensor is a vector.  In place, as
    :func:`adamw_update`.  ``mesh``: the leaves are this rank's blocks
    over its ``model`` axis and, under FSDP, its data axes; the statistics
    are the whole leaf's (see the module docstring)."""
    gnorm = global_norm(grads, params, mesh)
    scale = _clip_scale(cfg, gnorm)
    count = state["count"] + 1
    beta = float(1.0 - count.to(F32) ** -decay)
    lr = cosine_schedule(cfg, count)
    step_lr = float(lr)
    for leaf, grad, v in zip(params, grads, state["v"]):
        blocks = _Placement(leaf, mesh)
        g = grad.float() * scale
        g2 = torch.square(g).add_(1e-30)
        n = leaf.ndim
        if n >= 2:
            vr = _moment(v["vr"], beta, blocks.mean(g2, n - 1))
            vc = _moment(v["vc"], beta, blocks.mean(g2, n - 2))
            denom = (blocks.cut(vr, {n - 1})[..., None]
                     * blocks.cut(vc, {n - 2})[..., None, :]
                     / torch.clamp(blocks.cut(vc.mean(dim=-1),
                                              {n - 2, n - 1})[..., None, None],
                                   min=1e-30))
        else:
            denom = blocks.cut(_moment(v["v"], beta, blocks.mean(g2, None)),
                               set())
        upd = g.mul_(torch.rsqrt(denom + 1e-30))
        del g2, denom
        p32 = leaf.value().float()
        wd = cfg.weight_decay if leaf.ndim >= 2 else 0.0
        if wd:
            upd.add_(p32, alpha=wd)
        leaf.assign(p32.add_(upd, alpha=-step_lr))
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}


class _Placement:
    """Where a leaf's value (this rank's block) sits in the whole leaf: the
    dim its ``model`` block splits (with the entries the rank holds) and
    the dim its FSDP block splits, both in the leaf's dims."""

    def __init__(self, leaf, mesh):
        off = int(leaf.stacked)
        self.whole = leaf.whole_shape
        axis = sharding.model_axis(mesh)
        self.tp = None if axis is None or leaf.layout.whole \
            else (leaf.layout.dim + off, leaf.layout, axis)
        self.fs = None if leaf.fsdp is None \
            else (leaf.fsdp.dim + off, leaf.fsdp)

    def _weights(self, x, dim: int, keep: bool):
        """x times 1 / (the ranks holding each entry) along the model
        block's dim (``keep``: x lacks the summed dim ``dim``)."""
        t, lay, axis = self.tp
        w = lay.weights(axis.rank, 1, -lay.dim, x.device)
        pos = t - (1 if keep and dim is not None and t > dim else 0)
        shape = [1] * x.ndim
        shape[pos] = -1
        return x * w.reshape(shape)

    def mean(self, x: torch.Tensor, dim) -> torch.Tensor:
        """The whole leaf's mean of ``x`` (this rank's block of a tensor of
        the leaf's shape) over leaf dim ``dim`` (``None``: no dim, the
        whole tensor), on every rank."""
        if self.tp is None and self.fs is None:
            return x if dim is None else x.mean(dim=dim)
        split = dim is not None and any(
            b is not None and b[0] == dim for b in (self.tp, self.fs))
        if split:
            if self.tp is not None and self.tp[0] == dim:
                x = self._weights(x, dim, keep=False)
            part = x.sum(dim=dim) / self.whole[dim]
        else:
            part = x if dim is None else x.mean(dim=dim)
        if self.tp is not None and self.tp[0] != dim:
            part = self._weights(part, dim, keep=True)
        shape = [n for i, n in enumerate(self.whole) if i != dim]
        out = part.new_zeros(shape)
        place = out
        if self.fs is not None and self.fs[0] != dim:
            f, blk = self.fs
            pos = f - (1 if dim is not None and f > dim else 0)
            size = self.whole[f] // blk.count
            place = place.narrow(pos, blk.index * size, size)
        if self.tp is not None and self.tp[0] != dim:
            t, lay, axis = self.tp
            pos = t - (1 if dim is not None and t > dim else 0)
            place.index_add_(pos, lay._index(axis.rank, x.device), part)
        else:
            place.copy_(part)
        if self.tp is not None:
            sharding.transport.all_reduce(out, self.tp[2].group)
        if self.fs is not None:
            sharding.transport.all_reduce(out, self.fs[1].group)
        return out

    def cut(self, x: torch.Tensor, dropped: set) -> torch.Tensor:
        """This rank's block of ``x``, a whole tensor over the leaf's dims
        but ``dropped``."""
        def pos(d):
            return d - sum(1 for e in dropped if e < d)
        if self.fs is not None and self.fs[0] not in dropped:
            f, blk = self.fs
            size = self.whole[f] // blk.count
            x = x.narrow(pos(f), blk.index * size, size)
        if self.tp is not None and self.tp[0] not in dropped:
            t, lay, axis = self.tp
            x = x.index_select(pos(t), lay._index(axis.rank, x.device))
        return x


# ------------------------------------------------------- int8 compression
def quantize_int8(leaves) -> tuple:
    """Symmetric int8 quantization, one scale per leaf: ``(q, scales)``
    lists."""
    qs, scales = [], []
    for x in leaves:
        xf = x.float()
        scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
        qs.append(torch.round(xf / scale).to(torch.int8))
        scales.append(scale)
    return qs, scales


def dequantize_int8(qs, scales) -> list:
    return [q.float() * s for q, s in zip(qs, scales)]


def compress_error_feedback(grads, residual) -> tuple:
    """int8 compression with error feedback: ``(q, scales, new_residual)``
    with ``dequant(q) + new_residual == grads + residual`` up to rounding,
    so repeated compressed reductions stay unbiased across steps."""
    target = [g.float() + r for g, r in zip(grads, residual)]
    q, scales = quantize_int8(target)
    new_res = [t - d for t, d in zip(target, dequantize_int8(q, scales))]
    return q, scales, new_res
