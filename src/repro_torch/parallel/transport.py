"""The collectives the parallel layer runs, and the route each one takes.

Every collective of ``parallel``, the models' tensor and expert
parallelism, ``train`` and the multi-rank sweep goes through this module, so that its route is decided
in one place:

* ``"direct"`` — the backend takes the tensor where it lies: NCCL on the
  card, gloo on the CPU, and gloo on the card for the collectives it
  implements for CUDA tensors (:data:`GLOO_CUDA`).
* ``"host"`` — gloo on a CUDA tensor for a collective gloo runs on host
  memory only: :func:`through_host` stages the buffers through pinned
  host memory, runs the collective there and copies the result back.

:data:`GLOO_CUDA` is what gloo accepted with CUDA tensors on an H100
machine (torch 2.11, 4 ranks on one card): all-reduce (f32, f64, bf16),
all-gather (list and into one tensor, int8 too), all-to-all of one tensor
(even and uneven splits), broadcast and reduce-scatter.  A point-to-point
send / receive of a CUDA tensor ends the process there (a
``gloo::IoException`` from the TCP transport's ``writev``), and gloo
refused the list form of all-to-all, which the port does not use.
``chip_smoke.py`` checks both on every run; ``routes`` counts the calls
per (collective, route) and ``volume`` the bytes each rank put in, and it
prints them.  A call on fake tensors (a capture, ``core.graph``) moves
nothing and counts nothing.

On one card shared by several gloo ranks these are the transport of the
world, not a measure of NVLink or NCCL: every GEMM and kernel stays on
the card, and each collective crosses host memory.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor

#: Collectives that gloo runs on CUDA tensors as they are.
GLOO_CUDA = frozenset({"all_reduce", "all_gather", "all_to_all_single",
                       "broadcast", "reduce_scatter"})

# the single-tensor all-gather and reduce-scatter under their current
# names (older releases have only the ones newer releases deprecate)
_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

#: Calls per (collective, route) in this process.
routes: Counter = Counter()
#: Bytes this rank put in per (collective, route) in this process.
volume: Counter = Counter()


#: The kind a capture records (``core.hlo`` names) of each collective
#: counted here, and the factor from its per-rank result bytes to the
#: bytes one rank puts in (the group size n: 1 / n, n or 1).
KINDS = {"all_reduce": ("all-reduce", 0), "all_gather": ("all-gather", -1),
         "reduce_scatter": ("reduce-scatter", 1),
         "all_to_all_single": ("all-to-all", 0)}


def snapshot() -> tuple:
    """The counters as they stand, for :func:`since`."""
    return Counter(routes), Counter(volume)


def since(before: tuple) -> dict:
    """``{collective: (calls, bytes put in)}`` counted since ``before``
    (:func:`snapshot`), over all routes."""
    out: dict = {}
    for (op, _), n in (routes - before[0]).items():
        calls, nbytes = out.get(op, (0, 0))
        out[op] = (calls + n, nbytes)
    for (op, _), n in (volume - before[1]).items():
        calls, nbytes = out.get(op, (0, 0))
        out[op] = (calls, nbytes + n)
    return out


def as_counted(ops) -> dict:
    """``{collective: (calls, bytes put in)}`` that one rank counts when it
    runs the collectives ``ops`` (a captured step's ``CollectiveOp``s)."""
    by_kind = {kind: (op, e) for op, (kind, e) in KINDS.items()}
    out: dict = {}
    for o in ops:
        op, e = by_kind[o.kind]
        per = o.result_bytes * o.group_size ** e
        calls, nbytes = out.get(op, (0, 0))
        n = int(round(o.multiplier))
        out[op] = (calls + n, nbytes + int(round(per)) * n)
    return out


def route(op: str, t: torch.Tensor, group=None) -> str:
    """``"host"`` where gloo would be handed a CUDA tensor for a collective
    it runs on host memory only, else ``"direct"``."""
    if t.is_cuda and dist.get_backend(group) == "gloo" \
            and op not in GLOO_CUDA:
        return "host"
    return "direct"


def through_host(fn, inputs, outputs):
    """Run ``fn(*host_inputs, *host_outputs)`` on pinned host copies of the
    device tensors ``inputs`` and ``outputs``, then copy each host output
    back into its device tensor (an output ``fn`` leaves alone keeps its
    values)."""
    def pinned(t):
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=t.is_cuda).copy_(t)
    host_in = [pinned(t) for t in inputs]
    host_out = [pinned(t) for t in outputs]
    fn(*host_in, *host_out)
    for t, h in zip(outputs, host_out):
        t.copy_(h)


def _count(op: str, t: torch.Tensor, group) -> str:
    r = route(op, t, group)
    if isinstance(t, FakeTensor):
        return r
    routes[(op, r)] += 1
    volume[(op, r)] += t.numel() * t.element_size()
    return r


def all_reduce(t: torch.Tensor, group=None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place (a sum unless ``op`` says
    otherwise); returns ``t``."""
    _count("all_reduce", t, group)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``(n, *t.shape)``: every rank's ``t`` in group-rank order."""
    _count("all_gather", t, group)
    n = dist.get_world_size(group)
    out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
    return out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``(n, ...)``: block ``j`` of ``t`` (``n`` blocks along dim 0, ``n``
    the group's size) sent to group rank ``j``; block ``j`` of the result
    is the one group rank ``j`` sent this rank.  One all-to-all of one
    tensor."""
    _count("all_to_all_single", t, group)
    x = t.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order,
    through one all-gather into a tensor (contiguous, as a tensor of that
    shape held whole would be)."""
    _count("all_gather", t, group)
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _gather_single(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, of which this rank
    keeps its block along ``dim`` (the group's ranks' equal blocks, in
    group-rank order)."""
    _count("reduce_scatter", t, group)
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _scatter_single(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def shift(t: torch.Tensor, group, delta: int) -> torch.Tensor:
    """Send ``t`` to group rank ``rank + delta`` and return what arrives
    from ``rank - delta`` (zeros where no such rank exists): the pipeline's
    stage hand-off, point to point."""
    me, n = dist.get_rank(group), dist.get_world_size(group)
    t = t.contiguous()
    out = torch.zeros_like(t)
    dst, src = me + delta, me - delta
    r = _count("send", t, group)
    _count("recv", t, group)

    def p2p(send_buf, recv_buf):
        ops = []
        if 0 <= dst < n:
            ops.append(dist.P2POp(dist.isend, send_buf,
                                  dist.get_global_rank(group, dst), group))
        if 0 <= src < n:
            ops.append(dist.P2POp(dist.irecv, recv_buf,
                                  dist.get_global_rank(group, src), group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()

    if r == "host":
        through_host(p2p, [t], [out])
    else:
        p2p(t, out)
    return out


# ------------------------------------------------ collectives under autograd
class _SumForward(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the gradient as it is —
    every rank's downstream computes the same function of the sum, so each
    already holds the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """Forward: the tensor as it is.  Backward: the sum of the gradients
    over the group — each rank's graph holds only its part of what the
    tensor feeds."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _MeanForward(torch.autograd.Function):
    """Forward: the mean over the group.  Backward: the gradient as it is,
    so a rank's loss carries the gradient of its own term (data
    parallelism averages the gradients afterwards)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumForwardScaled(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the gradient times
    ``scale``: a sum over every rank whose result enters each data rank's
    loss, which data parallelism then averages (``scale``: the data ranks'
    count, so the average keeps the whole gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None


sum_forward = _SumForward.apply          # (x, group)
sum_backward = _SumBackward.apply        # (x, group)
mean_forward = _MeanForward.apply        # (x, group)
sum_forward_scaled = _SumForwardScaled.apply     # (x, group, scale)


class _GatherBlocks(torch.autograd.Function):
    """Forward: every rank's block concatenated along ``dim`` in group
    order (one all-gather).  Backward: the gradient reduce-scattered back
    to each rank's block: each rank's graph reads the whole for its own
    part of the work (its queries, its positions), so the parts sum."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g.contiguous(), ctx.group, ctx.dim), \
            None, None


class _GatherWhole(torch.autograd.Function):
    """Forward: as :class:`_GatherBlocks`.  Backward: this rank's block of
    the gradient: every rank computes the same function of the whole, so
    each holds all of it."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


gather_blocks = _GatherBlocks.apply       # (x, group, dim)
gather_whole = _GatherWhole.apply         # (x, group, dim)


class _GatherLast(torch.autograd.Function):
    """Forward: every rank's block concatenated along the last dim, in group
    order.  Backward: this rank's block of the gradient — every rank
    computes the same function of the whole, so each holds all of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.n = x.shape[-1]
        parts = all_gather(x, group)
        return torch.cat(list(parts.unbind(0)), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(-1, r * ctx.n, ctx.n).contiguous(), None


gather_last = _GatherLast.apply           # (x, group)


def row_sum(y: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel product's partial sums added over ``group`` in float32
    and cast back to ``y``'s dtype (as the reference's psum computes it);
    the gradient passes as it is (Megatron's *g*)."""
    return sum_forward(y.float(), group).to(y.dtype)


# ------------------------------------------------------ vocab parallelism
def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, lo: int,
                group) -> torch.Tensor:
    """The embedding rows of ``tokens`` from a vocab-sharded table: this
    rank holds rows ``[lo, lo + len(table))``; rows outside are zeros, and
    the sum over ``group`` has one non-zero term per token (exact in any
    dtype)."""
    n = table.shape[0]
    local = tokens.long() - lo
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    return sum_forward(rows, group)


def vocab_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        lo: int, group) -> torch.Tensor:
    """Per-position ``logsumexp - gold`` over vocab-sharded logits (this
    rank's columns ``[lo, lo + n)`` of the last dim), never gathering
    them: the max and the sum of exponentials are all-reduced in float32,
    and the gold logit comes from the rank that owns the target."""
    lf = logits.float()
    n = lf.shape[-1]
    m = all_reduce(lf.detach().amax(-1), group, op=dist.ReduceOp.MAX)
    s = sum_forward(torch.exp(lf - m[..., None]).sum(-1), group)
    lse = m + torch.log(s)
    t = targets.long() - lo
    inside = (t >= 0) & (t < n)
    gold = lf.gather(-1, t.clamp(0, n - 1)[..., None])[..., 0]
    gold = sum_forward(torch.where(inside, gold, gold.new_zeros(())), group)
    return lse - gold
