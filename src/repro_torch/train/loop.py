"""The train step: microbatched gradient accumulation + AdamW or Adafactor,
the JAX package's ``train/loop.py``.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` over the reference's leaves (``models.convert.
reference_leaves``), updated in place.  Gradients are taken with
``torch.autograd.grad`` (no ``.grad`` buffers): with several microbatches
each one's gradients are added into buffers of ``accum_dtype`` (float32),
one per leaf, as the reference's scan adds them; ``.grad`` would add in the
parameters' dtype.

Data parallelism (``mesh=``): each rank takes its rows of the global batch
(``parallel.batch_pspecs``: contiguous blocks over the data axes, in mesh
order), splits them into its microbatches as above, and the gradients and
the loss are summed in float32 over the data ranks and divided by their
count — the global batch's mean.

Tensor parallelism (a mesh whose ``model`` axis is R > 1, the model built
on it): the ranks of one ``model`` group take the same rows, and each
leaf's gradient is this rank's block's, complete — never summed over
``model``.  A leaf that is whole on every model rank (norms, the router,
``mm_proj``) gets the same gradient on each: every column-parallel
product's input passes Megatron's *f* (its gradient summed over the
group) and every row-parallel output *g*, so the gradient reaching any
whole tensor is already the whole model's, on every rank.  A block two
ranks share (a kv head) has its gradient summed over them in the
backward pass (``sharding.shared_grad``).  The global norm counts every
entry once (``optimizer.global_norm``).

FSDP (the model built with ``fsdp=True``): a leaf with an FSDP block
(``Leaf.fsdp``) gets its gradient reduce-scattered over the data ranks in
the backward pass (``parallel.fsdp``), already summed: it skips the
all-reduce of :func:`reduce_over_data` and is only divided by the data
count.  Its AdamW moments are its block; Adafactor's statistics are the
whole leaf's (``optimizer.adafactor_update``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from ..core import graph
from ..parallel import sharding, transport
from .optimizer import (AdamWConfig, adafactor_update, adamw_update,
                        zero1_blocks)


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor
    lr: torch.Tensor


def _split_microbatches(batch: dict, n_micro: int) -> list:
    """The ``n_micro`` microbatches of a ``(B, ...)`` batch, strided as the
    reference splits it: microbatch ``j`` holds rows ``j, j + n_micro,
    ...`` (the reference reshapes to ``(B / n_micro, n_micro)`` to keep its
    data-parallel sharding).  MoE capacity is per microbatch, so the split
    decides what routes and what drops."""
    for k, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch[{k!r}] has {x.shape[0]} rows, not a "
                             f"multiple of n_micro={n_micro}")
    return [{k: x[j::n_micro] for k, x in batch.items()}
            for j in range(n_micro)]


def loss_and_grads(loss_fn: Callable, params, batch: dict, n_micro: int = 1,
                   accum_dtype=torch.float32) -> tuple:
    """``(loss, grads)``: the mean loss over the microbatches (float32) and
    one gradient per leaf of ``params``.  With ``n_micro > 1`` the
    gradients are summed in ``accum_dtype`` and divided by ``n_micro``;
    with one microbatch they keep the parameters' dtype, as in the
    reference."""
    tensors = [t for leaf in params for t in leaf.tensors]

    def grads_of(mb):
        loss = loss_fn(mb)
        flat = torch.autograd.grad(loss, tensors, allow_unused=True,
                                   materialize_grads=True)
        it = iter(flat)
        return loss.detach(), [[next(it) for _ in leaf.tensors]
                               for leaf in params]

    if n_micro == 1:
        loss, parts = grads_of(batch)
        return loss, [leaf.stack(p) for leaf, p in zip(params, parts)]
    acc = [torch.zeros(leaf.shape, dtype=accum_dtype, device=leaf.device)
           for leaf in params]
    loss_acc = torch.zeros((), dtype=torch.float32, device=acc[0].device)
    mbs = _split_microbatches(batch, n_micro)
    with graph.folded(n_micro) as run:        # one, in a folding capture
        for mb in mbs[:run]:
            loss, parts = grads_of(mb)
            _accumulate(params, acc, parts)
            loss_acc += loss
            del loss, parts           # nothing outlives its microbatch
    return loss_acc / n_micro, [a.div_(n_micro) for a in acc]


def _accumulate(params, acc, parts) -> None:
    """Add one microbatch's gradients (``parts``: per leaf, one per port
    tensor) into the buffers ``acc``."""
    for leaf, a, p in zip(params, acc, parts):
        for dst, g in zip(leaf.parts(a), p):
            dst.add_(g)


def data_group(mesh):
    """The process group over ``mesh``'s data axes and its size."""
    group = sharding.axes_group(mesh, sharding.data_axes(mesh))
    return group, dist.get_world_size(group)


def local_batch(batch: dict, mesh) -> dict:
    """This rank's rows of the global ``batch`` (``batch_pspecs``)."""
    specs = sharding.batch_pspecs(batch, mesh)
    return {k: sharding.local_shard(x, specs[k], mesh)
            for k, x in batch.items()}


def reduce_over_data(loss, grads, group, n: int, summed=None) -> tuple:
    """The loss and gradients summed in float32 over the data ranks (the
    data group only, never ``model``) and divided by their count.
    ``summed[i]``: gradient ``i`` is already the sum over the data ranks
    (an FSDP leaf's, reduce-scattered), so it is only divided."""
    loss = transport.all_reduce(loss.float().clone(), group) / n
    out = []
    for i, g in enumerate(grads):
        g = g.float() if g.dtype != torch.float32 else g
        if not (summed and summed[i]):
            g = transport.all_reduce(g, group)
        out.append(g.div_(n))
    return loss, out


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    n_micro: int = 1, accum_dtype=torch.float32,
                    optimizer: str = "adamw", mesh=None,
                    zero1: bool = False) -> Callable:
    """``loss_fn(microbatch) -> scalar``, a function of the tensors of the
    leaves the step is given; returns the train step.

    ``accum_dtype``: the gradient-accumulation buffers' dtype (bfloat16
    halves them for the 400B-class archs at a documented precision cost).
    ``optimizer``: ``"adamw"`` or ``"adafactor"`` (the state must come from
    the matching ``*_init``).  ``mesh``: data parallelism over its data
    axes, and tensor parallelism over its ``model`` axis when the leaves
    are a model built on it; the step then takes the GLOBAL batch.
    ``zero1``: AdamW's moments are this rank's blocks
    (``adamw_init(..., blocks=zero1_blocks(params, mesh))``); Adafactor's
    state stays whole on every rank (the reference's replicated state),
    its statistics summed over the ranks that split each leaf."""
    opt_update = {"adamw": adamw_update,
                  "adafactor": adafactor_update}[optimizer]
    if mesh is not None:
        group, n_data = data_group(mesh)
    use_blocks = mesh is not None and zero1 and optimizer == "adamw"
    blocks = None

    def train_step(params, opt_state, batch):
        nonlocal blocks
        if mesh is not None:
            batch = local_batch(batch, mesh)
        loss, grads = loss_and_grads(loss_fn, params, batch, n_micro,
                                     accum_dtype)
        kw = {}
        if mesh is not None:
            loss, grads = reduce_over_data(
                loss, grads, group, n_data,
                [leaf.fsdp is not None for leaf in params])
            kw["mesh"] = mesh
        if use_blocks:
            if blocks is None:
                blocks = zero1_blocks(params, mesh)
            kw["blocks"] = blocks
        params, opt_state, om = opt_update(opt_cfg, grads, opt_state, params,
                                           **kw)
        return params, opt_state, TrainMetrics(loss=loss,
                                               grad_norm=om["grad_norm"],
                                               lr=om["lr"])

    return train_step
