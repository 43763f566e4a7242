"""FSDP execution: weights gathered whole over the data axes where they are
used, gradients reduce-scattered back to each rank's block.

The JAX package shards every parameter of a large cell over the data axes
as well (``parallel.fsdp_pspecs``) and lets XLA all-gather each scanned
layer's weights on use and reduce-scatter their gradients.  Here a model
built with FSDP (``models.factory.make_model(..., fsdp=True)``) holds of
each tensor only its block (``parallel.sharding.FsdpBlock``, set on the
parameter as ``p.fsdp``), and the layers read their parameters through
:func:`view`, which gathers each block on first use:

* forward: one all-gather of the block over the data axes' group
  (``transport.all_gather_dim``: an all-gather into one tensor);
* backward: the whole tensor's gradient, summed over the data ranks and
  scattered back to each rank's block (``transport.reduce_scatter_dim``),
  added in float32 and cast to the parameter's dtype.  The gradient that
  reaches an FSDP leaf is therefore already summed over the data ranks
  (``train.loop`` divides it by their count and does not all-reduce it).

Under ``"fsdp_seq"`` (``sharding.fsdp_seq_specs``) a block's group is every
rank's (the data axes and ``model``), and each ``model`` rank computes only
its positions' part of the gradient: the reduce-scatter over that group
sums those parts too.  A parameter without a block under ``"fsdp_seq"``
carries ``p.seq_group`` (the ``model`` group): its gradient is summed over
that group on the way back (``transport.sum_backward``).

Under gloo on the card both collectives are in ``transport.GLOO_CUDA``, so
they take the direct route.  Any other tensor passes as it is.
"""
from __future__ import annotations

import torch

from . import transport


class _Gather(torch.autograd.Function):
    """Forward: the block gathered whole over its data axes.  Backward: the
    gradient reduce-scattered to the block (float32 sum)."""

    @staticmethod
    def forward(ctx, w, blk):
        ctx.blk = blk
        return blk.gather(w)

    @staticmethod
    def backward(ctx, g):
        blk = ctx.blk
        part = transport.reduce_scatter_dim(g.float(), blk.group, blk.dim)
        return part.to(g.dtype), None


def gather(p: torch.Tensor) -> torch.Tensor:
    """``p`` whole over the data axes where it holds an FSDP block
    (``p.fsdp``), else ``p`` itself (its gradient summed over
    ``p.seq_group`` where it has one)."""
    blk = getattr(p, "fsdp", None)
    if blk is None:
        group = getattr(p, "seq_group", None)
        if group is not None and torch.is_grad_enabled():
            return transport.sum_backward(p, group)
        return p
    if torch.is_grad_enabled():
        return _Gather.apply(p, blk)
    # no graph is built; the whole tensor requires grad as the parameter
    # does, since an op may pick its path by it (matmul folds a batch into
    # one product only when the weight does not), so the values match the
    # whole tensor's bit for bit
    return blk.gather(p).requires_grad_(p.requires_grad)


class View:
    """A ``models.layers.Params`` module read with every FSDP block
    gathered: ``v["wq"]`` is the whole (over the data axes) ``wq``,
    gathered on first access and kept for the view's lifetime; ``v["attn"]``
    is a view of the sub-module.  ``spec`` is the module's (a layer's kind)."""

    def __init__(self, module):
        self._m = module
        self._got = {}
        self.spec = getattr(module, "spec", None)

    def __getitem__(self, name: str):
        if name not in self._got:
            x = self._m[name]
            self._got[name] = gather(x) if isinstance(x, torch.Tensor) \
                else View(x)
        return self._got[name]

    def __contains__(self, name: str) -> bool:
        return name in self._m


def view(module) -> View:
    """:class:`View` of ``module`` (a ``Params`` module)."""
    return View(module)


__all__ = ["View", "gather", "view"]
