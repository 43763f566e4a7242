"""The collectives a capture records, each with the rule that prices it.

The JAX package exchanges halos with ``jax.lax.ppermute`` (a
``collective-permute`` in the compiled HLO) and sums HPCG's dot products
with ``psum`` (an ``all-reduce``).  With the ranks stacked on leading
tensor axes of one tensor, the port runs these as a copy along a rank axis
and a sum over the rank axis.  Both are the custom ops below, on every
run, so that each is one node of a captured graph
(``core.graph.capture``) that carries what the advisor prices: the kind,
and the number of stacked rank axes that turns the tensor's bytes into one
rank's bytes.

:data:`RULES` maps each recorded op (these two and the functional
collectives of ``torch.distributed._functional_collectives``) to its
``(kind, per-rank result bytes, group size)``, named as in the HLO.
``wait_tensor`` is not an op, as an HLO ``-done`` is not.

The port's parallel layer (``parallel.transport``) calls the in-place
``torch.distributed`` API, which dispatches as the ``c10d::*_`` ops; each
has its rule here too, with the bytes of the functional op it stands for
(an ``allreduce_`` records what ``all_reduce`` records), and its group
size from its process-group argument, so a step records the same
collectives whichever API it was written in.
"""
from __future__ import annotations

import functools
import math

import torch


@functools.lru_cache(maxsize=64)
def _index(sources: tuple, device: torch.device) -> torch.Tensor:
    """``sources`` on ``device``.  Cached, so a step copies no index from
    the host (a copy from pageable host memory would wait for the card to
    drain its queue)."""
    return torch.tensor(sources, device=device)


@torch.library.custom_op("repro_torch::ppermute", mutates_args=())
def ppermute(x: torch.Tensor, dim: int, sources: list[int],
             rank_axes: int) -> torch.Tensor:
    """``x``'s slices along rank axis ``dim``, destination ``j`` taking
    source ``sources[j]``; ``x``'s first ``rank_axes`` axes are ranks."""
    return x.index_select(dim, _index(tuple(sources), x.device))


@ppermute.register_fake
def _(x, dim, sources, rank_axes):
    return x.new_empty(x.shape)


@torch.library.custom_op("repro_torch::rank_sum", mutates_args=())
def rank_sum(part: torch.Tensor) -> torch.Tensor:
    """The all-reduce of stacked ranks: ``part``'s sum over its leading
    rank axis, added in rank order (the ``psum`` of the JAX package)."""
    out = functools.reduce(torch.add, part.unbind(0))
    return out.clone() if part.shape[0] == 1 else out   # no alias


@rank_sum.register_fake
def _(part):
    return part.new_empty(part.shape[1:])


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_of(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _pg_size(args) -> int:
    """The size of the process group among a ``c10d::*_`` op's arguments
    (a ``ProcessGroup`` script object)."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith(".ProcessGroup"):
            return dist.ProcessGroup.unbox(a).size()
    raise ValueError("no process group among the op's arguments")


def _tensors(x) -> list:
    """The tensors of a (nested) list argument."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for sub in x for t in _tensors(sub)]


def _ppermute_rule(args, out):
    # no replica groups on a collective-permute: the HLO's group size 1
    ranks = math.prod(out.shape[:args[3]])
    return "collective-permute", _nbytes(out) // max(ranks, 1), 1


#: ``{op name: rule(args, out) -> (kind, per-rank result bytes, group)}``
#: for every op a capture records as a collective.
RULES = {
    "repro_torch::ppermute": _ppermute_rule,
    "repro_torch::rank_sum":
        lambda args, out: ("all-reduce", _nbytes(out), args[0].shape[0]),
    "_c10d_functional::all_reduce":
        lambda args, out: ("all-reduce", _nbytes(out), _group_of(args[2])),
    "_c10d_functional::all_gather_into_tensor":
        lambda args, out: ("all-gather", _nbytes(out), int(args[1])),
    "_c10d_functional::reduce_scatter_tensor":
        lambda args, out: ("reduce-scatter", _nbytes(out), int(args[2])),
    "_c10d_functional::all_to_all_single":
        lambda args, out: ("all-to-all", _nbytes(out), _group_of(args[3])),
    # the in-place API of parallel.transport: (outputs, inputs, group, ...)
    "c10d::allreduce_":
        lambda args, out: ("all-reduce", sum(map(_nbytes, args[0])),
                           _pg_size(args)),
    "c10d::allgather_":
        lambda args, out: ("all-gather", sum(map(_nbytes,
                                                 _tensors(args[0]))),
                           _pg_size(args)),
    "c10d::_allgather_base_":
        lambda args, out: ("all-gather", _nbytes(args[0]), _pg_size(args)),
    "c10d::_reduce_scatter_base_":
        lambda args, out: ("reduce-scatter", _nbytes(args[0]),
                           _pg_size(args)),
    "c10d::reduce_scatter_":
        lambda args, out: ("reduce-scatter", sum(map(_nbytes, args[0])),
                           _pg_size(args)),
    "c10d::alltoall_base_":
        lambda args, out: ("all-to-all", _nbytes(args[0]), _pg_size(args)),
}
