"""Pipeline parallelism (GPipe schedule) over a process group, and the
int8 compressed all-reduce: the JAX package's ``parallel/pipeline.py``.

The layer stack is split into ``P = group size`` contiguous stages; each
rank holds only its stage's blocks.  The forward runs the GPipe wavefront:
``M + P - 1`` ticks, each one stage-step on the resident microbatch
followed by a hand-off of the activations to the next stage.

The hand-off is an autograd function whose backward is the reverse
hand-off, and the final broadcast of the last stage's outputs is a sum
whose backward passes the gradient through: ``loss.backward()`` through
:func:`pipeline_apply` is pipelined backprop, as ``jax.grad`` is in the
reference.  Every rank builds the same graph (stage 0 ignores what it
receives, the other stages what they are fed, by arithmetic masks rather
than branches), so the backward runs the same collectives in the same
order on every rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import transport


class _HandOff(torch.autograd.Function):
    """Forward: receive from rank - 1, send to rank + 1.  Backward: the
    reverse."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return transport.shift(y, group, +1)

    @staticmethod
    def backward(ctx, g):
        return transport.shift(g, ctx.group, -1), None


def pipeline_apply(stage_params, x_micro, block_fn, group):
    """Run microbatches through the pipeline.

    stage_params: this rank's blocks (whatever ``block_fn`` takes).
    x_micro: (M, B_micro, ...) microbatch activations, the same on every
        rank (stage 0 reads them).
    block_fn(stage_params, x) -> x: applies this rank's blocks.
    Returns (M, B_micro, ...): the last stage's outputs, on every rank.
    """
    P = dist.get_world_size(group)
    stage = dist.get_rank(group)
    M = x_micro.shape[0]
    first = float(stage == 0)
    last = float(stage == P - 1)
    state = torch.zeros_like(x_micro[0])
    outputs = []
    for t in range(M + P - 1):
        feed = x_micro[t] if t < M else torch.zeros_like(state)
        x_in = feed * first + state * (1.0 - first)
        y = block_fn(stage_params, x_in)
        if t >= P - 1:                     # the last stage emits t - (P - 1)
            outputs.append(y * last)
        if t < M + P - 2:                  # the final hand-off feeds nothing
            state = _HandOff.apply(y, group)
    return transport.sum_forward(torch.stack(outputs), group)


def stage_block_counts(n_blocks: int, n_stages: int) -> list:
    """Contiguous block split; requires divisibility (pad upstream)."""
    if n_blocks % n_stages:
        raise ValueError(f"{n_blocks} blocks not divisible into "
                         f"{n_stages} stages")
    return [n_blocks // n_stages] * n_stages


# --------------------------------------------------- compressed reduction
def compressed_psum(x, group, residual=None):
    """int8 error-feedback all-reduce over ``group`` (gradient
    compression).

    Each rank contributes an int8 payload and one float32 scale through an
    all-gather, then reduces locally in float32.  The quantization error
    is returned as ``residual`` and must be fed back on the next call
    (error feedback keeps the long-run sum unbiased; the same scheme as
    ``train.optimizer.compress_error_feedback``).

    Returns (reduced, new_residual).
    """
    if residual is None:
        residual = torch.zeros_like(x, dtype=torch.float32)
    target = x.float() + residual
    amax = torch.clamp(target.abs().max(), min=1e-12)
    # a true division: CUDA multiplies by the reciprocal of a Python scalar
    scale = amax / torch.full((), 127.0, device=amax.device)
    q = torch.round(target / scale).to(torch.int8)
    # target - q * scale rounded once, as the fused multiply-add XLA emits
    # (the product of an int8 and a float32 is exact in float64)
    new_residual = (target.double() - q.double() * scale.double()).float()
    qg = transport.all_gather(q, group)                # int8 on the wire
    sg = transport.all_gather(scale, group)            # one f32 per rank
    reduced = torch.tensordot(sg, qg.float(), dims=([0], [0]))
    return reduced.to(x.dtype), new_residual
