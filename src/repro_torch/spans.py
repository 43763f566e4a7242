"""Named spans of the program's work, on the profiler's clock.

``span(name)`` marks where a piece of work starts and ends on the host.
It is off unless :func:`recording` is on: then it is
``torch.profiler.record_function(name)``, so that the spans and the card's
operations land in one profiler trace on one clock (the parents come from
the nesting, the kernels a span launched from the profiler's correlation
ids).  Off, it is one shared context that does nothing, so a step costs
the same as without spans, and a profiler window taken for another reason
holds none of them.  No environment variable turns recording on.

The spans, each at the boundary where its work happens:

* ``hpcg.solve``: one PCG solve (``apps.hpcg.torch_impl.make_cg``);
* ``hpcg.apply_a``: the operator with its exchange, pad and cat;
* ``hpcg.exchange``: the ghost-plane exchange with its Dirichlet ends;
* ``hpcg.v_cycle.L<level>``: the V-cycle from ``level`` down;
* ``hpcg.pdot``: a global dot product;
* ``heat.step``: one heat step (``apps.stencil.torch_impl.make_step``);
* ``heat.exchange``: the step's halo exchange;
* ``heat.update``: the step's Jacobi update;
* ``lm.decode_step``: one decode step of a language model
  (``models.lm.LanguageModel.decode_step``);
* ``lm.attn``: an attention mixer, with its norm (``models.blocks``);
* ``lm.mamba2``: a Mamba-2 mixer, with its norm (``models.blocks``);
* ``lm.mamba2.state``: a Mamba-2 decode's state update and readout
  (``models.mamba2.mamba2_decode``);
* ``lm.moe``: an MoE FFN with its norm: the router, the routed experts and
  a shared expert (``models.blocks``).

The MoE layers count their assignments and dropped assignments
(``models.moe.assignments`` / ``dropped``).
"""
from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()
_recording = False


def span(name: str):
    """A context around one piece of work named ``name``: the profiler's
    ``record_function`` while :func:`recording` is on, else a no-op."""
    if not _recording:
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def is_recording() -> bool:
    return _recording


@contextlib.contextmanager
def recording():
    """Turn the spans on inside the block (off again after it)."""
    global _recording
    before, _recording = _recording, True
    try:
        yield
    finally:
        _recording = before
