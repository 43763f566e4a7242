"""Capture of a PyTorch step: the port's counterpart of
``jax.jit(f).lower(...).compile()``.

``capture(fn, *args)`` runs ``fn`` once under fake tensors: real tensors
among the arguments (or held by ``fn``, such as a model's parameters)
become fake ones of the same shape, dtype and device, so the capture
executes nothing and allocates no activations, as lowering and compiling
run nothing in the JAX package.  That one pass records what the advisor
needs; the step's FX graph (``make_fx`` under the same fake tensors,
:attr:`CapturedStep.graph_module`) is traced when first asked for, since
tracing a graph costs several times the pass (about 1 ms a node against
0.2).  What the pass records:

* the collectives, as the HLO's ``CollectiveOp`` records
  (:meth:`CapturedStep.collectives`): the functional collectives of
  ``torch.distributed._functional_collectives`` (``all_reduce`` ->
  ``all-reduce``, ``all_gather_into_tensor`` -> ``all-gather``,
  ``reduce_scatter_tensor`` -> ``reduce-scatter``, ``all_to_all_single``
  -> ``all-to-all``; ``wait_tensor`` is not an op, as an HLO ``-done`` is
  not), with the group size of their process group; and the
  stacked-rank apps' two custom ops: ``ppermute`` ->
  ``collective-permute`` and HPCG's cross-rank sum -> ``all-reduce`` of
  the n ranks.  ``comm.collectives.RULES`` gives each op's kind, bytes
  and group.  ``result_bytes`` is one rank's: a stacked op's tensor holds
  every rank, so its bytes are divided by the product of its rank axes,
  which gives the per-device shapes of the JAX package's HLO.  A
  ``collective-permute`` carries no replica groups in the HLO, so the
  JAX package gives it ``group_size`` 1; the port's does too.
* call sites.  The pass (and FX) unrolls Python loops, where ``lax.scan``
  keeps one HLO op with a trip count, so the collectives are grouped into call sites by
  (kind, per-rank bytes, group size, the whole stack of user frames), and
  a site's ``multiplier`` is its number of occurrences: one line of code,
  called ``count`` times, as the paper defines a call site.
* the cost (:meth:`CapturedStep.cost`): ``"flops"`` from
  ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions,
  attention, the flash-attention kernel; also kept by operand dtype for
  :meth:`CapturedStep.roofline`), and ``"bytes accessed"``, the
  port's own unfused count: every op that is not a view reads each of
  its tensor operands and writes its result once (``graph_bytes`` reads
  the same count off the graph).  It counts no fusion, so it is not the
  JAX package's CPU-HLO byte count and is not held to it.

* folded loops (``capture(..., fold=True)``): a loop of identical
  iterations written ``with folded(n) as k: for ... in items[:k]`` runs
  once, and everything recorded in it counts ``n`` times (ops, flops,
  bytes, collectives); what the other iterations would have kept (a list
  of per-iteration outputs) the loop makes as stand-ins before the one
  that runs (:func:`stand_ins`, recorded for memory only), so the peak is
  the unrolled loop's; outside such a capture ``k`` is ``n``.  The train
  step's microbatches are such a loop (their backward passes run inside
  it), and so are, with grad disabled, the time steps of the plain SSM
  scan and the tiles of the blockwise attention; under grad those run
  unrolled, since their backward pass runs after the loop.  The graph
  (:attr:`CapturedStep.graph_module`) then holds one iteration.
* memory (:attr:`CapturedStep.peak_bytes`): the peak, over the pass, of
  the bytes of the fake storages the step made and still held (each
  storage from the op that first returned it until it was freed: an
  activation autograd saved lives until the backward pass frees it), and
  :attr:`CapturedStep.new_output_bytes`, the part of the step's outputs
  it made (not an argument updated in place).  The arguments and what
  ``fn`` holds are not counted: a storage first seen as an op's input was
  there before the step.  It counts no allocator, no fusion and no
  workspace.

A captured step runs nothing, so the kernels' launch counters stay where
they were: each kernel wrapper is a custom op whose fake version gives its
shapes only, and a captured step holds it as one node.  The parallel
layer's counters (``parallel.transport.routes`` and ``volume``) stay too:
a collective on fake tensors counts nothing.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import os
import sysconfig
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from ..comm import collectives
from .hlo import CollectiveOp, RooflineTerms
from .params import H100, TpuSpec

_SKIP_DIRS = (os.path.dirname(torch.__file__) + os.sep,
              sysconfig.get_paths()["stdlib"] + os.sep)
_COMM_DIR = os.path.dirname(collectives.__file__) + os.sep


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _user_stack() -> tuple:
    """The user frames of the current call, outermost first, from the
    captured function down: ``(file, line, function)`` each, without the
    frames of torch, the standard library and this module."""
    frames = traceback.extract_stack()
    start = 0
    for i, f in enumerate(frames):
        if f.filename == __file__ and f.name == "_traced":
            start = i + 1
    return tuple((f.filename, f.lineno, f.name) for f in frames[start:]
                 if f.filename != __file__
                 and not f.filename.startswith(_SKIP_DIRS))


def _where(stack) -> str:
    """``function:line`` of a site's innermost frame outside the port's
    communication layer (the app's line that communicates)."""
    frames = [f for f in stack if not f[0].startswith(_COMM_DIR)] or stack
    return f"{frames[-1][2]}:{frames[-1][1]}" if frames else ""


class _Recorder(TorchDispatchMode):
    """One pass over the step's ops: counts every op, sums the flops of
    each op that ``FlopCounterMode`` has a formula for (its registry,
    without its module bookkeeping) by the dtype of its first tensor
    operand, and the bytes of each non-view op, and notes every collective
    (``comm.collectives.RULES``) with its stack of user frames."""

    def __init__(self):
        super().__init__()
        self.calls = []
        self.ops = collections.Counter()
        self.flops = collections.Counter()
        self.bytes = 0
        self.live = self.peak = 0
        self.weight = 1                       # folded() multiplies it
        self.recorded = 0                     # collectives, unweighted
        self._new: dict = {}                  # id -> weakref, made here
        self._old = WeakIdKeyDictionary()     # storages from before
        self._formulas = FlopCounterMode(display=False).flop_registry

    def is_new(self, t: torch.Tensor) -> bool:
        """Whether ``t``'s storage was made during the pass."""
        st = t.untyped_storage()
        ref = self._new.get(id(st))
        return ref is not None and ref() is st

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if self.is_new(t) or st in self._old:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        key = id(st)

        def freed(_, key=key, n=n):
            self.live -= n
            self._new.pop(key, None)
        self._new[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in pytree.tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and not self.is_new(t):
                self._old[t.untyped_storage()] = True
        out = func(*args, **kwargs)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        if func.namespace == "prim":          # metadata (prim::device)
            return out
        name = func.name()
        if name == "aten::lift_fresh":        # a tensor made from data;
            name = "aten::lift_fresh_copy"    # the graph records a copy
        w = self.weight
        if not w:                             # stand-ins: memory only
            return out
        self.ops[name] += w
        if name == "aten::lift_fresh_copy" or not _is_view(func):
            self.bytes += w * sum(_nbytes(t) for t in
                                  pytree.tree_leaves((args, kwargs, out)))
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            first = next(t for t in pytree.tree_leaves(args)
                         if isinstance(t, torch.Tensor))
            self.flops[str(first.dtype).removeprefix("torch.")] += \
                w * formula(*args, **kwargs, out_val=out)
        rule = collectives.RULES.get(name)
        if rule is not None:
            self.calls.extend([(*rule(args, out), _user_stack())] * w)
            self.recorded += 1
        return out


def _is_view(target) -> bool:
    """Whether a graph target moves no bytes: a view (aliasing) op,
    ``wait_tensor``, or Python glue such as ``getitem``."""
    if not isinstance(target, torch._ops.OpOverload):
        return True
    if target.name() == "_c10d_functional::wait_tensor":
        return True
    return target.is_view


def graph_bytes(gm: torch.fx.GraphModule) -> int:
    """Bytes every non-view node reads (each tensor operand once) and
    writes (its result once), summed over the graph: the count
    :meth:`CapturedStep.cost` takes in its pass, read off the graph."""
    total = 0
    for node in gm.graph.nodes:
        if node.op != "call_function" or _is_view(node.target):
            continue
        operands = [a for a in pytree.tree_leaves((node.args, node.kwargs))
                    if isinstance(a, torch.fx.Node)]
        total += sum(_nbytes(a.meta.get("val")) for a in operands)
        total += sum(_nbytes(v) for v in
                     pytree.tree_leaves(node.meta.get("val")))
    return total


_MODE: list = []
_FOLD: list = []          # the capture in progress folds loops (its pass
_RECORDER: list = []      # records into the recorder here)


@contextlib.contextmanager
def folded(n: int, backward_inside: bool = True):
    """A loop of ``n`` identical iterations: yields how many to run, ``n``,
    or 1 inside a capture made with ``fold=True``, whose pass then counts
    what the one iteration records ``n`` times (what the other iterations
    would have kept, the loop makes with :func:`stand_ins`).
    ``backward_inside=False``: the iterations' backward pass would run
    after the loop (outside the weighting), so the loop folds only where
    no graph is recorded (grad disabled)."""
    if not _FOLD or n <= 1 or (not backward_inside
                                and torch.is_grad_enabled()):
        yield n
        return
    rec = _RECORDER[-1] if _RECORDER else None
    if rec is None:                     # tracing the graph: one iteration
        yield 1
        return
    rec.weight *= n
    try:
        yield 1
    finally:
        rec.weight //= n


def stand_ins(k: int, shape, like: torch.Tensor) -> list:
    """``k`` tensors of ``shape`` (``like``'s dtype and device) standing
    for what the ``k`` iterations of a folded loop that do not run would
    have kept (a loop's list of per-iteration outputs): one storage of
    all of them, made before the iteration that runs, and recorded for
    its memory only, so the pass's peak is the unrolled loop's."""
    if k <= 0:
        return []
    rec = _RECORDER[-1] if _RECORDER else None
    weight = rec.weight if rec is not None else None
    if rec is not None:
        rec.weight = 0
    try:
        return list(like.new_empty((k, *shape)).unbind(0))
    finally:
        if rec is not None:
            rec.weight = weight


def _fake_mode() -> FakeTensorMode:
    """The one fake mode of every capture (a graph's fake inputs must share
    one); it takes real tensors too, as fake copies that allocate
    nothing."""
    if not _MODE:
        _MODE.append(FakeTensorMode(allow_non_fake_inputs=True))
    return _MODE[0]


def abstract(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` run under the captures' fake mode: its
    tensors come out fake, with shapes, dtypes and devices but no memory
    (the JAX package's ``jax.eval_shape``).  For a step's inputs that do
    not exist yet, such as a batch or a fresh cache."""
    with _fake_mode():
        return fn(*args, **kwargs)


@dataclasses.dataclass
class StepRoofline(RooflineTerms):
    """A captured step's roofline terms: the compute term takes each
    dtype's flops at ``spec.peak_flops(dtype)`` (an f32 matmul at the
    card's f32 rate), where the HLO's terms take every flop at the bf16
    peak."""

    flops_by_dtype: dict = dataclasses.field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return sum(f / self.spec.peak_flops(d)
                   for d, f in self.flops_by_dtype.items())


class CapturedStep:
    """One captured step: its collectives as call sites, its cost and its
    FX graph.  ``price`` and the advisor take it as they take a compiled
    HLO program.

    ``capture`` runs the step once over fake tensors (one pass, which
    costs a fraction of tracing a graph); :attr:`graph_module`, the
    ``make_fx`` graph of the same ops, is traced when first asked for.
    Until then the step holds ``fn`` and so whatever ``fn`` holds (a
    model's weights, an engine's caches on the card); tracing the graph
    lets go of them."""

    def __init__(self, name: str, fn, leaves, spec, slots, inputs,
                 fold: bool = False):
        self.name = name
        self._fn, self._leaves, self._spec = fn, leaves, spec
        self._slots, self._inputs = slots, inputs
        self._grad = torch.is_grad_enabled()
        self._fold = fold
        rec = _Recorder()
        with _folding(fold, rec), _fake_mode(), rec:
            out = self._traced(*inputs)
        self._recorded = rec.recorded
        #: peak bytes of the storages the step made and held (see above)
        self.peak_bytes = rec.peak
        #: bytes of the step's output tensors that the step made
        self.new_output_bytes = sum(
            _nbytes(t) for t in pytree.tree_leaves(out)
            if isinstance(t, torch.Tensor) and rec.is_new(t))
        del out
        #: (kind, per-rank bytes, group, stack) of every collective call
        self.calls = rec.calls
        #: how often each op (``namespace::name``) ran in the step
        self.ops = rec.ops
        #: the flops by operand dtype (``"bfloat16"``, ``"float32"``, ...)
        self.flops_by_dtype = dict(rec.flops)
        self.flops = float(sum(rec.flops.values()))
        self.bytes = float(rec.bytes)

    def _traced(self, *tensors):
        filled = list(self._leaves)
        for i, t in zip(self._slots, tensors):
            filled[i] = t
        a, kw = pytree.tree_unflatten(filled, self._spec)
        return self._fn(*a, **kw)

    @functools.cached_property
    def graph_module(self) -> torch.fx.GraphModule:
        """The step's FX graph (``make_fx`` under the same fake tensors,
        and the grad mode of the capture); the step lets go of ``fn`` and
        its inputs once it is traced."""
        with torch.set_grad_enabled(self._grad), _folding(self._fold):
            gm = make_fx(self._traced, tracing_mode="fake",
                         _allow_non_fake_inputs=True)(*self._inputs)
        self._fn = self._leaves = self._spec = self._inputs = None
        in_graph = sum(1 for n in gm.graph.nodes if n.op == "call_function"
                       and isinstance(n.target, torch._ops.OpOverload)
                       and n.target.name() in collectives.RULES)
        if in_graph != self._recorded:
            raise RuntimeError(f"{self.name}: {self._recorded} collectives "
                               f"in the pass, {in_graph} in the graph")
        return gm

    def sites(self) -> list:
        """``[(CollectiveOp, stack), ...]``: the call sites in order of
        first occurrence, each with its stack of user frames."""
        order, count = {}, {}
        for kind, nbytes, group, stack in self.calls:
            key = (kind, nbytes, group, stack)
            order.setdefault(key, len(order))
            count[key] = count.get(key, 0) + 1
        out = []
        for key in sorted(order, key=order.get):
            kind, nbytes, group, stack = key
            out.append((CollectiveOp(kind=kind, result_bytes=nbytes,
                                     group_size=group,
                                     computation=self.name,
                                     multiplier=float(count[key]),
                                     name=_where(stack)), stack))
        return out

    def collectives(self) -> list:
        """The call sites as ``CollectiveOp`` records (``multiplier`` = the
        site's occurrences)."""
        return [op for op, _ in self.sites()]

    def cost(self) -> dict:
        """``{"flops", "bytes accessed"}`` of one run of the step (see the
        module docstring for what the bytes count)."""
        return {"flops": self.flops, "bytes accessed": self.bytes}

    def roofline(self, spec: TpuSpec = H100) -> StepRoofline:
        """The step's roofline terms on one chip of ``spec`` (the H100 by
        default: the card the step was captured for), each dtype's flops
        at that dtype's peak."""
        wire = sum(op.total_wire_bytes for op in self.collectives())
        return StepRoofline(flops=self.flops, hbm_bytes=self.bytes,
                            wire_bytes=wire, spec=spec,
                            flops_by_dtype=self.flops_by_dtype)

    def as_text(self) -> str:
        """The graph's code, for people to read."""
        return self.graph_module.code


def _fake(t: torch.Tensor) -> FakeTensor:
    """``t`` as a fake of the captures' mode.  A real one-element host
    tensor (an optimizer's step count) keeps its value, so the host
    arithmetic it feeds (a learning-rate schedule) runs as it would."""
    mode = _fake_mode()
    if isinstance(t, FakeTensor):
        return t
    if t.device.type == "cpu" and t.numel() == 1:
        return mode.fake_tensor_converter.from_real_tensor(
            mode, t, make_constant=True)
    return mode.from_tensor(t)


@contextlib.contextmanager
def _folding(fold: bool, rec=None):
    """Loops written with :func:`folded` fold (``fold``), into ``rec``."""
    if not fold:
        yield
        return
    _FOLD.append(True)
    if rec is not None:
        _RECORDER.append(rec)
    try:
        yield
    finally:
        _FOLD.pop()
        if rec is not None:
            _RECORDER.pop()


def capture(fn, *args, name: str | None = None, fold: bool = False,
            **kwargs) -> CapturedStep:
    """Record ``fn(*args, **kwargs)`` as a :class:`CapturedStep` without
    running it.  Tensors among the arguments (at any depth of lists,
    tuples, dicts and named tuples) become the step's inputs; everything
    else is taken as it is.  Real tensors become fake ones (as do those
    ``fn`` holds, such as a model's parameters), so nothing is executed or
    allocated, and ``fn``'s in-place writes reach only the fakes (a real
    one-element host tensor becomes a fake that keeps its value).  The
    step keeps the fakes of the arguments' tensors, not the tensors.
    ``fold``: loops written with :func:`folded` run once and count their
    iterations (the module docstring)."""
    leaves, spec = pytree.tree_flatten((args, kwargs))
    slots = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    inputs = [_fake(leaves[i]) for i in slots]
    for i in slots:
        leaves[i] = None
    return CapturedStep(name or getattr(fn, "__name__", "step"), fn, leaves,
                        spec, slots, inputs, fold)


__all__ = ["CapturedStep", "abstract", "capture", "folded", "graph_bytes",
           "stand_ins"]
