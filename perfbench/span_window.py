"""One more traced window, with the program's spans on: the card's
operations given to the program's layers, and the exchanges the program
counted.

The harness's traced window runs with the spans off (``repro_torch.spans``
records nothing unless turned on), so its metrics read the program as the
untraced window runs it.  The readers of the program's spans share the
one window this module runs, after the harness's, and cache it on the
run's ``Context``:

- ``app.trace_units`` units through ``app.unit()``, inside
  ``repro_torch.spans.recording()``, under :func:`tracing.traced_window`;
  the run's correctness check covers what they make;
- the exchange counters (``repro_torch.comm.counters``) around the units;
- the spans' annotations on the card's timeline kept apart from its
  kernels and copies, and the kernels and copies alone checked against the
  host's enqueues (a trace that lost some is taken again, up to
  :data:`tracing.TRIES` times);
- each kernel or copy given to the innermost span open on the host when its
  launch ran (the profiler's correlation id joins the two);
- on standard error, each span name's calls, host ms, device ms, device
  self ms (its own, without its children's) and launches a step, the
  kernels launched in each span's own time, and the ten longest idle gaps,
  each named by the innermost span open at its start;
- the trace, beside the harness's, as ``<cell>.spans.json.gz``.

A program without spans or counters has nothing to read: :func:`window`
gives ``None`` and runs nothing.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

from perfbench import counts, harness, tracing

#: The spans of the exchange, in either app.
EXCHANGE = ("hpcg.exchange", "heat.exchange")
APPLY_A = "hpcg.apply_a"
#: Kernels listed under each span name in the log.
TOP_KERNELS = 8


@dataclass
class SpanStats:
    """One span name over the window: its calls, host seconds, the device
    seconds and launches of the kernels and copies launched inside it
    (``device_s``, ``launches``) and inside it but outside its children
    (``self_s``, ``self_launches``)."""

    calls: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    self_s: float = 0.0
    launches: int = 0
    self_launches: int = 0
    #: ``{kernel name: launches}`` in the span's own time.
    kernels: dict = field(default_factory=dict)


@dataclass
class SpanWindow:
    steps: int
    window_s: float
    spans: dict
    #: ``comm.counters.since()`` over the window's units.
    counted: dict
    #: Kernels and copies, host enqueues, and kernels no launch was found
    #: for (whose time no span holds).
    device_ops: int
    enqueued: int
    unattributed: int
    idle_gaps: list
    on_card: bool

    def stats(self, name: str) -> SpanStats:
        return self.spans.get(name, SpanStats())

    @property
    def attributed(self) -> bool:
        """Every kernel and copy was given to its launch."""
        return self.on_card and self.device_ops > 0 \
            and self.unattributed == 0


_MISSING = object()


def window(ctx) -> SpanWindow | None:
    """The run's spans window (run on the first call, cached on ``ctx``);
    ``None`` in an untraced run or where the program has no spans."""
    got = getattr(ctx, "spans_window", _MISSING)
    if got is _MISSING:
        got = ctx.spans_window = _run(ctx)
    return got


def _cell() -> str:
    """The cell of the run: ``harness.run_cell``'s ``cell``."""
    f = sys._getframe()
    while f is not None:
        if f.f_code is harness.run_cell.__code__:
            return f.f_locals["cell"]
        f = f.f_back
    return "cell"


def _run(ctx) -> SpanWindow | None:
    if ctx.trace is None:
        return None
    try:
        from repro_torch import spans
        from repro_torch.comm import counters
    except ImportError:
        return None
    app, torch, on_card = ctx.app, ctx.torch, ctx.on_card
    t0 = time.perf_counter()
    counted = {}

    def run():
        before = counters.snapshot()
        steps = sum(app.unit() for _ in range(app.trace_units))
        counted["since"] = counters.since(before)
        return steps

    for attempt in range(tracing.TRIES):
        with spans.recording():
            tr = tracing.traced_window(torch, run, app.sync, on_card)
        kernels, annotations, host_spans, launches = _split(
            tr.profiler.events(), torch)
        enqueued = sum(t >= tr.start_us for t in launches.values())
        if not on_card or len(kernels) >= enqueued:
            break
        harness.log(f"spans trace {attempt + 1} kept {len(kernels)} kernels "
                    f"and copies of {enqueued} enqueued")
    path = harness.TRACE_DIR / f"{_cell()}.spans.json.gz"
    path.parent.mkdir(parents=True, exist_ok=True)
    tr.profiler.export_chrome_trace(str(path))
    tr.profiler = None
    stats, unattributed = _attribute(kernels, host_spans, launches)
    gaps = tracing.Trace([k[:3] for k in kernels], host_spans, tr.start_us,
                         tr.end_us, tr.steps, enqueued).idle_gaps() \
        if kernels else []
    w = SpanWindow(tr.steps, tr.window_s, stats, counted["since"],
                   len(kernels), enqueued, unattributed, gaps, on_card)
    _log(w, ctx.trace, len(annotations), time.perf_counter() - t0)
    return w


def _split(events, torch) -> tuple:
    """The window's kernels and copies ``(name, start, end, correlation
    id)``, the spans' annotations on the card, the program's spans on the
    host ``(name, start, end)``, and ``{correlation id: start}`` of the
    host's enqueues."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host_spans, launches = [], [], {}
    for e in events:
        tr = e.time_range
        if e.name == tracing.WINDOW_SPAN:
            continue
        if getattr(e, "device_type", None) == cuda:
            device.append(e)
        elif getattr(e, "is_user_annotation", False):
            host_spans.append((e.name, tr.start, tr.end))
        elif e.name.startswith(tracing._ENQUEUES):
            launches[e.id] = tr.start
    names = {s[0] for s in host_spans}
    kernels, annotations = [], []
    for e in device:
        tr = e.time_range
        if getattr(e, "is_user_annotation", False) or e.name in names:
            annotations.append((e.name, tr.start, tr.end))
        elif tracing._SPIN not in e.name:
            kernels.append((e.name, tr.start, tr.end, e.id))
    return kernels, annotations, host_spans, launches


def _attribute(kernels, host_spans, launches) -> tuple:
    """``{span name: SpanStats}`` and the kernels whose launch was not
    found.  Spans nest on the host: each kernel goes to the innermost one
    open when its launch started, and counts for that span and every
    span around it."""
    order = sorted(range(len(host_spans)),
                   key=lambda i: (host_spans[i][1], -host_spans[i][2]))
    parent = [None] * len(host_spans)
    stats: dict = {}
    for i in order:
        name, a, b = host_spans[i]
        s = stats.setdefault(name, SpanStats())
        s.calls += 1
        s.host_s += (b - a) / 1e6
    owner_of = {}
    timed = sorted((launches[k[3]], j) for j, k in enumerate(kernels)
                   if k[3] in launches)
    stack, nxt = [], 0
    for t, j in timed:
        while nxt < len(order) and host_spans[order[nxt]][1] <= t:
            i = order[nxt]
            while stack and host_spans[stack[-1]][2] <= host_spans[i][1]:
                stack.pop()
            parent[i] = stack[-1] if stack else None
            stack.append(i)
            nxt += 1
        while stack and host_spans[stack[-1]][2] <= t:
            stack.pop()
        if stack:
            owner_of[j] = stack[-1]
    for j, i in owner_of.items():
        name, a, b, _ = kernels[j]
        dt = (b - a) / 1e6
        own = stats[host_spans[i][0]]
        own.self_s += dt
        own.self_launches += 1
        own.kernels[name] = own.kernels.get(name, 0) + 1
        seen = set()
        while i is not None:
            span_name = host_spans[i][0]
            if span_name not in seen:
                seen.add(span_name)
                stats[span_name].device_s += dt
                stats[span_name].launches += 1
            i = parent[i]
    return stats, len(kernels) - len(timed)


def _log(w: SpanWindow, harness_trace, annotations: int, took_s: float):
    n = w.steps or 1
    traced_ms = 1e3 * harness_trace.window_s / max(harness_trace.steps, 1)
    harness.log(
        f"spans window {w.window_s:.3f} s, {w.steps} steps: "
        f"{1e3 * w.window_s / n:.4f} ms a step, against the traced "
        f"window's {traced_ms:.4f}; "
        f"{w.device_ops} kernels and copies of {w.enqueued} enqueued, "
        f"{w.unattributed} with no launch found, {annotations} span "
        f"annotations on the card; {took_s:.3f} s with its processing")
    harness.log("span: calls, host ms, device ms, device self ms, "
                "launches, self launches; each a step")
    for name, s in sorted(w.spans.items(), key=lambda kv: -kv[1].device_s):
        harness.log(f"  {name}: {s.calls / n:.4g}, {1e3 * s.host_s / n:.4f}, "
                    f"{1e3 * s.device_s / n:.4f}, {1e3 * s.self_s / n:.4f}, "
                    f"{s.launches / n:.4g}, {s.self_launches / n:.4g}")
        top = sorted(s.kernels.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
        for kernel, k in top:
            harness.log(f"    {k / n:.4g} a step: "
                        f"{kernel[:tracing.NAME_CHARS]}")
    for key, (calls, nbytes) in sorted(w.counted.items()):
        harness.log(f"exchange {key[0]} {key[1]}: {calls / n:.4g} calls, "
                    f"{nbytes / n:.12g} B a step")
    for name, s in w.idle_gaps:
        harness.log(f"idle gap {1e3 * s:.4f} ms under {name}")


def device_under(w: SpanWindow, names) -> tuple:
    """Device seconds and launches under the spans ``names`` (none
    nested in another), and their calls."""
    got = [w.stats(n) for n in names]
    return (sum(s.device_s for s in got), sum(s.launches for s in got),
            sum(s.calls for s in got))


def apply_a_expected(app, sets: int) -> tuple:
    """HPCG's ``apply_a`` calls in ``sets`` sets, and the least time of
    them all: each call's x read once with its ghost planes and y written
    once, at its level (``perfbench.counts``)."""
    slabs = counts.hpcg_slabs(app.slab, app.levels)
    per_set = counts.hpcg_applies_per_set(app.iterations, len(slabs))
    itemsize = app.dtype.itemsize
    least = sum(c * counts.least_s(counts.apply_a_bytes(app.ranks, s,
                                                        itemsize),
                                   counts.apply_a_ops(app.ranks, s),
                                   app.peak_dtype)
                for c, s in zip(per_set, slabs))
    return sets * sum(per_set), sets * least
