"""Reading the card: a traced window under ``torch.profiler``, its busy and
idle time, its top device operations, its idle gaps named by what the host
was doing, and the device time of one call.

The profiler can lose a trace's first device events, so
:data:`LEAD_SPINS` empty spin kernels run first and are left out; and it
now and then loses others, so a trace whose device events are fewer than
the launches the host made is taken again, up to :data:`TRIES` times.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

LEAD_SPINS = 256
TRIES = 3
#: The span around a traced window, on the host's timeline.
WINDOW_SPAN = "perfbench.window"
#: Host calls that each put one operation on the card's queue.
_ENQUEUES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
             "cuMemcpy", "cuMemset")
_SPIN = "spin_kernel"
TOP = 10
#: A breakdown's names are cut to this many characters (a kernel's name
#: spells out its templates, some 600 characters).
NAME_CHARS = 200


@dataclass
class Trace:
    """One traced window: the card's operations and the host's as
    ``(name, start_us, end_us)``, the window's bounds on the same clock,
    the app steps it ran and the host's enqueues in it."""

    device: list
    host: list
    start_us: float
    end_us: float
    steps: int
    enqueued: int
    #: The profiler, until its trace is written out.
    profiler: object = None

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, in the window."""
        out = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            a, b = max(a, self.start_us), min(b, self.end_us)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_s(self, part: str = "") -> float:
        """Summed seconds of the device operations whose name holds
        ``part``."""
        return sum(b - a for n, a, b in self.device if part in n) / 1e6

    def count(self, part: str = "") -> int:
        return sum(part in n for n, _, _ in self.device)

    def top_ops(self, n: int = TOP) -> list:
        """The ``n`` device operations with the most summed seconds."""
        by_name: dict = {}
        for name, a, b in self.device:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        return [[name[:NAME_CHARS], s] for name, s in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = TOP) -> list:
        """The ``n`` longest stretches of the window in which the card ran
        nothing, each named by the innermost host call running at its
        start (the window's own span if none)."""
        gaps, at = [], self.start_us
        for a, b in self.busy_intervals() + [[self.end_us, self.end_us]]:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at(a)[:NAME_CHARS], (b - a) / 1e6]
                for a, b in gaps[:n]]

    def _host_at(self, t: float) -> str:
        best = None
        for name, a, b in self.host:
            if a <= t < b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else WINDOW_SPAN


def _split(events, torch) -> tuple:
    cuda = torch.autograd.DeviceType.CUDA
    device, host, span = [], [], None
    for e in events:
        tr = e.time_range
        if e.name == WINDOW_SPAN:
            # the span shows on the card's timeline too, as an annotation
            if getattr(e, "device_type", None) != cuda:
                span = (tr.start, tr.end)
        elif getattr(e, "device_type", None) == cuda:
            if _SPIN not in e.name:
                device.append((e.name, tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
    return device, host, span


def traced_window(torch, run, sync, on_card: bool) -> Trace:
    """Trace ``run()``, which enqueues work and returns the app steps it
    enqueued; the window is synchronised at both ends.  On a card, a trace
    that kept fewer device operations than the host enqueued is taken
    again (the last one is kept, and says so on standard error)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    for attempt in range(TRIES):
        with profile(activities=acts) as prof:
            if on_card:
                sync()
                for _ in range(LEAD_SPINS):
                    torch.cuda._sleep(1)
            sync()
            with torch.profiler.record_function(WINDOW_SPAN):
                steps = run()
                sync()
        device, host, span = _split(prof.events(), torch)
        enqueued = sum(any(n.startswith(p) for p in _ENQUEUES)
                       and a >= span[0] for n, a, _ in host)
        trace = Trace(device, host, span[0], span[1], steps, enqueued, prof)
        if not on_card or len(device) >= enqueued:
            return trace
        print(f"perfbench: trace {attempt + 1} kept {len(device)} device "
              f"operations of {enqueued} enqueued", file=sys.stderr)
    return trace


def device_s_per_call(torch, fn, calls: int, warmup: int = 2) -> float:
    """Seconds of the card's operations (kernels and copies, summed) a call
    of ``fn()``, from a traced window of ``calls`` calls in a row after
    ``warmup``."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(calls):
            fn()
        return calls
    tr = traced_window(torch, run, torch.cuda.synchronize, True)
    return tr.device_s() / calls
