"""Trace-driven load generation + SLO telemetry for the serve engines.

A copy of the JAX package's ``serve/loadgen.py`` (pure numpy): the same
seed gives the same workload, bit for bit, in both packages.

Uniform all-at-t0 batches hide exactly the contention effects a paged,
continuously-batched deployment exists to absorb (and that pooled-memory
studies like Wahlgren et al., arXiv 2211.02682, measure): realistic
ARRIVAL PROCESSES with mixed prompt/output-length distributions are what
surface them.  This module generates those workloads deterministically
and turns an engine run into the numbers a deployment is judged by.

  * :class:`LengthDist` — seeded integer length distributions
    (``fixed`` / ``uniform`` / ``lognormal`` / ``choice``), parseable from
    CLI specs like ``"lognormal:2.3:0.6:48"``.
  * :func:`poisson_workload` — Poisson arrivals (exponential
    inter-arrival gaps at ``rate`` requests per scheduler step) with
    sampled prompt/output lengths and prompt token ids, all from ONE
    ``numpy`` PCG64 generator: same seed -> bit-identical workload.
  * :func:`replay_workload` — trace replay from records (or a JSON file)
    of ``{"arrival", "prompt_len"| "tokens", "max_new"}``.
  * :func:`run_workload` — drive any ``ContinuousEngine`` (dense or
    paged) and reduce its per-request timestamps into a
    :class:`LoadReport`: p50/p99 completion latency, p50/p99
    time-to-first-token, sustained tok/s, and SLO attainment.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class LengthDist:
    """Seeded integer distribution over ``[lo, hi]``.

    kinds: ``fixed`` (always ``a``), ``uniform`` (inclusive ``[a, b]``),
    ``lognormal`` (``exp(N(a, b))`` clipped to ``[1, c]``), ``choice``
    (uniform over ``values``).
    """

    kind: str
    a: float = 0.0
    b: float = 0.0
    c: float = 0.0
    values: tuple = ()

    @classmethod
    def parse(cls, spec) -> "LengthDist":
        """``8`` / ``"fixed:8"`` / ``"uniform:4:12"`` /
        ``"lognormal:2.3:0.6:48"`` / ``"choice:4,8,16"``."""
        if isinstance(spec, LengthDist):
            return spec
        if isinstance(spec, (int, np.integer)):
            return cls(kind="fixed", a=float(spec))
        parts = str(spec).split(":")
        kind, args = parts[0], parts[1:]
        try:
            if kind == "fixed":
                (a,) = args
                return cls(kind=kind, a=float(a))
            if kind == "uniform":
                a, b = args
                return cls(kind=kind, a=float(a), b=float(b))
            if kind == "lognormal":
                a, b, c = args
                return cls(kind=kind, a=float(a), b=float(b), c=float(c))
            if kind == "choice":
                (vals,) = args
                return cls(kind=kind,
                           values=tuple(int(v) for v in vals.split(",")))
        except ValueError as e:
            raise ValueError(f"bad length spec {spec!r}: {e}") from None
        raise ValueError(f"unknown length distribution {kind!r} in {spec!r} "
                         "(fixed | uniform | lognormal | choice)")

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "fixed":
            out = np.full(n, self.a)
        elif self.kind == "uniform":
            out = rng.integers(int(self.a), int(self.b) + 1, size=n)
        elif self.kind == "lognormal":
            out = np.minimum(np.exp(rng.normal(self.a, self.b, size=n)),
                             self.c)
        elif self.kind == "choice":
            out = rng.choice(np.asarray(self.values), size=n)
        else:
            raise ValueError(f"unknown length distribution {self.kind!r}")
        return np.maximum(out.astype(np.int64), 1)

    def spec(self) -> str:
        if self.kind == "fixed":
            return f"fixed:{self.a:g}"
        if self.kind == "uniform":
            return f"uniform:{self.a:g}:{self.b:g}"
        if self.kind == "lognormal":
            return f"lognormal:{self.a:g}:{self.b:g}:{self.c:g}"
        return "choice:" + ",".join(str(v) for v in self.values)


@dataclass(frozen=True)
class Workload:
    """A materialized, fully deterministic request set.

    ``arrivals`` are scheduler-step indices (what
    ``ContinuousEngine.submit(arrival=)`` consumes); ``meta`` records how
    the workload was built (process, rate, seed, length specs) so a
    benchmark JSON can reproduce it exactly.
    """

    arrivals: np.ndarray               # (N,) int64 steps, sorted
    prompts: tuple                     # N x (S_i,) int32 token arrays
    max_new: np.ndarray                # (N,) int64
    meta: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.prompts)

    def requests(self) -> list:
        """``(tokens, max_new, arrival)`` tuples for ``engine.run``."""
        return [(self.prompts[i], int(self.max_new[i]),
                 int(self.arrivals[i])) for i in range(len(self))]

    @property
    def total_tokens(self) -> int:
        return int(sum(len(p) for p in self.prompts) + self.max_new.sum())


def poisson_workload(n: int, rate: float, prompt_len, new_tokens,
                     vocab_size: int, seed: int = 0,
                     max_len: int | None = None) -> Workload:
    """``n`` requests with Poisson arrivals at ``rate`` requests per
    scheduler step and lengths from ``prompt_len`` / ``new_tokens``
    (:class:`LengthDist` or parseable spec).  ``max_len`` (if given) caps
    ``prompt + new`` to fit an engine's cache: prompts clip to
    ``max_len - 1`` and budgets to the remaining room, so every generated
    request is admissible."""
    if n < 1:
        raise ValueError(f"need >= 1 request, got {n}")
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    p_dist = LengthDist.parse(prompt_len)
    o_dist = LengthDist.parse(new_tokens)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
    plens = p_dist.sample(rng, n)
    nnew = o_dist.sample(rng, n)
    if max_len is not None:
        plens = np.minimum(plens, max_len - 1)
        nnew = np.minimum(nnew, max_len - plens)
    prompts = tuple(
        np.asarray(rng.integers(0, vocab_size, size=int(s)), dtype=np.int32)
        for s in plens)
    return Workload(
        arrivals=arrivals, prompts=prompts, max_new=nnew,
        meta={"process": "poisson", "n": n, "rate": rate, "seed": seed,
              "prompt_len": p_dist.spec(), "new_tokens": o_dist.spec(),
              "vocab_size": vocab_size, "max_len": max_len})


def replay_workload(trace, vocab_size: int, seed: int = 0) -> Workload:
    """Replay a recorded trace: an iterable of records (or a path to a
    JSON file holding a list of them) with ``arrival`` and ``max_new``
    plus either explicit ``tokens`` or a ``prompt_len`` to fill with
    seeded random ids."""
    if isinstance(trace, (str, bytes)):
        with open(trace) as f:
            records = json.load(f)
        source = str(trace)
    else:
        records = list(trace)
        source = "inline"
    if not records:
        raise ValueError("empty trace")
    rng = np.random.default_rng(seed)
    arrivals, prompts, max_new = [], [], []
    for i, rec in enumerate(records):
        arrivals.append(int(rec.get("arrival", 0)))
        max_new.append(int(rec["max_new"]))
        if "tokens" in rec:
            prompts.append(np.asarray(rec["tokens"], dtype=np.int32))
        else:
            prompts.append(np.asarray(
                rng.integers(0, vocab_size, size=int(rec["prompt_len"])),
                dtype=np.int32))
    return Workload(
        arrivals=np.asarray(arrivals, dtype=np.int64), prompts=tuple(prompts),
        max_new=np.asarray(max_new, dtype=np.int64),
        meta={"process": "replay", "n": len(records), "seed": seed,
              "source": source})


@dataclass(frozen=True)
class LoadReport:
    """SLO telemetry for one workload run (times in milliseconds except
    ``sustained_tok_s``).  ``sustained_tok_s`` is generated tokens over
    the first-visible -> last-done window — the steady-state rate, not
    the per-step peak.  ``slo_attainment`` is the fraction of requests
    whose completion latency met ``slo_ms`` (1.0 when no SLO given)."""

    n_requests: int
    latency_p50_ms: float
    latency_p99_ms: float
    ttft_p50_ms: float
    ttft_p99_ms: float
    sustained_tok_s: float
    makespan_s: float
    generated_tokens: int
    slo_ms: float | None = None
    slo_attainment: float = 1.0

    def as_dict(self) -> dict:
        return {"n_requests": self.n_requests,
                "latency_p50_ms": self.latency_p50_ms,
                "latency_p99_ms": self.latency_p99_ms,
                "ttft_p50_ms": self.ttft_p50_ms,
                "ttft_p99_ms": self.ttft_p99_ms,
                "sustained_tok_s": self.sustained_tok_s,
                "makespan_s": self.makespan_s,
                "generated_tokens": self.generated_tokens,
                "slo_ms": self.slo_ms,
                "slo_attainment": self.slo_attainment}


def run_workload(engine, workload: Workload, slo_ms: float | None = None):
    """Drive ``engine`` through ``workload`` and reduce its per-request
    timestamps (``engine.req_times``) into a :class:`LoadReport`.
    Returns ``(outputs, report)`` — outputs in submission order, exactly
    as ``engine.run`` yields them."""
    tokens_before = engine.stats.generated_tokens
    rids = [engine.submit(tok, n, arrival)
            for tok, n, arrival in workload.requests()]
    outputs = engine.run()
    times = [engine.req_times[r] for r in rids]
    if any("done" not in t or "first" not in t for t in times):
        raise RuntimeError("engine finished with unrecorded request times")
    lat = np.asarray([t["done"] - t["visible"] for t in times])
    ttft = np.asarray([t["first"] - t["visible"] for t in times])
    first_visible = min(t["visible"] for t in times)
    last_done = max(t["done"] for t in times)
    makespan = max(last_done - first_visible, 1e-9)
    generated = engine.stats.generated_tokens - tokens_before
    return outputs, LoadReport(
        n_requests=len(rids),
        latency_p50_ms=float(np.percentile(lat, 50) * 1e3),
        latency_p99_ms=float(np.percentile(lat, 99) * 1e3),
        ttft_p50_ms=float(np.percentile(ttft, 50) * 1e3),
        ttft_p99_ms=float(np.percentile(ttft, 99) * 1e3),
        sustained_tok_s=float(generated / makespan),
        makespan_s=float(makespan),
        generated_tokens=int(generated),
        slo_ms=slo_ms,
        slo_attainment=1.0 if slo_ms is None
        else float(np.mean(lat * 1e3 <= slo_ms)))
