"""Continuous-batching serving engine (slot-based scheduler).

The JAX package's ``serve/scheduler.py``.  ``ServeEngine`` runs a STATIC
batch; a deployment instead sees requests arriving over time with
different prompt/output lengths — the orchestration this module owns:

  * one ``(n_slots, max_len)`` decode step for all slots, with a position
    per slot: ``LanguageModel.decode_step`` with a ``(n_slots,)`` position
    tensor writes each slot's row at its own index and routes each slot's
    token through the MoE layers on its own (the reference maps the
    single-sequence decode over the slots with ``jax.vmap``);
  * bucketed prefill-into-slot admission: prompts are right-padded to a
    small set of bucket lengths (causal attention makes the padded
    positions inert, and decode overwrites each stale cache row before
    attending it); archs with SSM layers admit at the exact length;
  * eos / length retirement frees a slot for the next queued request the
    moment a sequence finishes;
  * a host-side FIFO request queue plus occupancy / tok-s telemetry
    (``ServeStats``).

Each step's sampled tokens come to the host (one copy per step, as in the
reference): the scheduler needs them, and that wait is what makes the
per-request times of ``req_times`` the times the tokens existed.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.lm import LanguageModel
from .engine import DECODE_STREAM, sample_logits, stream_generator


@dataclass
class Request:
    """One generation request.  ``arrival`` is the engine step index at
    which the request becomes visible to the scheduler (0 = immediately);
    ``rid`` is assigned by ``submit``."""

    tokens: np.ndarray                 # (S,) prompt token ids
    max_new_tokens: int
    arrival: int = 0
    rid: int = -1


@dataclass
class ServeStats:
    """Occupancy / throughput telemetry for one ``run``.

    ``prefills_by_bucket`` counts admissions per prefill shape (``"prefill@L"``
    for the bucketed engines, ``"prefill_chunk@bs"`` for the paged chunked
    path) — with ``decode_steps`` the observed step mix that
    :meth:`ContinuousEngine.step_weights` reports.  The ``kv_bytes_*``
    fields are populated by the paged engine (0 on the dense engines): peak
    pool bytes actually allocated vs the dense ``n_slots * max_len``
    equivalent."""

    n_slots: int
    decode_steps: int = 0        # (n_slots, max_len) decode steps executed
    slot_steps: int = 0          # Σ active slots over those steps
    idle_steps: int = 0          # scheduler ticks with nothing decodable
    prefills: int = 0
    prefill_tokens: int = 0      # real (unpadded) prompt tokens prefilled
    generated_tokens: int = 0
    completed: int = 0
    wall_s: float = 0.0
    prefills_by_bucket: dict = field(default_factory=dict)
    kv_bytes_peak: int = 0       # paged: peak allocated pool bytes
    kv_bytes_dense: int = 0      # dense-equivalent n_slots * max_len bytes

    @property
    def occupancy(self) -> float:
        """Fraction of slot-steps that did useful work (1.0 = every slot
        active on every decode step)."""
        return self.slot_steps / max(1, self.decode_steps * self.n_slots)

    @property
    def tok_s(self) -> float:
        return self.generated_tokens / max(self.wall_s, 1e-9)

    def as_dict(self) -> dict:
        return {"n_slots": self.n_slots, "decode_steps": self.decode_steps,
                "slot_steps": self.slot_steps, "idle_steps": self.idle_steps,
                "prefills": self.prefills,
                "prefill_tokens": self.prefill_tokens,
                "generated_tokens": self.generated_tokens,
                "completed": self.completed, "wall_s": self.wall_s,
                "occupancy": self.occupancy, "tok_s": self.tok_s,
                "prefills_by_bucket": dict(self.prefills_by_bucket),
                "kv_bytes_peak": self.kv_bytes_peak,
                "kv_bytes_dense": self.kv_bytes_dense}


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclass
class ContinuousEngine:
    """Slot-based continuous batching over one decode step.

    ``prefill_buckets`` lists the admission prompt lengths; empty means one
    power-of-two bucket per prompt-length class.  Padding is an
    attention-only trick — archs with SSM layers admit at the exact prompt
    length (and reject explicit buckets).  ``eos_id`` retires a sequence
    the moment it samples that token.
    """

    model: LanguageModel
    n_slots: int
    max_len: int
    temperature: float = 0.0
    eos_id: int | None = None
    prefill_buckets: tuple = ()
    seed: int = 0

    def __post_init__(self):
        cfg = self.model.cfg
        if cfg.frontend is not None:
            raise ValueError("ContinuousEngine drives token LMs; multimodal "
                             "decode stays on the static ServeEngine")
        # Right-padded bucket prefill is only inert under causal ATTENTION.
        # A mamba/SSM layer folds every position — padding included — into
        # its recurrent state and conv tail, so SSM archs admit at the
        # exact prompt length instead.
        self._exact_prefill = bool(cfg.ssm_state)
        if self._exact_prefill and self.prefill_buckets:
            raise ValueError(
                f"{cfg.name} has SSM layers: bucketed (padded) prefill "
                "would corrupt the recurrent state; omit prefill_buckets "
                "(prompts admit at their exact length)")
        self.prefill_buckets = tuple(sorted(self.prefill_buckets))
        if any(b > self.max_len for b in self.prefill_buckets):
            raise ValueError(f"prefill bucket exceeds max_len="
                             f"{self.max_len}: {self.prefill_buckets}")
        self.device = self.model.device
        self._reset()

    # ----------------------------------------------------------- sampling
    def _sample(self, logits, stream: int):
        gen = None if self.temperature <= 0.0 \
            else stream_generator(self.device, self.seed, stream)
        return sample_logits(logits, gen, self.temperature)

    # ------------------------------------------------------- host control
    def _reset(self):
        self._init_cache_state()
        self._pos = np.zeros(self.n_slots, dtype=np.int32)
        self._tokens = np.zeros((self.n_slots, 1), dtype=np.int32)
        self._slot_req = [None] * self.n_slots      # Request or None
        self._emitted = np.zeros(self.n_slots, dtype=np.int64)
        self._budget = np.zeros(self.n_slots, dtype=np.int64)
        self._queue: list = []
        self._order: list = []
        self._outputs: dict = {}
        self._next_rid = 0
        self.stats = ServeStats(n_slots=self.n_slots)
        #: rid -> {"visible": wall_s, "first": wall_s, "done": wall_s} —
        #: the raw per-request timestamps the load-generator report turns
        #: into TTFT / completion-latency percentiles (serve.loadgen)
        self.req_times: dict = {}

    def _init_cache_state(self):
        """Allocate the per-slot decode caches (paged engine overrides)."""
        self.caches = self.model.init_caches(self.n_slots, self.max_len)

    def submit(self, tokens, max_new_tokens: int, arrival: int = 0) -> int:
        """Queue one request; returns its request id."""
        toks = np.asarray(tokens, dtype=np.int32).reshape(-1)
        if len(toks) == 0:
            raise ValueError("empty prompt")
        if len(toks) >= self.max_len:
            raise ValueError(f"prompt of {len(toks)} tokens leaves no room "
                             f"to generate (max_len={self.max_len})")
        req = Request(tokens=toks, max_new_tokens=int(max_new_tokens),
                      arrival=int(arrival), rid=self._next_rid)
        self._validate_capacity(req)
        self._next_rid += 1
        self._order.append(req.rid)
        if req.max_new_tokens <= 0:       # nothing to generate: done now
            self._outputs[req.rid] = np.zeros(0, dtype=np.int32)
            now = time.perf_counter()
            self.req_times[req.rid] = {"visible": now, "first": now,
                                       "done": now}
            self.stats.completed += 1
        else:
            self._queue.append(req)
        return req.rid

    def _validate_capacity(self, req: Request) -> None:
        """Reject requests that can NEVER be admitted (paged engine: more
        blocks than the whole pool holds).  Dense slots always fit."""

    def _bucket_for(self, n: int) -> int:
        if self._exact_prefill:
            return n                      # SSM state: no padding allowed
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return min(self.max_len, _next_pow2(n))

    def _count_prefill(self, key: str, n: int = 1) -> None:
        by = self.stats.prefills_by_bucket
        by[key] = by.get(key, 0) + n

    def _prefill_into_slot(self, req: Request, slot: int):
        """Engine-specific admission: compute the prompt's caches, install
        them into ``slot``, return the last real token's logits.  Dense
        path: one bucketed (right-padded) prefill + a full-row overwrite."""
        S = len(req.tokens)
        L = self._bucket_for(S)
        padded = np.zeros((1, L), dtype=np.int32)
        padded[0, :S] = req.tokens
        logits, new = self.model.prefill(
            {"tokens": torch.as_tensor(padded, device=self.device)},
            self.max_len, last_index=[S - 1])
        install(self.caches, new, slot)
        self._count_prefill(f"prefill@{L}")
        return logits

    def _admit(self, req: Request, slot: int) -> None:
        S = len(req.tokens)
        logits = self._prefill_into_slot(req, slot)
        tok = int(self._sample(logits, req.rid)[0, 0])
        self._slot_req[slot] = req
        self._pos[slot] = S
        self._tokens[slot, 0] = tok
        self._budget[slot] = min(req.max_new_tokens, self.max_len - S)
        self._emitted[slot] = 0
        self._outputs[req.rid] = []
        self.stats.prefills += 1
        self.stats.prefill_tokens += S
        t = self.req_times.setdefault(req.rid,
                                      {"visible": time.perf_counter()})
        t["first"] = time.perf_counter()
        self._emit(slot, tok)

    def _emit(self, slot: int, tok: int) -> None:
        req = self._slot_req[slot]
        self._outputs[req.rid].append(tok)
        self._emitted[slot] += 1
        self.stats.generated_tokens += 1
        done = self._emitted[slot] >= self._budget[slot] \
            or (self.eos_id is not None and tok == self.eos_id)
        if done:
            self._retire(slot)

    def _retire(self, slot: int) -> None:
        req = self._slot_req[slot]
        self._outputs[req.rid] = np.asarray(self._outputs[req.rid],
                                            dtype=np.int32)
        self._slot_req[slot] = None
        self._pos[slot] = 0
        self._tokens[slot, 0] = 0
        self.req_times[req.rid]["done"] = time.perf_counter()
        self.stats.completed += 1

    def _can_admit(self, req: Request) -> bool:
        """Admission backpressure hook: the paged engine defers admission
        while the block pool lacks room (blocks free as slots retire)."""
        return True

    def _step_inputs(self):
        """This step's (tokens (n_slots, 1), positions (n_slots,)) on the
        device."""
        return (torch.as_tensor(self._tokens, device=self.device),
                torch.as_tensor(self._pos, device=self.device))

    def _decode_active(self):
        """Run the decode step over all slots; returns the (n_slots,)
        sampled host tokens (paged engine overrides: block-table growth +
        gather/scatter decode)."""
        tokens, pos = self._step_inputs()
        logits, self.caches = self.model.decode_step(
            self.caches, {"tokens": tokens}, pos)
        return self._sample_step(logits)

    def _sample_step(self, logits):
        # decode streams lie above DECODE_STREAM, prefill streams (request
        # ids) below: disjoint streams from one seed
        return self._sample(logits, DECODE_STREAM
                            + self.stats.decode_steps).cpu().numpy()[:, 0]

    def step(self, now: int = 0) -> bool:
        """One scheduler tick: admit what fits, then decode every active
        slot once.  Returns True if any work (admission or decode) ran."""
        for slot in range(self.n_slots):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            if self._queue[0].arrival > now:
                break                      # FIFO: don't jump future arrivals
            if not self._can_admit(self._queue[0]):
                break                      # FIFO: wait for blocks to free
            self._admit(self._queue.pop(0), slot)
        active = [s for s in range(self.n_slots)
                  if self._slot_req[s] is not None]
        if not active:
            self.stats.idle_steps += 1
            return False
        sampled = self._decode_active()
        self.stats.decode_steps += 1
        self.stats.slot_steps += len(active)
        for slot in active:
            self._pos[slot] += 1
            tok = int(sampled[slot])
            self._tokens[slot, 0] = tok
            self._emit(slot, tok)
        return True

    @torch.inference_mode()
    def run(self, requests=None) -> list:
        """Drain the queue (plus ``requests``: ``(tokens, max_new)`` or
        ``(tokens, max_new, arrival)`` tuples); returns one ``(n_i,)``
        token array per request in submission order."""
        for r in requests or ():
            self.submit(*r)
        self._queue.sort(key=lambda r: (r.arrival, r.rid))
        t0 = time.perf_counter()
        now = 0
        while self._queue or any(r is not None for r in self._slot_req):
            wall = time.perf_counter()
            for r in self._queue:
                if r.arrival > now:
                    break                  # queue is arrival-sorted
                self.req_times.setdefault(r.rid, {"visible": wall})
            self.step(now)
            now += 1
        self.stats.wall_s += time.perf_counter() - t0
        out = [self._outputs[rid] for rid in self._order]
        self._order = []
        self._outputs = {}
        return out

    def step_weights(self) -> dict:
        """Observed step mix of everything run so far —
        ``{"decode": n_decode_steps, "prefill@L": n_admissions_at_L, ...}``
        (the advisor's ``weights=`` in the JAX package)."""
        return {"decode": float(self.stats.decode_steps),
                **{k: float(v)
                   for k, v in self.stats.prefills_by_bucket.items()}}

    def _seen_buckets(self) -> tuple:
        """The configured prefill buckets and the prefill lengths admitted
        so far."""
        seen = {int(k[len("prefill@"):]) for k in self.stats.prefills_by_bucket
                if k.startswith("prefill@")}
        return tuple(sorted(seen | set(self.prefill_buckets)))

    def _capture_prefill(self, L: int):
        """One admission's prefill at length ``L`` (a ``(1,)`` last index),
        captured."""
        from ..core.graph import abstract, capture
        model, dev = self.model, self.device
        tok = abstract(torch.zeros, (1, L), dtype=torch.int32, device=dev)
        idx = abstract(torch.zeros, (1,), dtype=torch.int32, device=dev)
        with torch.no_grad():
            return capture(
                lambda t, i: model.prefill({"tokens": t}, self.max_len,
                                           last_index=i),
                tok, idx, name=f"prefill@{L}")

    def _step_shapes(self):
        """Fake (tokens (n_slots, 1), positions (n_slots,)) of a decode
        step."""
        from ..core.graph import abstract
        return (abstract(torch.zeros, (self.n_slots, 1), dtype=torch.int32,
                         device=self.device),
                abstract(torch.zeros, (self.n_slots,), dtype=torch.int32,
                         device=self.device))

    def compiled_steps(self, buckets=None) -> dict:
        """Every step this deployment runs, captured without running it —
        one prefill per bucket + the fixed ``(n_slots, max_len)`` decode
        with a position per slot — keyed ``"prefill@L"`` / ``"decode"``.
        ``buckets`` defaults to the prefill buckets seen so far
        (``max_len`` if none yet).  The input to ``core.price(engine,
        grid)``: all the deployment's collectives under one scenario grid
        in one batched evaluation."""
        from ..core.graph import capture
        buckets = tuple(sorted(buckets or self._seen_buckets())) \
            or (self.max_len,)
        out = {f"prefill@{L}": self._capture_prefill(L) for L in buckets}
        tokens, pos = self._step_shapes()
        model = self.model
        with torch.no_grad():
            out["decode"] = capture(
                lambda c, t, p: model.decode_step(c, {"tokens": t}, p),
                self.caches, tokens, pos, name="decode")
        return out


def install(caches, new, slot: int) -> None:
    """Write one prefilled request's caches ``new`` (a batch of 1) into row
    ``slot`` of every layer's ``caches``, in place (the reference's
    donated ``_write``)."""
    for cache, fresh in zip(caches, new):
        if cache is None:
            continue
        for name in (cache if isinstance(cache, dict) else cache._fields):
            _field(cache, name)[slot] = _field(fresh, name)[0]


def _field(cache, name: str) -> torch.Tensor:
    """One tensor of a layer's cache: ``cache["k"]`` or ``state.conv``."""
    return cache[name] if isinstance(cache, dict) else getattr(cache, name)


# --------------------------------------------------------------------------
# Captured entry points (repro_torch.analysis.ircheck registrations)
# --------------------------------------------------------------------------

def _ircheck_engine(device="cpu", abstract=True) -> ContinuousEngine:
    """The reference's reduced qwen2.5-3b engine (2 slots of 16 positions,
    a prefill bucket of 8), its weights fake when ``abstract``."""
    from ..configs import get_arch
    from ..core.graph import abstract as fake
    from ..models import make_model
    cfg = get_arch("qwen2.5-3b").reduced()
    build = lambda: make_model(cfg, device=device)
    model = fake(build) if abstract else build()
    return ContinuousEngine(model=model, n_slots=2, max_len=16,
                            prefill_buckets=(8,))


def _step_inputs_of(eng) -> tuple:
    dev = eng.device
    return (torch.zeros((eng.n_slots, 1), dtype=torch.int32, device=dev),
            torch.zeros((eng.n_slots,), dtype=torch.int32, device=dev))


def _ircheck_decode_spec(device="cpu", abstract=True):
    """The decode step over every slot, the caches written in place."""
    from ..analysis.ircheck import EntrySpec, src_for
    eng = _ircheck_engine(device, abstract)
    model = eng.model
    tokens, pos = _step_inputs_of(eng)
    return EntrySpec(
        name="serve.decode",
        fn=lambda c, t, p: model.decode_step(c, {"tokens": t}, p),
        args=(eng.caches, tokens, pos), inplace=(0,),
        src=src_for(ContinuousEngine._decode_active))


def _ircheck_write_spec(device="cpu", abstract=True):
    """One admission's caches installed into a slot, in place."""
    from ..analysis.ircheck import EntrySpec, src_for
    eng = _ircheck_engine(device, abstract)
    new = eng.model.init_caches(1, eng.max_len)
    return EntrySpec(name="serve.write", fn=install,
                     args=(eng.caches, new, 0), inplace=(0,),
                     src=src_for(install))


def _ircheck_prefill_spec(device="cpu", abstract=True):
    """One admission's prefill at the engine's bucket."""
    from ..analysis.ircheck import EntrySpec, src_for
    eng = _ircheck_engine(device, abstract)
    model, L = eng.model, eng.prefill_buckets[0]
    tok = torch.zeros((1, L), dtype=torch.int32, device=eng.device)
    idx = torch.zeros((1,), dtype=torch.int32, device=eng.device)
    return EntrySpec(
        name="serve.prefill",
        fn=lambda t, i: model.prefill({"tokens": t}, eng.max_len,
                                      last_index=i),
        args=(tok, idx), src=src_for(ContinuousEngine._prefill_into_slot))


def register_ircheck_entrypoints(register) -> None:
    """Register the serving steps with ``repro_torch.analysis.ircheck``:
    the decode step and the slot write update the caches in place (the
    reference's two donated jits)."""
    register("serve.decode", _ircheck_decode_spec)
    register("serve.write", _ircheck_write_spec)
    register("serve.prefill", _ircheck_prefill_spec)
