"""Paged (block) KV cache for continuous-batching serving.

The JAX package's ``serve/paged.py``.  The dense ``ContinuousEngine``
allocates one ``(n_slots, max_len)`` cache row per slot, so a single long
request prices every short request at ``max_len`` memory.  This module
stores attention KV in fixed-size **blocks** drawn from one shared pool
instead (the PagedAttention idea, Kwon et al.): each slot owns a chain of
blocks, a **block table** maps the slot's logical block index to its pool
block id, and total KV bytes scale with the sum of ACTUAL sequence lengths
rounded up to the block size — not ``n_slots * max_len``.

  * ``BlockPool`` — host-side free-list + reservation accounting over pool
    block ids (block 0 is the null block: never allocated, the write
    target of inactive slots and the read target of unallocated logical
    blocks, both rendered inert by the causal mask).
  * ``PagedContinuousEngine`` — drop-in ``ContinuousEngine`` with
      - a paged decode step: each slot's blocks gathered through the block
        table and cut to ``max_len`` -> the dense engine's decode step ->
        each slot's new K/V row scattered back to ``(table[pos // bs],
        pos % bs)`` in the pool;
      - **chunked prefill admission** (attention archs): the prompt
        streams through ``block_size``-token chunk steps, allocating its
        block right before the chunk runs;
      - block free / reuse on eos / length retirement, with admission
        backpressure (a request waits in FIFO order while the pool lacks
        blocks) and a clear :class:`PoolExhausted` error for requests
        that could never fit.

The pools are one per attention layer, ``(pool_blocks + 1, block_size, Hkv,
D)`` each.  Because the gathered per-slot cache has the dense step's
``max_len`` width, masked (causally dead) positions contribute exact zeros
either way, and the tokens equal the dense engine's.

SSM caveat: mamba/SSM recurrent states are O(1) per slot and stay dense
(there is nothing to page); SSM archs also admit via one exact-length
prefill whose KV (hybrid archs) is scattered into blocks afterwards —
chunked prefill is excluded for them because the recurrent state cannot
resume mid-prompt from a cache row.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..models import blocks as blocks_lib
from ..models import mamba as mamba_lib
from ..models.layers import dtype_of
from .scheduler import ContinuousEngine, Request


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PoolExhausted(RuntimeError):
    """The request needs more KV blocks than the pool can EVER provide."""


class BlockPool:
    """Free-list + reservation accounting over pool block ids ``1..n``.

    ``reserve`` earmarks a request's worst-case block count (prompt +
    generation budget) at admission, so the lazy per-block ``alloc`` calls
    during decode can never fail mid-flight; ``release`` returns a
    retired request's blocks (and any unused reservation) to the pool.
    Block id 0 is the null block and never enters the free list.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"pool needs >= 1 block, got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self._free = list(range(self.n_blocks, 0, -1))   # pop() -> 1, 2, ...
        self._reserved: dict = {}                        # rid -> outstanding
        self.peak_in_use = 0

    @property
    def in_use(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def available(self) -> int:
        """Blocks neither allocated nor promised to an admitted request."""
        return len(self._free) - sum(self._reserved.values())

    def fits_ever(self, n: int) -> bool:
        return n <= self.n_blocks

    def try_reserve(self, rid: int, n: int) -> bool:
        if n > self.available:
            return False
        self._reserved[rid] = self._reserved.get(rid, 0) + n
        return True

    def alloc(self, rid: int) -> int:
        held = self._reserved.get(rid, 0)
        if held < 1:
            raise PoolExhausted(f"request {rid} allocating beyond its "
                                "reservation (engine bug)")
        self._reserved[rid] = held - 1
        blk = self._free.pop()
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return blk

    def release(self, rid: int, block_ids) -> None:
        self._free.extend(block_ids)
        self._reserved.pop(rid, None)


@dataclass
class PagedContinuousEngine(ContinuousEngine):
    """Continuous batching over a shared block pool (see module docstring).

    ``block_size`` is the per-block token count (also the chunked-prefill
    chunk length); ``pool_blocks`` sizes the shared pool (0 means the
    dense equivalent ``n_slots * ceil(max_len / block_size)``, i.e. no
    admission backpressure).  ``prefill_buckets`` is rejected for
    attention archs — the chunk step replaces bucketed prefill entirely.
    """

    block_size: int = 16
    pool_blocks: int = 0

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1: {self.block_size}")
        cfg = self.model.cfg
        self._specs = blocks_lib.layer_specs(cfg)
        self._max_blocks = _cdiv(self.max_len, self.block_size)
        if not self.pool_blocks:
            self.pool_blocks = self.n_slots * self._max_blocks
        super().__post_init__()
        if self.prefill_buckets:        # SSM archs already rejected in super
            raise ValueError(
                "PagedContinuousEngine prefills in block_size chunks; "
                "prefill_buckets do not apply (drop them)")

    # ---------------------------------------------------------- pool state
    def _init_cache_state(self):
        """KV pools, one per attention layer: ``{"k"/"v": (pool_blocks + 1,
        block_size, Hkv, D)}`` (+1 for the null block 0); per-slot Mamba
        states (O(1) per slot: nothing to page); ``None`` elsewhere."""
        cfg = self.model.cfg
        dt = dtype_of(cfg)
        shape = (self.pool_blocks + 1, self.block_size, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        self._pools = [{"k": torch.zeros(shape, dtype=dt, device=self.device),
                        "v": torch.zeros(shape, dtype=dt, device=self.device)}
                       if spec.mixer == "attn" else None
                       for spec in self._specs]
        self._dense = [mamba_lib.init_mamba_state(cfg, self.n_slots,
                                                  self.device)
                       if spec.mixer == "mamba" else None
                       for spec in self._specs]
        self._tables = np.zeros((self.n_slots, self._max_blocks),
                                dtype=np.int32)
        self._slot_blocks = [[] for _ in range(self.n_slots)]
        self._pool = BlockPool(self.pool_blocks)

    # ----------------------------------------------------------- kv bytes
    @property
    def block_bytes(self) -> int:
        """KV bytes of ONE pool block across all attention layers."""
        return sum(x[0].numel() * x.element_size()
                   for pl in self._pools if pl is not None
                   for x in pl.values())

    @property
    def kv_bytes_in_use(self) -> int:
        return self._pool.in_use * self.block_bytes

    @property
    def kv_bytes_peak(self) -> int:
        return self._pool.peak_in_use * self.block_bytes

    @property
    def kv_bytes_dense(self) -> int:
        """What the dense engine's ``(n_slots, max_len)`` rows would cost."""
        return self.n_slots * self._max_blocks * self.block_bytes

    # -------------------------------------------------------- device steps
    def _gather(self, pools, tables, width: int) -> list:
        """Per-slot attention caches through the block table: each pool
        gathers the slots' blocks and flattens to ``(slots, width, Hkv,
        D)`` (unallocated logical blocks read the null block — causally
        masked); ``tables`` is ``(slots, max_blocks)`` on the device."""
        out = []
        for pl in pools:
            if pl is None:
                out.append(None)
                continue
            leaf = {}
            for name, P in pl.items():
                g = P[tables]                       # (slots, mb, bs, H, D)
                leaf[name] = g.reshape(g.shape[0], -1, *g.shape[3:])[
                    :, :width]
            out.append(leaf)
        return out

    def _decode_paged(self, tokens, pos):
        """One decode step for ALL slots against the shared pool (see
        :meth:`_paged_step`)."""
        tables = torch.as_tensor(self._tables, device=self.device)
        logits, self._dense = self._paged_step(self._pools, self._dense,
                                               tables, tokens, pos)
        return logits

    def _paged_step(self, pools, dense, tables, tokens, pos):
        """gather -> the dense engine's decode step (a position per slot)
        -> scatter each slot's new K/V row into ``pools``.  Inactive slots
        write their (null) ``table[0]`` block — harmless by construction.
        Returns (logits, the per-slot states after the step)."""
        bs = self.block_size
        caches = [g if spec.mixer == "attn" else d for spec, g, d in zip(
            self._specs, self._gather(pools, tables, self.max_len), dense)]
        logits, new = self.model.decode_step(caches, {"tokens": tokens}, pos)
        slots = torch.arange(self.n_slots, device=tokens.device)
        blk = tables[slots, pos // bs]
        off = pos % bs
        for i, spec in enumerate(self._specs):
            if spec.mixer == "attn":
                for name, P in pools[i].items():
                    P[blk, off] = new[i][name][slots, pos]
        return logits, [new[i] if spec.mixer == "mamba" else d
                        for i, (spec, d) in enumerate(zip(self._specs,
                                                          dense))]

    def _prefill_chunk(self, slot: int, chunk: np.ndarray, pos: int):
        """One ``block_size``-token prompt chunk for ONE slot (see
        :meth:`_chunk_step`)."""
        table = torch.as_tensor(self._tables[slot:slot + 1],
                                device=self.device)
        tok = torch.as_tensor(chunk, device=self.device)
        return self._chunk_step(self._pools, table, tok, pos,
                                int(self._tables[slot, pos // self.block_size]))

    def _chunk_step(self, pools, table, tok, pos: int, blk):
        """A prompt chunk of one slot (attention archs): gather the slot's
        cache (``table`` is its ``(1, max_blocks)`` row) at full padded
        width, run the multi-token decode step at positions ``pos .. pos +
        bs - 1`` and scatter the chunk's K/V block into pool block
        ``blk``."""
        bs = self.block_size
        # the chunk's write must fit the width un-clipped
        caches = self._gather(pools, table, self._max_blocks * bs)
        logits, new = self.model.decode_step(caches, {"tokens": tok[None]},
                                             pos)
        for pl, nc in zip(pools, new):
            if pl is not None:
                for name, P in pl.items():
                    P[blk] = nc[name][0, pos:pos + bs]
        return logits

    def _write_paged(self, new, blk_ids, slot: int) -> None:
        """Install one EXACT-length prefilled request (SSM / hybrid archs):
        scatter each attention cache's first ``len(blk_ids)`` blocks of
        rows into the pool, write recurrent states into the slot's dense
        row.  Only the prompt's blocks are taken, so pool use tracks S."""
        bs = self.block_size
        n = len(blk_ids)
        ids = torch.as_tensor(blk_ids, dtype=torch.long, device=self.device)
        for i, spec in enumerate(self._specs):
            if spec.mixer == "attn":
                for name, P in self._pools[i].items():
                    rows = new[i][name][0, :n * bs]
                    rows = F.pad(rows, (0, 0, 0, 0, 0, n * bs - len(rows)))
                    P[ids] = rows.reshape(n, bs, *rows.shape[1:])
            elif spec.mixer == "mamba":
                for name, C in zip(new[i]._fields, self._dense[i]):
                    C[slot] = getattr(new[i], name)[0]

    # ------------------------------------------------------- host control
    def _blocks_needed(self, req: Request) -> int:
        S = len(req.tokens)
        budget = min(req.max_new_tokens, self.max_len - S)
        return _cdiv(S + budget, self.block_size)

    def _validate_capacity(self, req: Request) -> None:
        if req.max_new_tokens <= 0:
            return                        # nothing is ever admitted
        need = self._blocks_needed(req)
        if not self._pool.fits_ever(need):
            raise PoolExhausted(
                f"request needs {need} KV blocks (prompt {len(req.tokens)} "
                f"+ budget tokens at block_size={self.block_size}) but the "
                f"pool only holds {self._pool.n_blocks}; raise pool_blocks= "
                "or shorten the request")

    def _can_admit(self, req: Request) -> bool:
        return self._pool.available >= self._blocks_needed(req)

    def _alloc_block(self, slot: int, rid: int) -> int:
        blk = self._pool.alloc(rid)
        self._slot_blocks[slot].append(blk)
        self._tables[slot, len(self._slot_blocks[slot]) - 1] = blk
        self.stats.kv_bytes_peak = max(self.stats.kv_bytes_peak,
                                       self.kv_bytes_peak)
        self.stats.kv_bytes_dense = self.kv_bytes_dense
        return blk

    def _prefill_into_slot(self, req: Request, slot: int):
        bs = self.block_size
        S = len(req.tokens)
        if not self._pool.try_reserve(req.rid, self._blocks_needed(req)):
            raise PoolExhausted(           # _can_admit gates this
                f"admitting request {req.rid} without pool room "
                "(engine bug)")
        if self._exact_prefill:
            return self._admit_exact(req, slot)
        n_chunks = _cdiv(S, bs)
        logits = None
        for j in range(n_chunks):
            self._alloc_block(slot, req.rid)     # stream: one per chunk
            chunk = np.zeros(bs, dtype=np.int32)
            part = req.tokens[j * bs:(j + 1) * bs]
            chunk[:len(part)] = part
            logits = self._prefill_chunk(slot, chunk, j * bs)
        self._count_prefill(f"prefill_chunk@{bs}", n_chunks)
        last = (S - 1) - (n_chunks - 1) * bs
        return logits[:, last:last + 1]

    def _admit_exact(self, req: Request, slot: int):
        """SSM/hybrid admission: one exact-length prefill (the recurrent
        state cannot resume mid-prompt), then block-granular scatter."""
        S = len(req.tokens)
        logits, new = self.model.prefill(
            {"tokens": torch.as_tensor(req.tokens[None], device=self.device)},
            self.max_len, last_index=[S - 1])
        blk_ids = [self._alloc_block(slot, req.rid)
                   for _ in range(_cdiv(S, self.block_size))] \
            if any(s.mixer == "attn" for s in self._specs) else []
        self._write_paged(new, blk_ids, slot)
        self._count_prefill(f"prefill@{S}")
        return logits

    def _grow_blocks(self) -> None:
        """Allocate the next block for any active slot whose write position
        crossed into an unallocated logical block (reservation-backed, so
        this cannot fail mid-flight)."""
        for slot in range(self.n_slots):
            req = self._slot_req[slot]
            if req is None:
                continue
            if self._pos[slot] // self.block_size \
                    >= len(self._slot_blocks[slot]):
                self._alloc_block(slot, req.rid)

    def _decode_active(self):
        self._grow_blocks()
        tokens, pos = self._step_inputs()
        return self._sample_step(self._decode_paged(tokens, pos))

    def _retire(self, slot: int) -> None:
        req = self._slot_req[slot]
        super()._retire(slot)
        self._pool.release(req.rid, self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self._tables[slot, :] = 0          # inactive slots target null

    # ------------------------------------------------------ advisor bridge
    def compiled_steps(self, buckets=None) -> dict:
        """Every step this deployment runs, captured without running it:
        the paged decode plus either the single chunk-prefill step
        (attention archs) or one exact-length prefill per seen length
        (SSM archs; ``buckets`` overrides, ``max_len`` if none yet)."""
        from ..core.graph import abstract, capture
        dev = self.device
        tables = abstract(torch.zeros, (self.n_slots, self._max_blocks),
                          dtype=torch.int32, device=dev)
        tokens, pos = self._step_shapes()
        with torch.no_grad():
            out = {"decode": capture(self._paged_step, self._pools,
                                     self._dense, tables, tokens, pos,
                                     name="decode")}
        if self._exact_prefill:
            for L in tuple(sorted(buckets or self._seen_buckets())) \
                    or (self.max_len,):
                out[f"prefill@{L}"] = self._capture_prefill(L)
            return out
        bs = self.block_size
        row = abstract(torch.zeros, (1, self._max_blocks), dtype=torch.int32,
                       device=dev)
        tok = abstract(torch.zeros, (bs,), dtype=torch.int32, device=dev)
        with torch.no_grad():
            out[f"prefill_chunk@{bs}"] = capture(
                lambda p, t, c: self._chunk_step(p, t, c, 0, t[0, :1]),
                self._pools, row, tok, name=f"prefill_chunk@{bs}")
        return out

