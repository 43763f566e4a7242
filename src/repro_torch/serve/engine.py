"""Batched serving engine: one prefill + a decode loop.

The JAX package's ``serve/engine.py``.  Generation drives
``LanguageModel.prefill`` and ``decode_step`` in a host loop with greedy or
temperature sampling; requests are batched (static batch — continuous
batching is ``serve.scheduler``).  PyTorch runs eagerly, so there is no
compile step: the model's own device is the engine's, and everything runs
under ``torch.inference_mode``.

Temperature draws cannot replay ``jax.random.categorical``.  They are
Gumbel-max draws from a ``torch.Generator`` on the engine's device, seeded
per stream: :func:`stream_generator` mixes the engine's seed with a stream
id, as the reference folds its key — a request's prefill draws from stream
``rid`` (the static engine's from 0), decode step ``i`` from
``DECODE_STREAM + i``, so under one engine seed no two streams share a
generator seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.lm import LanguageModel

#: First decode stream id: prefill streams (request ids) lie below it.
DECODE_STREAM = 0x80000000


#: Odd multiplier that spreads engine seeds over the 32-bit seed space.
_SEED_MIX = 0x9E3779B1


def stream_generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one sampling stream of an engine
    seeded with ``seed`` (``0 <= seed, stream < 2**32``).  Its seed is
    ``seed * _SEED_MIX + stream`` mod 2**32 (the CPU generator reads only
    32 bits of a seed): distinct streams of one engine seed get distinct
    generator seeds."""
    if not (0 <= seed < 1 << 32 and 0 <= stream < 1 << 32):
        raise ValueError(f"seed {seed} and stream {stream} must lie in "
                         "[0, 2**32)")
    return torch.Generator(device=device).manual_seed(
        (seed * _SEED_MIX + stream) % (1 << 32))


def sample_logits(logits, generator: torch.Generator | None = None,
                  temperature: float = 0.0):
    """logits: (B, 1, V) (or (B, 1, K, V) for audio codebooks) -> int32
    tokens of shape ``logits.shape[:-1]``; greedy (argmax) at temperature
    0, else a draw from ``softmax(logits / temperature)`` by the Gumbel-max
    trick on ``generator``."""
    if temperature <= 0.0:
        return logits.argmax(-1).int()
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (logits.float() / temperature + gumbel).argmax(-1).int()


@dataclass
class ServeEngine:
    model: LanguageModel
    max_len: int
    temperature: float = 0.0

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _sample(self, logits, seed: int, stream: int):
        gen = None if self.temperature <= 0.0 \
            else stream_generator(self.device, seed, stream)
        return sample_logits(logits, gen, self.temperature)

    @torch.inference_mode()
    def generate(self, tokens, n_new: int, seed: int = 0,
                 eos_id: int | None = None):
        """tokens: (B, S) prompt (numpy or tensor) -> (B, n_new) int32
        continuation on the engine's device.

        ``eos_id`` (token LMs only): once a sequence samples the eos token
        it stops contributing sampled tokens — every later position is
        padded with ``eos_id`` (the eos itself is kept), and decoding stops
        early when ALL sequences have finished.
        """
        if not torch.is_tensor(tokens):
            tokens = torch.from_numpy(np.array(tokens))
        tokens = tokens.to(self.device)
        B, S = tokens.shape
        if S + n_new > self.max_len:
            raise ValueError(f"prompt {S} + {n_new} new tokens exceed "
                             f"max_len={self.max_len}")
        if n_new == 0:
            return tokens[:, :0]             # nothing to generate: no prefill
        logits, caches = self.model.prefill({"tokens": tokens}, self.max_len)
        out = []
        tok = self._sample(logits, seed, 0)                  # (B, 1)
        if eos_id is not None and tok.ndim != 2:
            raise ValueError("eos_id= needs a token LM ((B, 1) samples), "
                             f"got sample shape {tuple(tok.shape)}")
        finished = torch.zeros((B, 1), dtype=torch.bool, device=self.device)
        for i in range(n_new):
            if eos_id is not None:
                tok = torch.where(finished, eos_id, tok).int()
                finished = finished | (tok == eos_id)
            out.append(tok)
            if i == n_new - 1:
                break
            if eos_id is not None and bool(finished.all()):
                break                      # every sequence hit eos: pad rest
            logits, caches = self.model.decode_step(caches, {"tokens": tok},
                                                    S + i)
            tok = self._sample(logits, seed, DECODE_STREAM + i)
        if len(out) < n_new:               # early-stopped: pad with eos
            out.append(torch.full((B, n_new - len(out)), eos_id,
                                  dtype=out[0].dtype, device=self.device))
        return torch.cat(out, dim=1)

    @torch.inference_mode()
    def decode_throughput_step(self, caches, batch, pos):
        """The raw decode step (benchmarks)."""
        return self.model.decode_step(caches, batch, pos)

    def compiled_steps(self, batch_size: int = 1, prompt_len: int = 32
                       ) -> dict:
        """This engine's steps captured without running them, for the
        advisor: ``{"prefill@L": CapturedStep, "decode": CapturedStep}``,
        what ``core.price(engine_or_steps, grid)`` prices as one batched
        deployment (``ContinuousEngine.compiled_steps`` is the multi-bucket
        analog).  The decode step writes position ``prompt_len``."""
        from ..core.graph import abstract, capture
        if self.model.cfg.frontend is not None:
            raise ValueError("compiled_steps captures a {'tokens': (B, L)} "
                             "batch — token LMs only (multimodal batches "
                             "carry frontend embeddings)")
        model, dev = self.model, self.device
        tok = abstract(torch.zeros, (batch_size, prompt_len),
                       dtype=torch.int32, device=dev)
        one = abstract(torch.zeros, (batch_size, 1), dtype=torch.int32,
                       device=dev)
        caches = abstract(model.init_caches, batch_size, self.max_len)
        with torch.no_grad():
            return {
                f"prefill@{prompt_len}": capture(
                    lambda t: model.prefill({"tokens": t}, self.max_len),
                    tok, name=f"prefill@{prompt_len}"),
                "decode": capture(
                    lambda c, t: model.decode_step(c, {"tokens": t},
                                                   prompt_len),
                    caches, one, name="decode"),
            }
