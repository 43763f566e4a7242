"""Deterministic, stateless data pipeline: the JAX package's
``train/data.py``.

``batch(step)`` is a pure function of ``(seed, step)``, with no iterator
state: a restarted or replacement worker reproduces exactly the batches of
any step range, so checkpoint/restart never skips or repeats data.

The synthetic LM task draws sequences from a fixed bank of templates with
token-level corruption: compressible structure, so optimization makes real
progress, with no external dataset.  The contract is the reference's (the
keys, shapes and dtypes of each frontend's batch, templates plus
corruption), but the draws are not: the reference draws with
``jax.random``, whose streams torch cannot replay, so the port draws on the
host with numpy Generators seeded from ``(seed, stream, step)``.  Its
tokens differ from the reference's, and are the same on the CPU and on the
card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ArchConfig, ShapeConfig
from ..models.factory import torch_device

# numpy seed-sequence streams, after the reference's fold_in constants
_TEMPLATES, _TOKENS, _FRONTEND = 1, 2, 3


@dataclass(frozen=True)
class SyntheticTask:
    cfg: ArchConfig
    shape: ShapeConfig
    seed: int = 0
    n_templates: int = 64
    corruption: float = 0.02
    device: str = "cuda"

    def _rng(self, stream: int, step: int = 0) -> np.random.Generator:
        return np.random.default_rng((self.seed, stream, step))

    def _templates(self, length: int) -> np.ndarray:
        return self._rng(_TEMPLATES).integers(
            0, self.cfg.vocab_size, (self.n_templates, length + 1))

    def _token_stream(self, step: int, batch: int, length: int) -> tuple:
        """(tokens, targets) int32: next-token pairs from corrupted
        templates."""
        templates = self._templates(length)
        rng = self._rng(_TOKENS, step)
        idx = rng.integers(0, self.n_templates, batch)
        seqs = templates[idx]                               # (B, L+1)
        noise = rng.integers(0, self.cfg.vocab_size, seqs.shape)
        mask = rng.random(seqs.shape) < self.corruption
        seqs = np.where(mask, noise, seqs).astype(np.int32)
        return seqs[:, :-1], seqs[:, 1:]

    def _normal(self, step: int, shape) -> torch.Tensor:
        return torch.from_numpy(self._rng(_FRONTEND, step).standard_normal(
            shape, dtype=np.float32)).to(torch.bfloat16)

    def batch(self, step: int) -> dict:
        """The global batch for one optimizer step (pure in (seed, step)),
        on :attr:`device`."""
        cfg, shape = self.cfg, self.shape
        B, S = shape.global_batch, shape.seq_len
        if cfg.frontend == "vision":
            tokens, targets = self._token_stream(step, B, S - cfg.img_seq)
            out = {"tokens": tokens,
                   "image_embeds": self._normal(
                       step, (B, cfg.img_seq, cfg.frontend_dim)),
                   "targets": targets}
        elif cfg.frontend == "audio":
            frames = self._normal(step, (B, S, cfg.frontend_dim))
            tok, _ = self._token_stream(step, B, S * cfg.n_codebooks)
            out = {"frame_embeds": frames,
                   "targets": tok.reshape(B, S, cfg.n_codebooks)
                   % cfg.vocab_size}
        else:
            tokens, targets = self._token_stream(step, B, S)
            out = {"tokens": tokens, "targets": targets}
        dev = torch_device(self.device)
        return {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
                if isinstance(v, np.ndarray) else v.to(dev)
                for k, v in out.items()}


def make_data(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
              **kw) -> SyntheticTask:
    return SyntheticTask(cfg=cfg, shape=shape, seed=seed, **kw)
