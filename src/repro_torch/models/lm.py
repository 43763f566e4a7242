"""Top-level language model: embedding/frontend + block stack + LM head.

The JAX package's ``models/lm.py``: the forward pass, and prefill / decode
with their caches for serving.  One class covers
all assigned families; the modality frontends (VLM patch embeddings, audio
frame embeddings) are stubs — the backbone consumes precomputed embeddings
provided in the batch.

Batch contracts (all values tensors on the model's device):
  * LM families:  {"tokens": (B, S) i32, "targets": (B, S) i32}
  * vlm:   {"tokens": (B, S_text), "image_embeds": (B, S_img, F),
            "targets": (B, S_text)}
  * audio: {"frame_embeds": (B, S, F), "targets": (B, S, K) i32}
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import blocks, layers, moe
from .config import ArchConfig


class LanguageModel(nn.Module):
    """The model's parameters, drawn from ``generator`` on its device, and
    its forward pass.  ``use_kernel`` runs attention and the SSM scan on the
    CUDA kernels (forward only); ``moe_impl`` is ``"scatter"``, ``"dense"``
    or ``"ep_local"``.  With ``"ep_local"`` and a ``mesh`` whose ``model``
    axis has R > 1 ranks, each MoE layer holds only this rank's E / R
    experts (drawn from the same stream as the whole model's) and
    dispatches over that axis; every other parameter is whole."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 use_kernel: bool = False, moe_impl: str = "scatter",
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.moe_impl = moe_impl
        self.mesh = mesh
        gen = generator
        dt = layers.dtype_of(cfg)
        experts = moe.expert_block(cfg, mesh) \
            if moe_impl == "ep_local" and cfg.n_experts else None
        self.embed = layers.init_embedding(cfg, gen)
        self.stack = blocks.init_stack(cfg, gen, experts)
        self.final_norm = nn.Parameter(
            torch.ones((cfg.d_model,), dtype=dt, device=gen.device))
        if cfg.frontend == "vision":
            self.mm_proj = nn.Parameter(layers.normal(
                gen, (cfg.frontend_dim, cfg.d_model), dt,
                1.0 / math.sqrt(cfg.frontend_dim)))
        elif cfg.frontend == "audio":
            self.frame_proj = nn.Parameter(layers.normal(
                gen, (cfg.frontend_dim, cfg.d_model), dt,
                1.0 / math.sqrt(cfg.frontend_dim)))
            self.lm_heads = nn.Parameter(layers.normal(
                gen, (cfg.d_model, cfg.n_codebooks * cfg.vocab_size), dt,
                1.0 / math.sqrt(cfg.d_model)))

    # ------------------------------------------------------------- embedding
    def _embed_inputs(self, batch):
        cfg = self.cfg
        dt = layers.dtype_of(cfg)
        if cfg.frontend == "vision":
            img = batch["image_embeds"].to(dt) @ self.mm_proj
            txt = layers.embed(self.embed, batch["tokens"])
            return torch.cat([img, txt], dim=1)
        if cfg.frontend == "audio":
            return batch["frame_embeds"].to(dt) @ self.frame_proj
        return layers.embed(self.embed, batch["tokens"])

    def _head(self, x):
        cfg = self.cfg
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        if cfg.frontend == "audio":
            logits = x @ self.lm_heads
            return logits.reshape(*x.shape[:-1], cfg.n_codebooks,
                                  cfg.vocab_size)
        return layers.unembed(self.embed, x,
                              vocab_size=cfg.vocab_size
                              if cfg.vocab_pad else None)

    # --------------------------------------------------------------- forward
    def forward(self, batch):
        """Training-shape forward.  Returns (logits, aux_loss)."""
        x = self._embed_inputs(batch)
        x, aux = blocks.stack_apply(self.stack, x, self.cfg,
                                    use_kernel=self.use_kernel,
                                    moe_impl=self.moe_impl, mesh=self.mesh)
        if self.cfg.frontend == "vision":
            x = x[:, self.cfg.img_seq:]       # logits only over text positions
        return self._head(x), aux

    def loss(self, batch):
        """Mean next-token cross-entropy (+0.01 * MoE aux loss)."""
        logits, aux = self.forward(batch)
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, batch["targets"].long()[..., None])[..., 0]
        return (lse - gold).mean() + 0.01 * aux

    # --------------------------------------------------------------- serving
    def prefill(self, batch, max_len: int, last_index=None):
        """Process the prompt; returns (last-position logits, caches).

        ``last_index`` (optional, ``(B,)`` int) selects the position whose
        logits are returned instead of the final one — the bucketed-prefill
        path of the continuous-batching scheduler right-pads prompts to a
        bucket length, so the "last real token" sits at ``prompt_len - 1``.
        Causal attention makes positions ``< prompt_len`` independent of the
        padding, and decode overwrites the stale cache rows at padded
        positions before they are ever attended.  With ``use_kernel`` the
        attention and Mamba layers run the CUDA kernels, at any length.
        """
        x = self._embed_inputs(batch)
        x, caches = blocks.stack_prefill(self.stack, x, self.cfg, max_len,
                                         use_kernel=self.use_kernel,
                                         moe_impl=self.moe_impl,
                                         mesh=self.mesh)
        if last_index is None:
            x_last = x[:, -1:]
        else:
            idx = torch.as_tensor(last_index, device=x.device).long()
            x_last = x[torch.arange(x.shape[0], device=x.device),
                       idx.reshape(-1)][:, None]
        return self._head(x_last), caches

    def decode_step(self, caches, batch, pos):
        """New tokens at ``pos``.  ``batch`` carries the inputs at those
        positions ({"tokens": (B, S)} or {"frame_embeds": (B, S, F)}, S = 1
        for ordinary decode); ``pos`` is the write index into the caches:
        an int for the whole batch, or a (B,) tensor with one per row.  The
        attention caches are written in place; returns (logits, caches).
        Decode runs the plain paths, as in the reference."""
        x = self._embed_inputs(batch)
        x, caches = blocks.stack_decode(self.stack, caches, x, self.cfg, pos,
                                        moe_impl=self.moe_impl,
                                        mesh=self.mesh)
        return self._head(x), caches

    def init_caches(self, batch_size: int, max_len: int):
        return blocks.init_caches(self.cfg, batch_size, max_len, self.device)

    @property
    def device(self) -> torch.device:
        """The device the parameters live on."""
        return self.final_norm.device

    # ------------------------------------------------------------- counting
    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE counts top-k of E experts)."""
        cfg = self.cfg
        total = 0
        for module in self.modules():
            experts = isinstance(module, layers.Params) and "router" in module
            for name, p in module.named_parameters(recurse=False):
                if experts and name in ("w_gate", "w_up", "w_down"):
                    total += p.numel() // cfg.n_experts \
                        * cfg.experts_per_token
                else:
                    total += p.numel()
        return total
