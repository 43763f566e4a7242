"""Top-level language model: embedding/frontend + block stack + LM head.

The JAX package's ``models/lm.py``: the forward pass, and prefill / decode
with their caches for serving.  One class covers
all assigned families; the modality frontends (VLM patch embeddings, audio
frame embeddings) are stubs — the backbone consumes precomputed embeddings
provided in the batch.

``cfg.embedding_multiplier`` scales the token embeddings and the logits
are divided by ``cfg.logits_scaling`` (port only; 1 leaves them as they
are).  ``decode_step`` runs inside the span ``lm.decode_step``
(``repro_torch.spans``).

Batch contracts (all values tensors on the model's device):
  * LM families:  {"tokens": (B, S) i32, "targets": (B, S) i32}
  * vlm:   {"tokens": (B, S_text), "image_embeds": (B, S_img, F),
            "targets": (B, S_text)}
  * audio: {"frame_embeds": (B, S, F), "targets": (B, S, K) i32}
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import spans
from ..parallel import fsdp, sharding, transport
from . import blocks, layers, moe
from .config import ArchConfig


class LanguageModel(nn.Module):
    """The model's parameters, drawn from ``generator`` on its device, and
    its forward pass.  ``use_kernel`` runs attention and the SSM scan on the
    CUDA kernels (forward only); ``moe_impl`` is ``"scatter"``, ``"dense"``
    or ``"ep_local"``.

    With a ``mesh`` whose ``model`` axis has R > 1 ranks, every parameter
    is this rank's block of the executed layout
    (``parallel.sharding.param_layout``: the reference's "tp" layout), each
    tensor drawn whole from the same stream as the whole model's and cut at
    once, so a rank holds the very weights of the whole model: attention by
    query head, the dense MLP by ``d_ff`` column, mamba by ``d_inner``
    channel, the embedding and the head by vocabulary, and the MoE layers'
    E / R experts (``moe_impl="ep_local"``, which a MoE arch then needs).
    Without ``fsdp`` the data axes do not change what a rank holds.

    ``fsdp``: each tensor is also cut over the data axes of ``mesh``
    (:func:`fsdp_plan`), its block set on the parameter as ``p.fsdp``; the
    layers, the embedding, the head and the final norm gather it where they
    use it (``parallel.fsdp``).

    ``layout="fsdp_seq"`` (the reference's pure FSDP with
    sequence-sharded activations; FSDP is implied): no tensor parallelism;
    every tensor is cut over all ranks (``sharding.fsdp_seq_specs``) and
    gathered whole where it is used, and each ``model`` rank runs its
    contiguous block of ``L / R`` positions (``self.seq``, a
    ``sharding.SeqAxis``), cut after :meth:`_embed_inputs`, at its global
    positions.  The loss sums this rank's cross-entropy and divides by the
    data shard's token count through one all-reduce over ``model``; the
    logits of :meth:`forward` are gathered along the sequence; prefill
    returns the last position's logits on every rank.  MoE layers route
    with ``"scatter"`` or ``"dense"`` over the global batch
    (``"ep_local"`` raises)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 use_kernel: bool = False, moe_impl: str = "scatter",
                 mesh=None, fsdp: bool = False, layout: str = "tp"):
        super().__init__()
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.moe_impl = moe_impl
        self.mesh = mesh
        self.seq = None
        self._cache_blocks = {}
        if layout == "fsdp_seq":
            if mesh is None:
                raise ValueError("layout='fsdp_seq' needs a mesh")
            if moe_impl == "ep_local" and cfg.n_experts:
                raise ValueError(
                    f"{cfg.name}: layout='fsdp_seq' gathers the experts "
                    "whole; route with moe_impl='scatter' or 'dense' (got "
                    "'ep_local')")
            fsdp = True
            self.seq = sharding.seq_axis(mesh)
        elif layout != "tp":
            raise ValueError(f"unknown layout {layout!r}; 'tp' or "
                             "'fsdp_seq'")
        self.tp = tp = None if self.seq is not None \
            else sharding.model_axis(mesh)
        self.vocab = sharding.vocab_block(cfg, tp)
        if fsdp and mesh is None:
            raise ValueError("fsdp=True needs a mesh with data axes")
        plan = fsdp_plan(cfg, mesh, layout) if fsdp else {}
        gen = generator
        dt = layers.dtype_of(cfg)
        keep = layers.whole
        if tp is not None:
            if cfg.n_experts and moe_impl != "ep_local":
                raise ValueError(
                    f"{cfg.name}: on a model axis of {tp.size} the experts "
                    "are split over the ranks; moe_impl='ep_local' "
                    f"dispatches to them (got {moe_impl!r})")
            if cfg.n_experts:
                moe.expert_block(cfg, mesh)           # raises if E % R
        if tp is not None or plan:
            R = 1 if tp is None else tp.size
            rank = 0 if tp is None else tp.rank

            def keep(name, t):
                lay = sharding.param_layout(cfg, name, t.ndim, R)
                blk = _block_of(plan, name)
                if lay.whole and blk is None:
                    return t
                t = lay.take(t, rank)
                return (t if blk is None else blk.take(t)).clone()
        self.embed = layers.init_embedding(cfg, gen, keep)
        self.stack = blocks.init_stack(cfg, gen, keep)
        self.final_norm = nn.Parameter(keep("final_norm", torch.ones(
            (cfg.d_model,), dtype=dt, device=gen.device)))
        if cfg.frontend == "vision":
            self.mm_proj = nn.Parameter(keep("mm_proj", layers.normal(
                gen, (cfg.frontend_dim, cfg.d_model), dt,
                1.0 / math.sqrt(cfg.frontend_dim))))
        elif cfg.frontend == "audio":
            self.frame_proj = nn.Parameter(keep("frame_proj", layers.normal(
                gen, (cfg.frontend_dim, cfg.d_model), dt,
                1.0 / math.sqrt(cfg.frontend_dim))))
            self.lm_heads = nn.Parameter(keep("lm_heads", layers.normal(
                gen, (cfg.d_model, cfg.n_codebooks * cfg.vocab_size), dt,
                1.0 / math.sqrt(cfg.d_model))))
        if plan:
            for name, p in self.named_parameters():
                blk = _block_of(plan, name)
                if blk is not None:
                    p.fsdp = blk
                elif self.seq is not None:
                    p.seq_group = self.seq.group

    # ------------------------------------------------------------- embedding
    def _vocab_tp(self):
        """(the model axis, this rank's first vocab entry) where the
        vocabulary is split, else (None, 0): indivisible vocabularies run
        whole, with no all-reduce."""
        if self.vocab is None:
            return None, 0
        return self.tp, self.vocab[0]

    def _embed_inputs(self, batch):
        cfg = self.cfg
        dt = layers.dtype_of(cfg)
        tp, lo = self._vocab_tp()
        embed = fsdp.view(self.embed)
        if cfg.frontend == "vision":
            img = batch["image_embeds"].to(dt) @ fsdp.gather(self.mm_proj)
            txt = layers.embed(embed, batch["tokens"], tp, lo)
            return torch.cat([img, txt], dim=1)
        if cfg.frontend == "audio":
            return batch["frame_embeds"].to(dt) @ fsdp.gather(self.frame_proj)
        x = layers.embed(embed, batch["tokens"], tp, lo)
        m = cfg.embedding_multiplier
        return x if m == 1.0 else x * m

    def _head_local(self, x):
        """This rank's logits: its vocab block (per codebook for audio)
        where the vocabulary is split, else all of them."""
        cfg = self.cfg
        tp, lo = self._vocab_tp()
        x = layers.rms_norm(x, fsdp.gather(self.final_norm), cfg.norm_eps)
        if cfg.frontend == "audio":
            if tp is not None:
                x = transport.sum_backward(x, tp.group)
            logits = x @ fsdp.gather(self.lm_heads)
            return logits.reshape(*x.shape[:-1], cfg.n_codebooks, -1)
        logits = layers.unembed(fsdp.view(self.embed), x,
                                vocab_size=cfg.vocab_size
                                if cfg.vocab_pad else None, tp=tp, lo=lo)
        s = cfg.logits_scaling
        return logits if s == 1.0 else logits / s

    def _head(self, x):
        """The whole logits: this rank's block gathered over ``model``."""
        logits = self._head_local(x)
        tp, _ = self._vocab_tp()
        return logits if tp is None else transport.gather_last(logits,
                                                               tp.group)

    # --------------------------------------------------------------- forward
    def _seq_block(self, x):
        """This rank's block of the positions of ``x`` (B, L, d) and their
        global positions (1, L / R)."""
        n = self.seq.block(x.shape[1], self.cfg.name)
        lo = self.seq.rank * n
        pos = torch.arange(lo, lo + n, device=x.device)[None, :]
        return x[:, lo:lo + n], pos

    def _mixers(self):
        """The stack's keyword arguments of this model's layout."""
        if self.seq is not None:
            return {"seq": self.seq}
        return {"mesh": self.mesh}

    def _trunk(self, batch):
        x = self._embed_inputs(batch)
        positions = None
        if self.seq is not None:
            x, positions = self._seq_block(x)
        x, aux = blocks.stack_apply(self.stack, x, self.cfg, positions,
                                    use_kernel=self.use_kernel,
                                    moe_impl=self.moe_impl, **self._mixers())
        if self.cfg.frontend == "vision" and self.seq is None:
            x = x[:, self.cfg.img_seq:]       # logits only over text positions
        return x, aux

    def forward(self, batch):
        """Training-shape forward.  Returns (logits, aux_loss); under
        tensor parallelism the logits are gathered over ``model`` for the
        caller (every rank returns them whole), and under ``"fsdp_seq"``
        along the sequence."""
        x, aux = self._trunk(batch)
        if self.seq is None:
            return self._head(x), aux
        logits = transport.gather_whole(self._head_local(x), self.seq.group,
                                        1)
        if self.cfg.frontend == "vision":
            logits = logits[:, self.cfg.img_seq:]
        return logits, aux

    def _seq_loss(self, x, aux, targets):
        """The ``"fsdp_seq"`` loss: this rank's positions' cross-entropy
        summed, all-reduced over ``model`` and divided by the data shard's
        target count (vision: image positions carry no target)."""
        logits = self._head_local(x).float()
        n = targets.numel()
        if self.cfg.frontend == "vision":
            img = self.cfg.img_seq
            targets = F.pad(targets, (img, 0))
        lo = self.seq.rank * x.shape[1]
        t = targets[:, lo:lo + x.shape[1]]
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, t[..., None])[..., 0]
        ce = lse - gold
        if self.cfg.frontend == "vision":
            pos = lo + torch.arange(x.shape[1], device=x.device)
            ce = ce * (pos >= self.cfg.img_seq)
        ce = transport.sum_forward(ce.sum(), self.seq.group) / n
        return ce + 0.01 * aux

    def loss(self, batch):
        """Mean next-token cross-entropy (+0.01 * MoE aux loss).  Under
        tensor parallelism the cross-entropy runs over this rank's vocab
        block (``transport.vocab_cross_entropy``): the logits are never
        gathered."""
        x, aux = self._trunk(batch)
        targets = batch["targets"].long()
        if self.seq is not None:
            return self._seq_loss(x, aux, targets)
        logits = self._head_local(x)
        tp, lo = self._vocab_tp()
        if tp is not None:
            ce = transport.vocab_cross_entropy(logits, targets, lo, tp.group)
            return ce.mean() + 0.01 * aux
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets[..., None])[..., 0]
        return (lse - gold).mean() + 0.01 * aux

    # --------------------------------------------------------------- serving
    def prefill(self, batch, max_len: int, last_index=None,
                global_batch: int | None = None):
        """Process the prompt; returns (last-position logits, caches).

        ``last_index`` (optional, ``(B,)`` int) selects the position whose
        logits are returned instead of the final one — the bucketed-prefill
        path of the continuous-batching scheduler right-pads prompts to a
        bucket length, so the "last real token" sits at ``prompt_len - 1``.
        Causal attention makes positions ``< prompt_len`` independent of the
        padding, and decode overwrites the stale cache rows at padded
        positions before they are ever attended.  With ``use_kernel`` the
        attention and Mamba layers run the CUDA kernels, at any length.
        Under ``"fsdp_seq"`` the caches are this rank's blocks, and the
        last position's logits (rank R-1's) are returned on every rank;
        ``last_index`` raises there (no engine runs that layout).  Under
        ``"tp"`` with a mesh the caches are this rank's
        :meth:`cache_block` (``global_batch``: the global batch whose rows
        ``batch`` holds, as :meth:`cache_block` reads it).
        """
        x = self._embed_inputs(batch)
        if self.seq is not None:
            if last_index is not None:
                raise NotImplementedError(
                    "layout='fsdp_seq' prefill returns the last position; "
                    "last_index (the bucketed prefill of the continuous "
                    "engines) has no sequence-sharded path")
            x, positions = self._seq_block(x)
            x, caches = blocks.stack_prefill(
                self.stack, x, self.cfg, max_len, use_kernel=self.use_kernel,
                moe_impl=self.moe_impl, seq=self.seq, positions=positions)
            last = transport.all_gather(x[:, -1:], self.seq.group)[-1]
            return self._head(last), caches
        x, caches = blocks.stack_prefill(
            self.stack, x, self.cfg, max_len, use_kernel=self.use_kernel,
            moe_impl=self.moe_impl, mesh=self.mesh,
            cache=self.cache_block(x.shape[0], max_len, global_batch))
        if last_index is None:
            x_last = x[:, -1:]
        else:
            idx = torch.as_tensor(last_index, device=x.device).long()
            x_last = x[torch.arange(x.shape[0], device=x.device),
                       idx.reshape(-1)][:, None]
        return self._head(x_last), caches

    def decode_step(self, caches, batch, pos, max_len: int | None = None,
                    global_batch: int | None = None, release: bool = False):
        """New tokens at ``pos``.  ``batch`` carries the inputs at those
        positions ({"tokens": (B, S)} or {"frame_embeds": (B, S, F)}, S = 1
        for ordinary decode); ``pos`` is the write index into the caches:
        an int for the whole batch, or a (B,) tensor with one per row.  The
        attention caches are written in place; returns (logits, caches).
        Decode runs the plain paths, as in the reference.  Under ``"tp"``
        with a mesh the caches are :meth:`cache_block` of ``max_len``
        positions (``None``: the caches' own length, L whole) and
        ``global_batch``; a block that splits L takes an int ``pos``.
        ``release``: the caller hands the list ``caches`` over
        (``blocks.stack_decode``)."""
        with spans.span("lm.decode_step"):
            return self._decode_step(caches, batch, pos, max_len,
                                     global_batch, release)

    def _decode_step(self, caches, batch, pos, max_len, global_batch,
                     release):
        x = self._embed_inputs(batch)
        cache = None
        attn = [c for c in caches if isinstance(c, dict)]
        if attn and self.seq is None and self.mesh is not None:
            held = attn[0]["k"].shape[1]
            cache = self.cache_block(x.shape[0], max_len or held,
                                     global_batch)
            if cache.length != held:
                raise ValueError(
                    f"{self.cfg.name}: caches of {held} positions are not "
                    f"this rank's block of {max_len or held} "
                    f"({cache.length}); pass the whole length as max_len")
        x, caches = blocks.stack_decode(self.stack, caches, x, self.cfg, pos,
                                        moe_impl=self.moe_impl, cache=cache,
                                        release=release, **self._mixers())
        return self._head(x), caches

    def init_caches(self, batch_size: int, max_len: int,
                    global_batch: int | None = None):
        """Zeroed decode caches of ``batch_size`` rows (this rank's block
        of each under ``"tp"`` with a mesh: :meth:`cache_block`; under
        ``"fsdp_seq"``, its block of the positions)."""
        return blocks.init_caches(self.cfg, batch_size, max_len, self.device,
                                  self.tp, self.seq, self.cache_block(
                                      batch_size, max_len, global_batch))

    def cache_block(self, rows: int, max_len: int,
                    global_batch: int | None = None):
        """This rank's ``sharding.CacheBlock`` of the decode caches under
        ``"tp"`` with a mesh (else ``None``): ``rows`` are the rows this
        rank was given, of a global batch of ``global_batch`` rows (the
        block of the batch over the data axes where it divides them, else
        all of it, as ``batch_pspecs`` lays it out; ``None``: ``rows`` are
        this rank's block, ``rows`` x the data ranks in all).  Made once
        for each (rows, batch, length): every rank must ask at the same
        point, outside a capture (a group of several axes is made on first
        use)."""
        if self.mesh is None or self.seq is not None:
            return None
        if global_batch is None:
            dp = sharding.present_data_axes(self.mesh)
            global_batch = rows * sharding.axis_size(self.mesh, dp)
        key = (rows, global_batch, max_len)
        if key not in self._cache_blocks:
            blk = sharding.cache_block(self.cfg, self.mesh, global_batch,
                                       max_len)
            if blk.rows != rows:
                raise ValueError(
                    f"{self.cfg.name}: {rows} rows are not this rank's of a "
                    f"batch of {global_batch} ({blk.rows} rows a rank)")
            self._cache_blocks[key] = blk
        return self._cache_blocks[key]

    @property
    def device(self) -> torch.device:
        """The device the parameters live on."""
        return self.final_norm.device

    # ------------------------------------------------------------- counting
    def param_count(self) -> int:
        """The parameters this rank holds."""
        return sum(p.numel() for p in self.parameters())

    def whole_param_count(self) -> int:
        """The whole model's parameters, whatever this rank holds."""
        R = 1 if self.tp is None else self.tp.size
        total = 0
        for name, p in self.named_parameters():
            lay = sharding.param_layout(self.cfg, name, p.ndim, R)
            blk = getattr(p, "fsdp", None)
            shape = p.shape if blk is None else blk.whole_shape(p.shape)
            total += math.prod(lay.whole_shape(shape))
        return total

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


# --------------------------------------------------------------------- FSDP
class _Sizes:
    """A mesh's axis names and sizes, read as a ``DeviceMesh``'s by the
    sharding rules (hashable, for the cache below)."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)


@functools.lru_cache(maxsize=None)
def _fsdp_specs(cfg: ArchConfig, names: tuple, shape: tuple,
                layout: str = "tp") -> dict:
    """``{short name: (the FSDP spec of its leaf, whether the leaf is
    stacked)}`` of ``cfg``'s whole model on a mesh of these axes
    (``sharding.fsdp_specs``; ``sharding.fsdp_seq_specs`` under
    ``"fsdp_seq"``), from a model built under a fake mode (no weight
    drawn).  Every layer of a stacked leaf has its spec, so a stack
    tensor is keyed by its name in the layer (``attn.wq``), as ``keep``
    names it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from .convert import leaf_path, leaves_of
    with FakeTensorMode():
        model = LanguageModel(cfg, torch.Generator(device="cpu"))
        named = list(model.named_parameters())
    leaves = leaves_of(cfg, named)
    whole = [sharding.WholeLeaf(leaf.path, leaf.shape) for leaf in leaves]
    rule = sharding.fsdp_seq_specs if layout == "fsdp_seq" \
        else sharding.fsdp_specs
    specs = dict(zip((leaf.path for leaf in leaves),
                     rule(whole, _Sizes(names, shape))))
    return {short_name(name): (specs[leaf_path(cfg, name)],
                               name.startswith("stack."))
            for name, _ in named}


def short_name(name: str) -> str:
    """A parameter's name as the initialisers' ``keep`` gives it: a stack
    tensor's without its ``stack.<i>.`` prefix."""
    return name.split(".", 2)[2] if name.startswith("stack.") else name


def fsdp_plan(cfg: ArchConfig, mesh, layout: str = "tp") -> dict:
    """``{short name: sharding.FsdpBlock or None}``: this rank's block over
    ``mesh``'s data axes (under ``"fsdp_seq"``: the data axes and
    ``model``) of each port tensor under FSDP (keyed as :func:`short_name`
    keys it), with those axes' process group (every rank must ask at the
    same point: a group over several axes is made on first use)."""
    specs = _fsdp_specs(cfg, tuple(mesh.mesh_dim_names),
                        tuple(int(n) for n in mesh.shape), layout)
    axes = sharding.seq_axes(mesh) if layout == "fsdp_seq" \
        else sharding.data_axes(mesh)
    group = sharding.axes_group(mesh, axes)
    coord = mesh.get_coordinate()
    return {name: sharding.fsdp_block(s, stacked, mesh, coord, group)
            for name, (s, stacked) in specs.items()}


def _block_of(plan: dict, name: str):
    """The block of parameter ``name`` (a full or short name) in ``plan``."""
    return plan.get(short_name(name)) if plan else None
