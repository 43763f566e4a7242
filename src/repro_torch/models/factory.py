"""Model + input construction for every (arch, shape) cell.

``make_model``  — ArchConfig -> LanguageModel, its weights drawn from a
                  seeded ``torch.Generator`` on the device
``abstract_params`` — ArchConfig -> the parameters' names, shapes and
                  dtypes, drawn from nothing (meta tensors; a rank's
                  blocks with a ``mesh``); ``abstract_caches`` /
                  ``decode_inputs`` likewise for the decode caches and one
                  decode step's operands
``make_inputs`` — (cfg, shape) -> batch of tensors, drawn with numpy
                  exactly as the JAX package's ``make_inputs`` draws them,
                  so both sides see bit-identical tokens, targets and
                  frontend embeddings

Both run on the card unless the caller names another device, and raise when
the card is absent; there is no fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel import sharding
from . import blocks
from .config import ArchConfig, ShapeConfig
from .lm import LanguageModel


def torch_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and no CUDA
    device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{dev} was asked for but no CUDA device is "
                           "present; pass device='cpu' to run on the CPU")
    return dev


def make_model(cfg: ArchConfig, use_kernel: bool = False,
               moe_impl: str = "scatter", device="cuda",
               generator: torch.Generator | None = None,
               mesh=None, fsdp: bool = False,
               layout: str = "tp") -> LanguageModel:
    """The model with its weights drawn on ``device`` from ``generator``
    (a fresh one seeded with 0 when None; it must live on ``device``).
    ``mesh`` (a ``DeviceMesh``): tensor and expert parallelism over its
    ``model`` axis — each tensor is drawn whole from the same stream as
    the whole model's and cut to this rank's block at once, so a rank's
    weights equal the whole model's and only one tensor at a time is
    ever whole.  ``fsdp``: each block is also cut over the mesh's data
    axes (``LanguageModel``), likewise at once.  ``layout="fsdp_seq"``:
    pure FSDP over every rank with the sequence split over ``model``
    (``LanguageModel``)."""
    dev = torch_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    elif torch.device(generator.device).type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    return LanguageModel(cfg, generator, use_kernel=use_kernel,
                         moe_impl=moe_impl, mesh=mesh, fsdp=fsdp,
                         layout=layout)


def abstract_params(cfg: ArchConfig, mesh=None, fsdp: bool = False) -> dict:
    """``{name: meta tensor}`` for every parameter of ``cfg``'s model, in
    ``named_parameters`` order: names, shapes and dtypes without drawing
    or allocating a weight (the JAX package's ``abstract_params``).  The
    model is built under a fake mode, so a 13B-parameter config costs its
    shapes only.  With a ``mesh``: this rank's blocks
    (``parallel.sharding.param_layout``; with ``fsdp``, also cut over the
    data axes, ``lm.fsdp_plan``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from .lm import _block_of, fsdp_plan
    with FakeTensorMode():
        model = LanguageModel(cfg, torch.Generator(device="cpu"))
    axis = sharding.model_axis(mesh)
    plan = fsdp_plan(cfg, mesh) if fsdp else {}
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if axis is not None:
            shape = sharding.param_layout(cfg, name, p.ndim, axis.size) \
                .shape(shape, axis.rank)
        blk = _block_of(plan, name)
        if blk is not None:
            shape = blk.shape(shape)
        out[name] = torch.empty(shape, dtype=p.dtype, device="meta")
    return out


def abstract_leaves(cfg: ArchConfig) -> list:
    """The reference's leaves (``convert.reference_leaves``) of
    :func:`abstract_params`: paths, stacked shapes and dtypes, as meta
    tensors."""
    from .convert import leaves_of
    return leaves_of(cfg, abstract_params(cfg).items())


def _concrete(shape, dtype, seed: int, device, vocab: int | None = None):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        values = rng.integers(0, vocab or 2, size=shape).astype(np.int32)
    else:
        values = rng.normal(0, 1, size=shape)
    return torch.as_tensor(values).to(device=device, dtype=dtype)


def abstract_caches(cfg: ArchConfig, batch: int, max_len: int,
                    mesh=None) -> list:
    """The decode caches of ``blocks.init_caches`` as meta tensors: one
    entry per layer, shapes and dtypes only (with a ``mesh``: this rank's
    blocks of the caches of a global batch of ``batch`` rows,
    ``sharding.cache_block``)."""
    if mesh is None:
        return blocks.init_caches(cfg, batch, max_len, torch.device("meta"))
    block = sharding.cache_block(cfg, mesh, batch, max_len)
    return blocks.init_caches(cfg, block.rows, max_len, torch.device("meta"),
                              sharding.model_axis(mesh), cache=block)


def decode_inputs(cfg: ArchConfig, shape: ShapeConfig, abstract: bool = True,
                  batch_override: int | None = None, device="cuda") -> tuple:
    """``(batch, caches, pos)`` operands for one decode step with a
    full-length cache — the ``decode_*`` / ``long_*`` cell contract.
    Abstract: meta tensors, ``pos`` a 0-d int32 one; else the zeroed caches
    on ``device`` and ``pos = seq_len - 1``."""
    if not shape.is_decode:
        raise ValueError(f"{shape.name} is a {shape.kind} shape, not decode")
    B = batch_override or shape.global_batch
    batch = make_inputs(cfg, shape, batch_override=batch_override,
                        device=device, abstract=abstract)
    if abstract:
        return (batch, abstract_caches(cfg, B, shape.seq_len),
                torch.empty((), dtype=torch.int32, device="meta"))
    return (batch, blocks.init_caches(cfg, B, shape.seq_len,
                                      torch_device(device)),
            shape.seq_len - 1)


def make_inputs(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                batch_override: int | None = None, device="cuda",
                abstract: bool = False) -> dict:
    """The training/prefill batch for one cell (``decode`` shapes get the
    single-token decode batch); ``abstract``: meta tensors of the same
    shapes and dtypes, drawn from nothing."""
    dev = torch.device("meta") if abstract else torch_device(device)
    B = batch_override or shape.global_batch
    S = 1 if shape.is_decode else shape.seq_len

    def ints(shp):
        if abstract:
            return torch.empty(shp, dtype=torch.int32, device=dev)
        return _concrete(shp, torch.int32, seed, dev, vocab=cfg.vocab_size)

    def floats(shp):
        if abstract:
            return torch.empty(shp, dtype=torch.bfloat16, device=dev)
        return _concrete(shp, torch.bfloat16, seed + 1, dev)

    if cfg.frontend == "vision":
        s_img = 0 if shape.is_decode else cfg.img_seq
        s_txt = S if shape.is_decode else S - cfg.img_seq
        batch = {"tokens": ints((B, s_txt)),
                 "image_embeds": floats((B, s_img, cfg.frontend_dim))}
        if shape.kind == "train":
            batch["targets"] = ints((B, s_txt))
        return batch
    if cfg.frontend == "audio":
        batch = {"frame_embeds": floats((B, S, cfg.frontend_dim))}
        if shape.kind == "train":
            batch["targets"] = ints((B, S, cfg.n_codebooks))
        return batch
    batch = {"tokens": ints((B, S))}
    if shape.kind == "train":
        batch["targets"] = ints((B, S))
    return batch
