"""Load the JAX package's parameters and decode caches into the port's
model.

The reference's parameter tree is nested dicts with the stack as a list,
one entry per pattern position, each stacked along a leading ``n_blocks``
axis; the port keeps its layers in depth order, so layer ``i * P + pos``
(``P`` = the pattern's length) is the reference's block ``i``, position
``pos``.  Leaves come as numpy arrays (``np.asarray`` of the JAX arrays);
bfloat16 leaves, which numpy holds as ``ml_dtypes.bfloat16`` and
``torch.from_numpy`` refuses, are reinterpreted through ``uint16``.
"""
from __future__ import annotations

import numpy as np
import torch

from .blocks import layer_pattern, n_blocks
from .config import ArchConfig
from .mamba import MambaState


def to_tensor(a) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor of the same dtype and
    bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = tree


def params_from_jax(cfg: ArchConfig, tree) -> dict:
    """The reference's parameter tree as a state dict of
    ``LanguageModel(cfg, ...)`` (load it with ``load_state_dict``)."""
    flat = {}
    for key, value in tree.items():
        if key != "stack":
            _flatten(value, f"{key}.", flat)
    P, nb = len(layer_pattern(cfg)), n_blocks(cfg)
    if len(tree["stack"]) != P:
        raise ValueError(f"{cfg.name}: the stack has {len(tree['stack'])} "
                         f"pattern positions, the config {P}")
    for pos, stacked in enumerate(tree["stack"]):
        leaves = {}
        _flatten(stacked, "", leaves)
        for name, leaf in leaves.items():
            leaf = np.asarray(leaf)
            if leaf.shape[0] != nb:
                raise ValueError(f"{cfg.name}: stack[{pos}].{name} has "
                                 f"{leaf.shape[0]} blocks, the config {nb}")
            for i in range(nb):
                flat[f"stack.{i * P + pos}.{name}"] = leaf[i]
    return {k: to_tensor(v) for k, v in flat.items()}


def caches_from_jax(cfg: ArchConfig, caches) -> list:
    """The reference's decode caches (one entry per pattern position,
    stacked along ``n_blocks``: ``{"k", "v"}`` dicts, ``MambaState``s or
    ``None``; numpy leaves) as the port's per-layer list."""
    P, nb = len(layer_pattern(cfg)), n_blocks(cfg)
    if len(caches) != P:
        raise ValueError(f"{cfg.name}: {len(caches)} cache entries, the "
                         f"config has {P} pattern positions")
    out = [None] * (P * nb)
    for pos, c in enumerate(caches):
        for i in range(nb):
            if c is None:
                continue
            if isinstance(c, dict):
                out[i * P + pos] = {k: to_tensor(np.asarray(v)[i])
                                    for k, v in c.items()}
            else:
                out[i * P + pos] = MambaState(
                    conv=to_tensor(np.asarray(c[0])[i]),
                    ssm=to_tensor(np.asarray(c[1])[i]))
    return out
