"""The JAX package's parameter tree and the port's model, both ways, and
the reference's decode caches into the port's.

The reference's parameter tree is nested dicts with the stack as a list,
one entry per pattern position, each stacked along a leading ``n_blocks``
axis; the port keeps its layers in depth order, so layer ``i * P + pos``
(``P`` = the pattern's length) is the reference's block ``i``, position
``pos``.  Leaves come as numpy arrays (``np.asarray`` of the JAX arrays);
bfloat16 leaves, which numpy holds as ``ml_dtypes.bfloat16`` and
``torch.from_numpy`` refuses, are reinterpreted through ``uint16``.

The training half works on the reference's leaves, not on the port's
tensors (:func:`reference_leaves`): a stacked leaf is one ``(n_blocks,
...)`` array, so the optimizer's weight decay (``ndim >= 2``), Adafactor's
row and column moments and the int8 scale of gradient compression see the
shapes the reference sees, and a checkpoint holds one file per leaf.
:func:`flatten` / :func:`nest` walk such trees in ``jax.tree`` order (dict
keys sorted, list entries in order).

Under tensor parallelism (a model built with a ``mesh`` whose ``model``
axis is R > 1) a leaf's tensors are this rank's blocks: ``Leaf.layout``
(``parallel.sharding.param_layout``) says which, ``Leaf.whole_shape`` is
the reference's shape, ``Leaf.take`` cuts a whole value to the block and
``Leaf.gather`` puts the ranks' blocks back together (a collective).
``params_from_jax`` / ``caches_from_jax`` with a ``mesh`` carry the
reference's whole leaves into a rank's blocks, ``params_to_jax`` gathers
them back.  Under FSDP (a model built with ``fsdp=True``) a leaf's tensors
are also cut over the data axes (``Leaf.fsdp``, a
``parallel.sharding.FsdpBlock`` of the executed ``model`` block): ``take``
cuts both, ``gather`` gathers over the data axes, then over ``model``.

A config with fields only the port has (``ArchConfig.port_only``) has no
JAX counterpart: every conversion of its parameters or caches raises
(:func:`need_reference`).  Such a model's parameters go to its plain
float32 reference instead (:func:`plain_weights`, :func:`plain_cfg`;
``models.ref_granite``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel import sharding, transport
from .blocks import layer_pattern, n_blocks
from .config import ArchConfig
from .mamba import MambaState


def need_reference(cfg: ArchConfig) -> None:
    """Raise for a config that the JAX package cannot hold."""
    extra = cfg.port_only()
    if extra:
        raise ValueError(
            f"{cfg.name} has no JAX counterpart: the JAX package lacks "
            f"{', '.join(extra)}; hold it to its plain reference "
            "(convert.plain_weights) instead")


def plain_weights(model) -> dict:
    """The model's tensors as a plain reference takes them (the layout of
    ``models.ref_granite``): ``embed`` (the tied table), ``final_norm`` and
    each layer's tensors under their names in the layer
    (``"mamba2.in_proj"``, ``"moe.w_gate"``), the tensors themselves, not
    copies."""
    return {"embed": model.embed["table"], "final_norm": model.final_norm,
            "layers": [dict(layer.named_parameters())
                       for layer in model.stack]}


def plain_cfg(cfg: ArchConfig) -> dict:
    """The sizes and multipliers a plain reference reads."""
    return {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim,
            "attention_multiplier": cfg.attn_scale
            or cfg.resolved_head_dim ** -0.5,
            "ssm_heads": cfg.ssm_heads, "ssm_head_dim": cfg.ssm_head_dim,
            "ssm_groups": cfg.ssm_groups, "ssm_state": cfg.ssm_state,
            "experts_per_token": cfg.experts_per_token, "eps": cfg.norm_eps,
            "embedding_multiplier": cfg.embedding_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "logits_scaling": cfg.logits_scaling}


def to_tensor(a) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor of the same dtype and
    bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host; a bfloat16 tensor gives its bits as
    ``uint16`` (numpy has no bfloat16 without ``ml_dtypes``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def flatten(tree) -> list:
    """``[(path, leaf)]`` of a nested dict / list / tuple tree in
    ``jax.tree`` flatten order: dict keys sorted, sequences in order.  A
    path is a tuple of dict keys and sequence indices."""
    if isinstance(tree, dict):
        return [((k, *path), leaf) for k in sorted(tree)
                for path, leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [((i, *path), leaf) for i, sub in enumerate(tree)
                for path, leaf in flatten(sub)]
    return [((), tree)]


def nest(pairs) -> dict:
    """The tree of ``(path, leaf)`` pairs (the inverse of :func:`flatten`):
    a level whose keys are the indices 0..n-1 becomes a list."""
    root: dict = {}
    for path, leaf in pairs:
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            if sorted(out) != list(range(len(out))):
                raise ValueError(f"sequence indices {sorted(out)} have gaps")
            return [out[i] for i in range(len(out))]
        return out
    return listify(root)


@dataclass(frozen=True, eq=False)
class Leaf:
    """One leaf of the reference's parameter tree and the port tensors that
    make it up: block ``i`` of a stacked leaf (``path[0] == "stack"``) is
    ``tensors[i]``; any other leaf is one tensor.  ``layout`` is the
    executed layout of each port tensor over the ``model`` axis (``axis``,
    ``None`` when R is 1): the tensors are rank ``axis.rank``'s blocks."""

    path: tuple
    tensors: tuple
    layout: sharding.Layout = sharding.WHOLE
    axis: sharding.ModelAxis | None = None
    fsdp: sharding.FsdpBlock | None = None

    @property
    def stacked(self) -> bool:
        return self.path[0] == "stack"

    @property
    def shape(self) -> tuple:
        """The shape of this rank's value of the leaf."""
        t = self.tensors[0]
        return (len(self.tensors), *t.shape) if self.stacked \
            else tuple(t.shape)

    @property
    def whole_shape(self) -> tuple:
        """The reference leaf's shape."""
        shape = self.shape
        if self.fsdp is not None:
            shape = self.fsdp.whole_shape(shape, int(self.stacked))
        return self.layout.whole_shape(shape, int(self.stacked))

    def take(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of a tensor of the whole leaf's shape."""
        if self.axis is not None:
            whole = self.layout.take(whole, self.axis.rank,
                                     int(self.stacked))
        if self.fsdp is not None:
            whole = self.fsdp.take(whole, int(self.stacked))
        return whole

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's block ``x``: one all-gather over
        the data axes where the leaf has an FSDP block, then one over the
        ``model`` group where it is split (every rank calls it)."""
        if self.fsdp is not None:
            x = self.fsdp.gather(x, int(self.stacked))
        if self.axis is None:
            return x
        return self.layout.gather(x, self.axis, int(self.stacked))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensors[0].dtype

    @property
    def device(self) -> torch.device:
        return self.tensors[0].device

    def parts(self, x) -> list:
        """A tensor of the leaf's shape as one view per port tensor."""
        return list(x.unbind(0)) if self.stacked else [x]

    def stack(self, parts) -> torch.Tensor:
        """One tensor per port tensor (e.g. their gradients) as one tensor
        of the leaf's shape."""
        return torch.stack(list(parts)) if self.stacked else parts[0]

    def value(self) -> torch.Tensor:
        """The leaf's values (detached; a new tensor when stacked)."""
        return self.stack([t.detach() for t in self.tensors])

    @torch.no_grad()
    def assign(self, value: torch.Tensor) -> None:
        """Write ``value`` (the leaf's shape) into the port tensors, cast to
        their dtype."""
        if tuple(value.shape) != self.shape:
            raise ValueError(f"{self.name}: value of shape "
                             f"{tuple(value.shape)}, leaf {self.shape}")
        for t, v in zip(self.tensors, self.parts(value)):
            if not t.is_set_to(v):
                t.copy_(v)

    @property
    def name(self) -> str:
        return "/".join(map(str, self.path))


def reference_leaves(model) -> list:
    """The model's parameters as the reference's leaves, in ``jax.tree``
    flatten order (the order of ``jax.tree.leaves(params)``); under tensor
    parallelism, this rank's blocks with their layout."""
    return leaves_of(model.cfg, model.named_parameters(),
                     getattr(model, "tp", None))


def leaves_of(cfg: ArchConfig, named, axis=None) -> list:
    """:func:`reference_leaves` of ``(name, tensor)`` pairs named as the
    model's parameters (e.g. ``factory.abstract_params(cfg).items()``);
    ``axis``: the ``model`` axis whose rank's blocks they are."""
    need_reference(cfg)
    P = len(layer_pattern(cfg))
    groups: dict = {}
    layouts: dict = {}
    blocks_: dict = {}
    R = 1 if axis is None else axis.size
    for name, t in named:
        key = leaf_path(cfg, name)
        lay = sharding.param_layout(cfg, name, t.ndim, R)
        if key[0] == "stack":
            groups.setdefault(key, {})[int(name.split(".")[1]) // P] = t
        else:
            groups[key] = {0: t}
        layouts[key] = lay
        blocks_[key] = getattr(t, "fsdp", None)
    return [Leaf(path, tuple(blocks[i] for i in range(len(blocks))),
                 layouts[path], axis, blocks_[path])
            for path, blocks in sorted(groups.items())]


def leaf_path(cfg: ArchConfig, name: str) -> tuple:
    """The reference leaf's path of the port parameter ``name``: layer
    ``i``'s ``stack.i.attn.wq`` is ``("stack", i % P, "attn", "wq")``."""
    key = tuple(name.split("."))
    if key[0] == "stack":
        return ("stack", int(key[1]) % len(layer_pattern(cfg)), *key[2:])
    return key


def params_to_jax(model) -> dict:
    """The model's parameters as the reference's nested tree of numpy
    arrays (the inverse of :func:`params_from_jax`; bfloat16 leaves as
    their ``uint16`` bits, see :func:`to_numpy`).  Under tensor
    parallelism every leaf is gathered whole: every rank of the ``model``
    group calls it."""
    return nest((leaf.path, to_numpy(leaf.gather(leaf.value())))
                for leaf in reference_leaves(model))


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = tree


def params_from_jax(cfg: ArchConfig, tree, mesh=None,
                    fsdp: bool = False) -> dict:
    """The reference's parameter tree as a state dict of
    ``LanguageModel(cfg, ...)`` (load it with ``load_state_dict``); with a
    ``mesh``, of ``LanguageModel(cfg, ..., mesh=mesh, fsdp=fsdp)``: each
    tensor this rank's block."""
    need_reference(cfg)
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
    axis = sharding.model_axis(mesh)
    from .lm import _block_of, fsdp_plan
    plan = {}
    if fsdp:
        plan = fsdp_plan(cfg, mesh)
    out = {}
    for k, v in flat.items():
        t = to_tensor(v)
        if axis is not None:
            t = sharding.param_layout(cfg, k, t.ndim, axis.size) \
                .take(t, axis.rank)
        blk = _block_of(plan, k)
        if blk is not None:
            t = blk.take(t)
        out[k] = t.clone() if axis is not None or plan else t
    return out


def caches_from_jax(cfg: ArchConfig, caches, mesh=None) -> list:
    """The reference's decode caches (one entry per pattern position,
    stacked along ``n_blocks``: ``{"k", "v"}`` dicts, ``MambaState``s or
    ``None``; numpy leaves, the global batch over the whole length) as the
    port's per-layer list; with a ``mesh``, this rank's block of each: the
    attention caches' ``sharding.cache_block`` over the caches' batch and
    length, the mamba states' rows of it and channels
    (``sharding.state_layout``)."""
    need_reference(cfg)
    P, nb = len(layer_pattern(cfg)), n_blocks(cfg)
    if len(caches) != P:
        raise ValueError(f"{cfg.name}: {len(caches)} cache entries, the "
                         f"config has {P} pattern positions")
    axis = sharding.model_axis(mesh)
    block = None
    if mesh is not None:
        held = [c for c in caches if c is not None]
        attn = [np.shape(c["k"]) for c in held if isinstance(c, dict)]
        block = sharding.cache_block(cfg, mesh, np.shape(held[0][
            "k" if isinstance(held[0], dict) else 0])[1],
            attn[0][2] if attn else 0)

    def cut(x, kind, which):
        t = to_tensor(x)
        if block is None:
            return t
        t = t.narrow(0, block.row0, block.rows)
        if kind == "attn":
            a = block.heads[0]
            t = t.narrow(1, block.lo, block.length).narrow(
                2, a, len(block.heads))
        elif axis is not None:
            t = sharding.state_layout(cfg, which, axis.size).take(t,
                                                                  axis.rank)
        return t.clone()

    out = [None] * (P * nb)
    for pos, c in enumerate(caches):
        for i in range(nb):
            if c is None:
                continue
            if isinstance(c, dict):
                out[i * P + pos] = {k: cut(np.asarray(v)[i], "attn", k)
                                    for k, v in c.items()}
            else:
                out[i * P + pos] = MambaState(
                    conv=cut(np.asarray(c[0])[i], "mamba", "conv"),
                    ssm=cut(np.asarray(c[1])[i], "mamba", "ssm"))
    return out


def caches_to_jax(cfg: ArchConfig, caches, mesh=None, cache=None) -> list:
    """The inverse of :func:`caches_from_jax`: the port's per-layer decode
    caches as the reference's (one entry per pattern position, each leaf
    stacked along ``n_blocks``, numpy; bfloat16 as its bits), every rank's
    blocks gathered whole: the attention caches' positions over the L
    group of ``cache`` (the rank's ``sharding.CacheBlock``), their kv heads
    over ``model`` where the rank holds its own, the mamba states'
    channels over ``model``, and the rows over the data axes where the
    batch is split.  With a ``mesh`` every rank of it calls it."""
    need_reference(cfg)
    if mesh is not None and cache is None:
        raise ValueError("caches_to_jax over a mesh needs the rank's "
                         "CacheBlock (LanguageModel.cache_block)")
    axis = sharding.model_axis(mesh)

    def whole(t, kind, which):
        if mesh is None:
            return t
        if kind == "attn":
            if cache.split:
                t = transport.all_gather_dim(t, cache.group, 1)
            if axis is not None and len(cache.heads) < cfg.n_kv_heads:
                t = sharding.Layout(2, tuple(
                    sharding.head_split(cfg, axis.size, j).kv
                    for j in range(axis.size)), cfg.n_kv_heads).gather(
                        t, axis)
        elif axis is not None:
            t = sharding.state_layout(cfg, which, axis.size).gather(t, axis)
        if cache.rows < cache.batch:
            dp = sharding.present_data_axes(mesh)
            t = transport.all_gather_dim(t, sharding.axes_group(mesh, dp), 0)
        return t

    P = len(layer_pattern(cfg))
    out = []
    for pos in range(P):
        layers_ = caches[pos::P]
        if layers_[0] is None:
            out.append(None)
        elif isinstance(layers_[0], dict):
            out.append({k: np.stack([to_numpy(whole(c[k], "attn", k))
                                     for c in layers_])
                        for k in layers_[0]})
        else:
            out.append(MambaState(*(np.stack([to_numpy(whole(
                c[j], "mamba", which)) for c in layers_])
                for j, which in enumerate(("conv", "ssm")))))
    return out

