"""Sharding rules for every parameter / batch / cache leaf: the JAX
package's ``parallel/sharding.py`` over a ``torch.distributed`` mesh.

Mesh-axis conventions:
  * ``data`` (+ ``pod`` on the multi-pod mesh) — batch data parallelism and
    ZeRO-1 optimizer-state sharding.
  * ``model`` — expert parallelism for MoE.  The reference also puts
    tensor parallelism of attention, the MLP, mamba and the vocabulary on
    it; the rules below name those dims, but in the port every leaf other
    than the experts is still whole on each model rank.

A spec is a tuple with one entry per leading dim of a leaf: an axis name,
a tuple of axis names (the dim split over their product, first axis
major), or ``None``; missing trailing entries are ``None`` (the
reference's ``PartitionSpec``, with its normalisation: a one-name tuple is
the name).  A mesh is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``).

The rules are keyed on the reference's leaf *names* and its stacked
shapes: :func:`param_pspecs` and the functions after it take the
reference's leaves (``models.convert.reference_leaves``, or any objects
with ``path``, ``shape`` and ``ndim``), a stacked leaf being one
``(n_blocks, ...)`` leaf, and return one spec per leaf.  On the port's
per-layer tensors a stacked leaf's spec loses its leading ``n_blocks``
entry (:func:`layer_spec`).
"""
from __future__ import annotations

import math

import torch

from .transport import all_gather

MODEL_AXIS = "model"
DATA_AXES_SINGLE = ("data",)
DATA_AXES_MULTI = ("pod", "data")


def spec(*entries) -> tuple:
    """A spec with the reference's normalisation: a one-name tuple is the
    name, an empty tuple ``None``."""
    def norm(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(norm(e) for e in entries)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return {str(n): int(s) for n, s in zip(mesh.mesh_dim_names, mesh.shape)}


def data_axes(mesh) -> tuple:
    return DATA_AXES_MULTI if "pod" in mesh.mesh_dim_names \
        else DATA_AXES_SINGLE


def axis_size(mesh, axes) -> int:
    """The product of the mesh axes ``axes``'s sizes."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def axes_group(mesh, axes):
    """The process group over the mesh axes ``axes``: one axis's own group,
    or, for several, the group of the flattened sub-mesh (made on first
    use; every rank must ask at the same point)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def axes_of(entry) -> tuple:
    """The mesh axes of a spec entry, as a tuple."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


# ------------------------------------------------------------------- params
_M = MODEL_AXIS

#: leaf name -> spec (leading ``n_blocks`` stack axis included where the
#: leaf lives in the stack).
_PARAM_RULES = {
    # embedding / heads
    "table": spec(_M, None),
    "lm_head": spec(None, _M),
    "lm_heads": spec(None, _M),
    "mm_proj": spec(),
    "frame_proj": spec(),
    # attention
    "wq": spec(None, None, _M),
    "wk": spec(None, None, _M),
    "wv": spec(None, None, _M),
    "bq": spec(None, _M),
    "bk": spec(None, _M),
    "bv": spec(None, _M),
    "wo": spec(None, _M, None),
    # dense MLP (3D: nb, d, f / nb, f, d) and MoE experts (4D: nb, E, ., .)
    "w_gate": spec(None, None, _M),
    "w_up": spec(None, None, _M),
    "w_down": spec(None, _M, None),
    "router": spec(),
    # mamba
    "in_proj": spec(None, None, _M),
    "conv_w": spec(None, None, _M),
    "conv_b": spec(None, _M),
    "x_proj": spec(None, _M, None),
    "dt_proj": spec(None, None, _M),
    "dt_bias": spec(None, _M),
    "A_log": spec(None, _M, None),
    "D": spec(None, _M),
    "out_proj": spec(None, _M, None),
}

_MOE_RULES = {          # 4D expert-stacked leaves: EP over the model axis
    "w_gate": spec(None, _M, None, None),
    "w_up": spec(None, _M, None, None),
    "w_down": spec(None, _M, None, None),
}


def _leaf_name(path) -> str:
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def param_pspecs(leaves) -> list:
    """One spec per leaf of the model's parameters."""
    def rule(leaf):
        name = _leaf_name(leaf.path)
        if leaf.ndim == 4 and name in _MOE_RULES:
            return _MOE_RULES[name]
        s = _PARAM_RULES.get(name)
        if s is None or len(s) > leaf.ndim:
            return spec()                   # norms, scalars, unknown leaves
        return s
    return [rule(leaf) for leaf in leaves]


def sanitize_pspecs(leaves, pspecs, mesh) -> list:
    """Drop mesh axes from dims they don't divide evenly (e.g. internvl2's
    vocab 92553 cannot shard 16 ways, so its embedding and head stay whole
    on that dim)."""
    def rule(leaf, s):
        dims = list(s) + [None] * (leaf.ndim - len(s))
        out = []
        for i, d in enumerate(dims):
            if d is None:
                out.append(None)
                continue
            n = axis_size(mesh, axes_of(d))
            out.append(d if leaf.shape[i] % n == 0 and leaf.shape[i] >= n
                       else None)
        return spec(*out)
    return [rule(leaf, s) for leaf, s in zip(leaves, pspecs)]


def zero1_pspecs(leaves, pspecs, mesh, axes=None) -> list:
    """ZeRO-1: additionally shard each leaf's largest *unsharded* dim over
    ``axes`` (default: the data axes — optimizer-state sharding).  Falls
    back to the plain spec when no dim is divisible.  With ``axes=(data...,
    model)`` this is the pure-FSDP layout."""
    dp = tuple(axes) if axes is not None else data_axes(mesh)
    n = axis_size(mesh, dp)

    def rule(leaf, s):
        dims = list(s) + [None] * (leaf.ndim - len(s))
        used = {a for d in dims for a in axes_of(d)}
        if used & set(dp):             # already data-sharded
            return spec(*dims)
        order = sorted(range(leaf.ndim), key=lambda i: -leaf.shape[i])
        for i in order:
            if dims[i] is None and leaf.shape[i] % n == 0 \
                    and leaf.shape[i] >= n:
                dims[i] = dp
                return spec(*dims)
        return spec(*dims)
    return [rule(leaf, s) for leaf, s in zip(leaves, pspecs)]


#: Per-device parameter bytes above which the params themselves are
#: dp-sharded (FSDP).
FSDP_THRESHOLD_BYTES = 1.0e9


def fsdp_pspecs(leaves, pspecs, mesh,
                threshold: float = FSDP_THRESHOLD_BYTES) -> tuple:
    """FSDP + TP hybrid: when the TP-sharded parameter bytes per device
    exceed ``threshold``, additionally shard every parameter over the data
    axes (ZeRO-1's dim-picking rule).  Returns ``(pspecs, used_fsdp)``."""
    tp = axis_sizes(mesh)[MODEL_AXIS]
    total = sum(math.prod(leaf.shape) * leaf.dtype.itemsize
                for leaf in leaves)
    if total / tp <= threshold:
        return pspecs, False
    return zero1_pspecs(leaves, pspecs, mesh), True


# -------------------------------------------------------------------- batch
def batch_pspecs(batch: dict, mesh) -> dict:
    """Batch leaves shard their leading (global-batch) dim over the data
    axes."""
    dp = data_axes(mesh)
    n = axis_size(mesh, dp)

    def rule(x):
        if x.ndim == 0:
            return spec()
        if x.shape[0] % n == 0:
            return spec(dp, *([None] * (x.ndim - 1)))
        return spec(*([None] * x.ndim))
    return {k: rule(x) for k, x in batch.items()}


# ------------------------------------------------------------------- caches
def cache_pspecs(caches, mesh) -> list:
    """Decode-cache sharding policy, over the port's per-layer caches
    (``blocks.init_caches``: the reference's rules without the leading
    ``n_blocks`` dim).

    * attention k/v (B, L, H, D): batch over the data axes when divisible,
      otherwise a *sequence-parallel cache* — L over the data axes; heads
      over ``model`` when divisible, otherwise L additionally over
      ``model``.
    * mamba conv/ssm states (B, ...): batch over the data axes when
      divisible; the channel dim over ``model``.
    """
    dp = data_axes(mesh)
    ndp = axis_size(mesh, dp)
    nm = axis_sizes(mesh)[MODEL_AXIS]

    def attn_rule(x):                         # (B, L, H, D)
        B, L, H, _ = x.shape
        s = [None, None, None, None]
        seq_axes = []
        if B % ndp == 0 and B >= ndp:
            s[0] = dp
        else:
            seq_axes.extend(dp)
        if H % nm == 0 and H >= nm:
            s[2] = MODEL_AXIS
        else:
            seq_axes.append(MODEL_AXIS)
        if seq_axes and L % axis_size(mesh, tuple(seq_axes)) == 0:
            s[1] = tuple(seq_axes)
        return spec(*s)

    def state_rule(x):                        # (B, ...) mamba states
        s = [None] * x.ndim
        if x.shape[0] % ndp == 0 and x.shape[0] >= ndp:
            s[0] = dp
        # channel (d_inner) dim: conv (B, K-1, di) -> last; ssm (B, di, N)
        # -> second-to-last (N is small)
        ch = x.ndim - 1 if x.shape[-1] > 64 else x.ndim - 2
        if ch >= 1 and x.shape[ch] % nm == 0 and x.shape[ch] >= nm:
            s[ch] = MODEL_AXIS
        return spec(*s)

    def rule(c):
        if c is None:
            return None
        if isinstance(c, dict):
            return {k: attn_rule(v) for k, v in c.items()}
        return type(c)(*(state_rule(x) for x in c))
    return [rule(c) for c in caches]


# ----------------------------------------------------------- the port's use
def layer_spec(leaf, s) -> tuple:
    """The spec of each port tensor of ``leaf``: a stacked leaf's spec
    without its leading ``n_blocks`` entry."""
    return tuple(s[1:]) if leaf.path[0] == "stack" else tuple(s)


def placements(s, mesh) -> tuple:
    """DTensor placements of a spec: ``Shard(dim)`` on each mesh dim that
    splits a tensor dim, ``Replicate()`` on the others (the counterpart of
    the reference's ``named``)."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {a: i for i, e in enumerate(s) for a in axes_of(e)}
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


def named(mesh, specs) -> list:
    """The placements of every spec of ``specs`` (the reference's
    ``named``, which maps a spec tree to shardings)."""
    return [placements(s, mesh) for s in specs]


def block_index(entry, mesh, coord) -> tuple:
    """(index, count) of this rank's block along a dim split by ``entry``:
    the rank's coordinates on the entry's axes, first axis major."""
    sizes = axis_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    idx, n = 0, 1
    for a in axes_of(entry):
        idx = idx * sizes[a] + coord[names.index(a)]
        n *= sizes[a]
    return idx, n


def local_shard(t: torch.Tensor, s, mesh, coord=None) -> torch.Tensor:
    """The block of ``t`` that this rank (or the rank at mesh coordinates
    ``coord``) holds under spec ``s``: a view, contiguous blocks in rank
    order along each split dim."""
    coord = mesh.get_coordinate() if coord is None else coord
    for dim, entry in enumerate(s):
        if entry is None:
            continue
        idx, n = block_index(entry, mesh, coord)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"{n} ways ({entry})")
        size = t.shape[dim] // n
        t = t.narrow(dim, idx * size, size)
    return t


def gather(shard: torch.Tensor, s, mesh) -> torch.Tensor:
    """The whole tensor from each rank's block (:func:`local_shard`): an
    all-gather over the mesh axes that split each dim, the last axis of an
    entry first.  Every rank of the mesh must call it."""
    t = shard
    for dim, entry in enumerate(s):
        for a in reversed(axes_of(entry)):
            parts = all_gather(t, mesh.get_group(a))
            t = torch.cat(list(parts.unbind(0)), dim=dim)
    return t
