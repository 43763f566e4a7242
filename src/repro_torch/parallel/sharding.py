"""Sharding rules for every parameter / batch / cache leaf: the JAX
package's ``parallel/sharding.py`` over a ``torch.distributed`` mesh, and
the layout the port executes under them.

Mesh-axis conventions:
  * ``data`` (+ ``pod`` on the multi-pod mesh) — batch data parallelism and
    ZeRO-1 optimizer-state sharding.
  * ``model`` — Megatron-style tensor parallelism of attention (by query
    head), the dense MLP (by ``d_ff`` column), mamba (by ``d_inner``
    channel) and the vocabulary (embedding rows, head columns), and expert
    parallelism for MoE: the reference's "tp" layout.

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

The executed layout (:func:`param_layout`, :class:`Layout`): what each of
the R ranks of the ``model`` axis holds of every port tensor.  It is the
block of the sanitized spec (``sanitize_pspecs(param_pspecs)``) except
where that block would cut a head, a ``[x | z]`` pair or a codebook, and
the ranks would then not compute the model's function:

=================  ==========================  ===============================
leaf               the spec's block            the executed block, and why
=================  ==========================  ===============================
``wk wv bk bv``    ``Hkv * D / R`` columns:    the kv heads this rank's query
(Hkv % R != 0)     mid-head when Hkv < R or    heads read (two ranks may hold
                   Hkv % R != 0                the same head); where the query
                                               heads do not cover whole kv
                                               groups, k / v are repeated to
                                               one per query head (the
                                               reference's
                                               ``_expand_and_pin_heads``)
``in_proj``        ``2 * d_inner / R``         columns ``c`` of ``x`` and the
                   contiguous columns: rank 0  same ``c`` of ``z``: a
                   would hold ``x`` only       channel's gate stays with it
``lm_heads``       ``K * V / R`` contiguous    each codebook's vocab block:
(K codebooks)      columns, across codebooks   the cross-entropy is per
                                               codebook
any leaf of a      its dim split R ways        whole on every rank: the heads
module whose       where the dim divides       (``padded_heads``), channels
heads, channels                                (``d_inner``) or vocabulary
or vocabulary do                               (codebook ``V``) do not split
not split over R                               over R, so the module runs
                                               whole, with no collective
decode caches      ``cache_pspecs``: L over    the kv heads the rank's query
(attention, when   ``model`` (and the data     heads read, over the whole
Hkv % R != 0 and   axes where the batch does   length: where L does not divide
L does not split   not split) where it         that group, the spec leaves L
over the L group)  divides, else whole, every  whole, and a rank holding every
                   kv head on every rank       kv head would gather them a token
=================  ==========================  ===============================

The fused ``wqkv`` / ``bqkv`` / ``w_gateup`` have no rule, so their spec
and their block are the whole leaf; each rank multiplies by its own
columns of it.  :func:`departures` names, for a model's leaves, the ones
whose executed block differs from the spec's.

The decode caches (:class:`CacheBlock`, :func:`cache_block`): under
``"tp"`` a rank holds the block of ``cache_pspecs`` over the global
batch, as the reference's dry run shards them.  Its rows are the batch's
block over the data axes where the batch divides them, else all of it
(the same rows on every data rank); its kv heads are its own ``Hkv / R``
where they split over ``model``; and L is split over the L group, the
data axes where the batch does not divide them and ``model`` where the
kv heads do not, where L divides that group's size.  A rank whose block
of L holds every kv head computes a float32 partial softmax of every
query head over its positions, and one collective over the L group
combines them (``models.layers``): an all-to-all by head where L is
split over ``model`` (each rank receives only its own query heads'
partials), else an all-gather.  Where L does not divide the group the
spec leaves it whole, and the rank holds the kv heads its query heads
read (the last row above).  Mamba states keep the spec's channel split
(:func:`state_layout`) and the rows of the attention caches.

FSDP (:func:`fsdp_specs`, :class:`FsdpBlock`): with FSDP on, a rank holds
of each port tensor the block of the data-axes entry of
``sanitize_pspecs(fsdp_pspecs(param_pspecs))`` (the reference's order,
``launch/dryrun.py``), cut from its executed ``model`` block above; the
layers gather it whole over the data axes where they use it
(``parallel.fsdp``).  One departure:

=================  ==========================  ===============================
leaf               the spec's block            the executed block, and why
=================  ==========================  ===============================
a stacked leaf     ``n_blocks / n`` whole      whole over the data axes: the
whose data entry   layers (a vector whose      port holds one tensor a layer,
is on the stack    only free dim is the        and a layer held by one data
dim                stack: ``bq``, ``D``, ...)  rank is no block to gather; its
                                               gradient is all-reduced, its
                                               moments are the spec's block
                                               (ZeRO-1)
=================  ==========================  ===============================

:func:`fsdp_departures` names those leaves.

The ``"fsdp_seq"`` layout (:func:`fsdp_seq_specs`, :class:`SeqAxis`):
pure FSDP over every rank (data x model), no tensor parallelism, and the
sequence split over ``model``: each ``model`` rank holds a contiguous
block of ``L / R`` positions of every row of its data shard.  Every
parameter is the block of ``sanitize(zero1_pspecs(P()-tree, axes=data +
("model",)))`` (the reference's order), gathered whole over all ranks where
it is used; its gradient is reduce-scattered over all ranks.  Its
departures:

=================  ==========================  ===============================
leaf / state       the spec's block            the executed block, and why
=================  ==========================  ===============================
a stacked leaf     ``n_blocks / n`` whole      whole on every rank, as under
whose entry is     layers                      FSDP above; its gradient is
on the stack dim                               summed over ``model`` (each
                                               rank's is of its positions)
                                               and all-reduced over the data
                                               axes
attention decode   ``cache_pspecs``: heads     L over ``model``: contiguous
caches (Hkv % R    over ``model`` (as          blocks of ``max_len / R``
== 0)              ``"tp"`` holds them,        positions a rank, the bytes a
                   :class:`CacheBlock`)        rank holds equal (a sequence-
                                               sharded rank holds every head
                                               of its positions)
mamba decode       the channel dim over        whole on every ``model`` rank
state              ``model``                   (rank R-1's, after the prompt;
                                               small): decode runs the token
                                               whole on every rank
MoE                EP over ``model``           the experts gathered whole;
(``moe_impl=                                   ``"ep_local"`` raises (tokens
"ep_local"``)                                  route with ``"scatter"`` or
                                               ``"dense"``, globally)
``prefill(...,     the bucketed prefill's      raises: no engine runs this
last_index=)``     last real position          layout
=================  ==========================  ===============================

:func:`fsdp_seq_departures` names the leaves of the first row.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import torch

from . import transport
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


# ------------------------------------------------------ the executed layout
@dataclass(frozen=True)
class ModelAxis:
    """The ``model`` axis of a mesh as the layers use it: its process
    group, its size R and this rank's coordinate on it."""

    group: object
    size: int
    rank: int


def model_axis(mesh) -> ModelAxis | None:
    """The ``model`` axis of ``mesh``; ``None`` without a mesh or with a
    ``model`` axis of 1 (every leaf whole)."""
    if mesh is None or MODEL_AXIS not in mesh.mesh_dim_names:
        return None
    R = axis_sizes(mesh)[MODEL_AXIS]
    if R == 1:
        return None
    return ModelAxis(mesh.get_group(MODEL_AXIS), R,
                     mesh.get_local_rank(MODEL_AXIS))


@dataclass(frozen=True)
class Layout:
    """One port tensor over the R ranks of the ``model`` axis: along
    ``dim`` rank ``j`` holds the entries ``index[j]`` of the whole dim (of
    ``size`` entries), in that order; ``dim is None``: every rank holds the
    whole tensor.  An entry may be held by several ranks (a kv head two
    ranks' query heads read)."""

    dim: int | None = None
    index: tuple = ()
    size: int = 0

    @property
    def whole(self) -> bool:
        return self.dim is None

    @functools.cached_property
    def counts(self) -> tuple:
        """How many ranks hold each entry of the whole dim."""
        c = [0] * self.size
        for idx in self.index:
            for i in idx:
                c[i] += 1
        return tuple(c)

    @property
    def shared(self) -> bool:
        return any(c > 1 for c in self.counts)

    def _index(self, r: int, device) -> torch.Tensor:
        return torch.tensor(self.index[r], dtype=torch.long, device=device)

    def _range(self, r: int):
        """``(start, length)`` when rank ``r``'s entries are contiguous."""
        idx = self.index[r]
        if idx and list(idx) == list(range(idx[0], idx[0] + len(idx))):
            return idx[0], len(idx)
        return None

    def take(self, t: torch.Tensor, r: int, offset: int = 0) -> torch.Tensor:
        """Rank ``r``'s block of the whole tensor ``t`` (``offset``: leading
        dims before the port tensor's, 1 for a stacked leaf): a view when
        its entries are contiguous."""
        if self.whole:
            return t
        dim = self.dim + offset
        rng = self._range(r)
        if rng is not None:
            return t.narrow(dim, *rng)
        return t.index_select(dim, self._index(r, t.device))

    def shape(self, whole_shape, r: int, offset: int = 0) -> tuple:
        shape = list(whole_shape)
        if not self.whole:
            shape[self.dim + offset] = len(self.index[r])
        return tuple(shape)

    def whole_shape(self, shape, offset: int = 0) -> tuple:
        shape = list(shape)
        if not self.whole:
            shape[self.dim + offset] = self.size
        return tuple(shape)

    def weights(self, r: int, ndim: int, offset: int = 0,
                device=None) -> torch.Tensor:
        """1 / (the ranks holding it) for each of rank ``r``'s entries,
        shaped to broadcast along the dim: a sum over the ranks of a
        weighted sum counts every whole entry once."""
        w = torch.tensor([1.0 / self.counts[i] for i in self.index[r]],
                         dtype=torch.float32, device=device)
        shape = [1] * ndim
        shape[self.dim + offset] = -1
        return w.reshape(shape)

    def gather(self, t: torch.Tensor, axis: ModelAxis,
               offset: int = 0) -> torch.Tensor:
        """The whole tensor from each rank's block ``t``: one all-gather
        over the ``model`` group (blocks padded to the longest), then every
        block written at its entries.  Every rank of the group calls it."""
        if self.whole:
            return t
        dim = self.dim + offset
        longest = max(len(i) for i in self.index)
        pad = list(t.shape)
        pad[dim] = longest - t.shape[dim]
        padded = torch.cat([t, t.new_zeros(pad)], dim) if pad[dim] else t
        parts = all_gather(padded, axis.group)
        shape = list(t.shape)
        shape[dim] = self.size
        out = t.new_zeros(shape)
        for j, part in enumerate(parts.unbind(0)):
            n = len(self.index[j])
            out.index_copy_(dim, self._index(j, t.device),
                            part.narrow(dim, 0, n))
        return out


WHOLE = Layout()


def _even(n: int, R: int) -> tuple:
    """R contiguous equal blocks of ``range(n)``."""
    return tuple(tuple(range(j * n // R, (j + 1) * n // R)) for j in range(R))


def _units(blocks, width: int) -> tuple:
    """Each rank's unit indices (heads) as entries of width ``width``."""
    return tuple(tuple(u * width + i for u in units for i in range(width))
                 for units in blocks)


@dataclass(frozen=True)
class Heads:
    """One rank's attention heads: query heads ``[q0, q0 + nq)`` of the
    padded heads, the kv heads ``kv`` they read, and, where those query
    heads do not cover whole kv groups, ``expand``: the position in ``kv``
    of each query head's kv head (k / v are repeated to one per query
    head, the reference's ``_expand_and_pin_heads``)."""

    q0: int
    nq: int
    kv: tuple
    expand: tuple | None


@functools.lru_cache(maxsize=None)
def head_split(cfg, R: int, r: int) -> Heads | None:
    """Rank ``r``'s heads of ``R``, or ``None`` when the padded query heads
    do not split R ways (attention then runs whole on every rank)."""
    nq_pad, nkv = cfg.padded_heads, max(cfg.n_kv_heads, 1)
    if R == 1 or not cfg.n_heads or nq_pad % R:
        return None
    g = nq_pad // nkv                       # group-major: head h reads h // g
    nq = nq_pad // R
    q0 = r * nq
    kv_of = [(q0 + j) // g for j in range(nq)]
    kv = tuple(sorted(set(kv_of)))
    per = [kv_of.count(h) for h in kv]
    expand = None if len(set(per)) == 1 else tuple(kv.index(h)
                                                    for h in kv_of)
    return Heads(q0, nq, kv, expand)


def qkv_columns(cfg, heads: Heads) -> list:
    """The columns of the fused ``wqkv`` ``[q | k | v]`` a rank multiplies
    by."""
    hd = cfg.resolved_head_dim
    nq_pad, nkv = cfg.padded_heads, cfg.n_kv_heads
    q = [heads.q0 * hd + i for i in range(heads.nq * hd)]
    kv = [h * hd + i for h in heads.kv for i in range(hd)]
    return q + [nq_pad * hd + c for c in kv] \
        + [(nq_pad + nkv) * hd + c for c in kv]


def channel_split(n: int, R: int) -> tuple | None:
    """Each rank's ``(start, length)`` of ``n`` channels, or ``None`` when
    they do not split R ways."""
    if R == 1 or n % R:
        return None
    return tuple((j * n // R, n // R) for j in range(R))


_ATTN_COLS = {"wq": (1, "q"), "bq": (0, "q"), "wo": (0, "q"),
              "wk": (1, "kv"), "wv": (1, "kv"), "bk": (0, "kv"),
              "bv": (0, "kv")}
_MAMBA_DIM = {"conv_w": 1, "conv_b": 0, "x_proj": 0, "dt_proj": 1,
              "dt_bias": 0, "A_log": 0, "D": 0, "out_proj": 0}


@functools.lru_cache(maxsize=None)
def param_layout(cfg, name: str, ndim: int, R: int) -> Layout:
    """The executed :class:`Layout` of the port tensor ``name`` (a
    parameter name of the model, ``"stack.3.attn.wk"``, or its last two
    parts, ``"attn.wk"``) of ``ndim`` dims over a ``model`` axis of R."""
    if R == 1:
        return WHOLE
    parts = name.split(".")
    leaf = parts[-1]
    kind = parts[-2] if len(parts) > 1 else ""
    if kind == "attn" and leaf in _ATTN_COLS:
        heads = [head_split(cfg, R, r) for r in range(R)]
        if heads[0] is None:
            return WHOLE
        dim, which = _ATTN_COLS[leaf]
        hd = cfg.resolved_head_dim
        if which == "q":
            units = [range(h.q0, h.q0 + h.nq) for h in heads]
            return Layout(dim, _units(units, hd), cfg.padded_heads * hd)
        return Layout(dim, _units([h.kv for h in heads], hd),
                      cfg.n_kv_heads * hd)
    if kind == "mlp" and leaf in ("w_gate", "w_up", "w_down"):
        if channel_split(cfg.d_ff, R) is None:
            return WHOLE
        return Layout(0 if leaf == "w_down" else 1, _even(cfg.d_ff, R),
                      cfg.d_ff)
    if kind == "moe" and leaf in ("w_gate", "w_up", "w_down") and ndim == 3:
        if channel_split(cfg.n_experts, R) is None:
            return WHOLE
        return Layout(0, _even(cfg.n_experts, R), cfg.n_experts)
    if kind == "mamba":
        di = cfg.d_inner
        if channel_split(di, R) is None:
            return WHOLE
        if leaf == "in_proj":                 # [x | z]: both halves' block
            return Layout(1, tuple(c + tuple(di + i for i in c)
                                   for c in _even(di, R)), 2 * di)
        if leaf in _MAMBA_DIM:
            return Layout(_MAMBA_DIM[leaf], _even(di, R), di)
        return WHOLE
    if kind == "embed" and leaf in ("table", "lm_head"):
        V = cfg.padded_vocab
        if channel_split(V, R) is None:
            return WHOLE
        return Layout(0 if leaf == "table" else 1, _even(V, R), V)
    if leaf == "lm_heads":                    # each codebook's vocab block
        V, K = cfg.vocab_size, cfg.n_codebooks
        if channel_split(V, R) is None:
            return WHOLE
        return Layout(1, tuple(tuple(k * V + i for k in range(K) for i in c)
                               for c in _even(V, R)), K * V)
    return WHOLE


def vocab_block(cfg, axis: ModelAxis | None) -> tuple | None:
    """``(start, length)`` of this rank's vocabulary block (the embedding's
    rows, the head's columns; per codebook for the audio head), or
    ``None`` when the vocabulary is whole on every rank."""
    if axis is None:
        return None
    V = cfg.vocab_size if cfg.frontend == "audio" else cfg.padded_vocab
    split = channel_split(V, axis.size)
    return None if split is None else split[axis.rank]


@dataclass(frozen=True)
class CacheBlock:
    """This rank's block of every attention decode cache (B, L, Hkv, D)
    under ``"tp"`` (the module docstring): rows ``[row0, row0 + rows)`` of
    the global ``batch``, the kv heads ``heads`` (a contiguous run, in order)
    and positions ``[lo, lo + length)`` of the whole length.  ``axes``: the
    mesh axes L is split over (the data axes first, then ``model``; empty
    where L is whole), and ``group``, those axes' process group (``None``
    where L is whole, or for a block asked for at other coordinates)."""

    rows: int
    row0: int
    batch: int
    heads: tuple
    lo: int
    length: int
    axes: tuple = ()
    group: object = dataclasses.field(default=None, compare=False,
                                      repr=False)

    @property
    def split(self) -> bool:
        """L is split over ranks."""
        return bool(self.axes)

    @property
    def over_model(self) -> bool:
        """L is split over ``model``: the rank holds every kv head of its
        positions."""
        return MODEL_AXIS in self.axes


def present_data_axes(mesh) -> tuple:
    """The data axes that ``mesh`` has (a mesh may lack them)."""
    names = set(mesh.mesh_dim_names)
    return tuple(a for a in data_axes(mesh) if a in names)


def cache_block(cfg, mesh, batch: int, max_len: int,
                coord=None) -> CacheBlock:
    """This rank's :class:`CacheBlock` (or the block of the rank at mesh
    coordinates ``coord``) of decode caches of ``batch`` rows (the global
    batch) and ``max_len`` positions on ``mesh``: ``cache_pspecs``'s
    block, except where L does not divide its group (the module
    docstring).  Every rank must ask at the same point: the group of
    several axes is made on first use."""
    sizes = axis_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    own = coord is None
    coord = mesh.get_coordinate() if own else coord
    dp = present_data_axes(mesh)
    nm = sizes.get(MODEL_AXIS, 1)
    r = coord[names.index(MODEL_AXIS)] if MODEL_AXIS in names else 0
    nkv = cfg.n_kv_heads
    group_axes = []
    if batch % axis_size(mesh, dp) == 0 and batch >= axis_size(mesh, dp):
        d, n = block_index(dp, mesh, coord)
        rows, row0 = batch // n, d * (batch // n)
    else:
        rows, row0 = batch, 0
        group_axes.extend(dp)
    split_heads = nkv % nm == 0 and nkv >= nm
    if not split_heads:
        group_axes.append(MODEL_AXIS)
    hs = head_split(cfg, nm, r)
    mine = tuple(range(nkv)) if hs is None else hs.kv
    n_group = axis_size(mesh, group_axes) if group_axes else 1
    if not nkv or n_group == 1 or max_len % n_group:
        return CacheBlock(rows, row0, batch, mine, 0, max_len)
    axes = tuple(group_axes)
    index, count = block_index(axes, mesh, coord)
    length = max_len // count
    return CacheBlock(rows, row0, batch,
                      mine if split_heads else tuple(range(nkv)),
                      index * length, length, axes,
                      axes_group(mesh, axes) if own else None)


@functools.lru_cache(maxsize=None)
def state_layout(cfg, which: str, R: int) -> Layout:
    """The executed :class:`Layout` of a mamba decode state over a
    ``model`` axis of R: ``"conv"`` (B, K-1, d_inner) and ``"ssm"`` (B,
    d_inner, N) hold the rank's channels (taken by name, not by the size
    guess of ``cache_pspecs``)."""
    if R == 1 or channel_split(cfg.d_inner, R) is None:
        return WHOLE
    return Layout(2 if which == "conv" else 1, _even(cfg.d_inner, R),
                  cfg.d_inner)


class _SharedGrad(torch.autograd.Function):
    """Forward: the block as it is.  Backward: each entry's gradient summed
    over the ranks that hold it (an entry two ranks' graphs read gets both
    parts), through one all-reduce of the whole dim."""

    @staticmethod
    def forward(ctx, w, layout, axis):
        ctx.layout, ctx.axis = layout, axis
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        lay, axis = ctx.layout, ctx.axis
        idx = lay._index(axis.rank, g.device)
        shape = list(g.shape)
        shape[lay.dim] = lay.size
        whole = g.new_zeros(shape, dtype=torch.float32)
        whole.index_add_(lay.dim, idx, g.float())
        transport.all_reduce(whole, axis.group)
        return whole.index_select(lay.dim, idx).to(g.dtype), None, None


def shared_grad(w: torch.Tensor, layout: Layout, axis: ModelAxis):
    """``w`` (this rank's block under ``layout``) with its gradient summed
    over the ranks holding each entry, when entries are shared."""
    return _SharedGrad.apply(w, layout, axis) if layout.shared else w


def executed_pspecs(leaves, mesh) -> list:
    """The sanitized spec of each leaf, with ``model`` also on the dim its
    executed block splits (ZeRO-1 then never picks that dim); the leaves
    carry ``whole_shape`` and ``layout`` (``models.convert.Leaf``)."""
    whole = [WholeLeaf(leaf.path, leaf.whole_shape) for leaf in leaves]
    base = sanitize_pspecs(whole, param_pspecs(whole), mesh)
    out = []
    for leaf, s in zip(leaves, base):
        if leaf.layout.whole:
            out.append(s)
            continue
        dims = list(s) + [None] * (leaf.ndim - len(s))
        dims[leaf.layout.dim + leaf.stacked] = MODEL_AXIS
        out.append(spec(*dims))
    return out


@dataclass(frozen=True)
class WholeLeaf:
    """A leaf's path and whole shape, for the rules above."""

    path: tuple
    shape: tuple

    @property
    def ndim(self) -> int:
        return len(self.shape)


_REASONS = {"wk": "kv heads of the rank's query heads",
            "wv": "kv heads of the rank's query heads",
            "bk": "kv heads of the rank's query heads",
            "bv": "kv heads of the rank's query heads",
            "in_proj": "[x | z]: the channel block of each half",
            "lm_heads": "each codebook's vocab block"}


def departures(cfg, R: int) -> dict:
    """``{name: why}`` for each leaf of ``cfg``'s model whose executed block
    on a ``model`` axis of R differs from its spec's block (the table of
    the module docstring, by rule); a name is the leaf's path without its
    ``stack/<pos>/`` prefix (``"attn/wk"``, ``"lm_heads"``)."""
    out = {}
    hd = cfg.resolved_head_dim
    if R == 1:
        return out
    if cfg.n_heads:
        split = head_split(cfg, R, 0) is not None
        names = ["wo"] if cfg.fused_proj else ["wq", "wo", "wk", "wv"]
        if cfg.qkv_bias and not cfg.fused_proj:
            names += ["bq", "bk", "bv"]
        for leaf in names:
            q = leaf in ("wq", "bq", "wo")
            n = (cfg.padded_heads if q else cfg.n_kv_heads) * hd
            if not split and n % R == 0:
                out[f"attn/{leaf}"] = "query heads do not split: whole"
            elif split and not q and cfg.n_kv_heads % R:
                out[f"attn/{leaf}"] = _REASONS[leaf]
    if cfg.ssm_state:
        if cfg.d_inner % R == 0:
            out["mamba/in_proj"] = _REASONS["in_proj"]
        elif 2 * cfg.d_inner % R == 0:
            out["mamba/in_proj"] = "channels do not split: whole"
    if cfg.frontend == "audio":
        V, K = cfg.vocab_size, cfg.n_codebooks
        if V % R == 0 and K > 1:
            out["lm_heads"] = _REASONS["lm_heads"]
        elif V % R and K * V % R == 0:
            out["lm_heads"] = "codebook vocabulary does not split: whole"
    return out


# --------------------------------------------------------------------- FSDP
def fsdp_specs(leaves, mesh) -> list:
    """The specs of the FSDP + TP hybrid, as the reference's dry run lays
    out its parameters when FSDP is on: ``sanitize_pspecs`` of
    ``zero1_pspecs`` over the unsanitized ``param_pspecs`` of the whole
    leaves (``zero1_pspecs`` sees the unsanitized spec: a dim whose
    ``model`` entry the sanitizing drops is not free for the data axes)."""
    return sanitize_pspecs(leaves, zero1_pspecs(leaves,
                                                param_pspecs(leaves), mesh),
                           mesh)


def data_entry(s, mesh) -> tuple | None:
    """``(dim, axes)`` of the entry of spec ``s`` on the data axes, or
    ``None``."""
    dp = set(data_axes(mesh))
    for i, e in enumerate(s):
        if set(axes_of(e)) & dp:
            return i, axes_of(e)
    return None


@dataclass(frozen=True)
class FsdpBlock:
    """This rank's block of one port tensor under FSDP: the tensor (its
    executed ``model`` block) split into ``count`` equal blocks along
    ``dim``, this rank's at ``index``; ``axes`` are the data axes that
    split it (first major) and ``group`` their process group, whose rank
    order is the blocks' order."""

    dim: int
    axes: tuple
    index: int
    count: int
    group: object = dataclasses.field(default=None, compare=False,
                                      repr=False)

    def take(self, t: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """This rank's block of ``t`` (``offset``: leading dims before the
        port tensor's, 1 for a stacked leaf): a view."""
        dim = self.dim + offset
        size = t.shape[dim] // self.count
        return t.narrow(dim, self.index * size, size)

    def shape(self, shape, offset: int = 0) -> tuple:
        shape = list(shape)
        shape[self.dim + offset] //= self.count
        return tuple(shape)

    def whole_shape(self, shape, offset: int = 0) -> tuple:
        shape = list(shape)
        shape[self.dim + offset] *= self.count
        return tuple(shape)

    def gather(self, t: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """The tensor whole over the data axes from every rank's block (one
        all-gather; every rank of the group calls it)."""
        return transport.all_gather_dim(t, self.group, self.dim + offset)


def fsdp_block(s, stacked: bool, mesh, coord=None,
               group=None) -> FsdpBlock | None:
    """The executed :class:`FsdpBlock` of a port tensor of a leaf whose
    FSDP spec is ``s`` (``stacked``: a stack leaf, whose spec's first
    entry is ``n_blocks``): ``None`` where the spec has no data entry or
    puts it on the stack dim (the departure of the module docstring)."""
    de = data_entry(s, mesh)
    if de is None or (stacked and de[0] == 0):
        return None
    dim, axes = de
    coord = mesh.get_coordinate() if coord is None else coord
    index, count = block_index(axes if len(axes) > 1 else axes[0], mesh,
                               coord)
    return FsdpBlock(dim - int(stacked), axes, index, count, group)


def fsdp_departures(leaves, mesh) -> dict:
    """``{leaf name: why}`` for the leaves (whole, as ``param_pspecs``
    takes them) whose executed FSDP block departs from the spec's."""
    out = {}
    for leaf, s in zip(leaves, fsdp_specs(leaves, mesh)):
        de = data_entry(s, mesh)
        if de is not None and de[0] == 0 and leaf.path[0] == "stack":
            out["/".join(map(str, leaf.path))] = (
                "data axes on the stack dim: whole over the data axes")
    return out


# ----------------------------------------------------------------- fsdp_seq
def seq_axes(mesh) -> tuple:
    """The axes ``"fsdp_seq"`` shards every parameter over: the data axes,
    then ``model``."""
    return tuple(data_axes(mesh)) + (MODEL_AXIS,)


def fsdp_seq_specs(leaves, mesh) -> list:
    """The specs of the ``"fsdp_seq"`` layout (the reference's pure FSDP):
    ``sanitize_pspecs`` of ``zero1_pspecs`` of the empty specs over the
    data axes and ``model`` together."""
    return sanitize_pspecs(
        leaves, zero1_pspecs(leaves, [spec()] * len(leaves), mesh,
                             axes=seq_axes(mesh)), mesh)


def fsdp_seq_departures(leaves, mesh) -> dict:
    """``{leaf name: why}`` for the leaves whose executed ``"fsdp_seq"``
    block departs from the spec's (the first row of the module docstring's
    ``"fsdp_seq"`` table)."""
    out = {}
    for leaf, s in zip(leaves, fsdp_seq_specs(leaves, mesh)):
        de = data_entry(s, mesh)
        if de is not None and de[0] == 0 and leaf.path[0] == "stack":
            out["/".join(map(str, leaf.path))] = (
                "all ranks' axes on the stack dim: whole on every rank")
    return out


@dataclass(frozen=True)
class SeqAxis:
    """The sequence split of ``"fsdp_seq"``: the ``model`` axis's group,
    its size R and this rank's coordinate r on it (the rank holds positions
    ``[r * L / R, (r + 1) * L / R)`` of every row), and the group of every
    rank (data axes, then ``model``: group rank ``d * R + r``) with the
    data ranks' count."""

    group: object
    size: int
    rank: int
    world: object
    n_data: int

    def block(self, L: int, what: str = "the sequence") -> int:
        """``L / R``, or a ``ValueError`` naming ``what``, ``L`` and R."""
        if L % self.size:
            raise ValueError(f"{what}: length {L} does not split over a "
                             f"model axis of R = {self.size} (fsdp_seq)")
        return L // self.size


def seq_axis(mesh) -> SeqAxis:
    """The :class:`SeqAxis` of ``mesh`` (with a ``model`` axis of 1, one
    block: the whole sequence).  Every rank must ask at the same point: the
    group over several axes is made on first use."""
    world = axes_group(mesh, seq_axes(mesh))
    R = axis_sizes(mesh)[MODEL_AXIS]
    return SeqAxis(mesh.get_group(MODEL_AXIS), R,
                   mesh.get_local_rank(MODEL_AXIS), world,
                   axis_size(mesh, data_axes(mesh)))
