"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
JAX package's ``repro.parallel.sharding``: the spec trees of every
function, for all ten archs at full width, on the (1, 4), (2, 2), (16, 16)
and (2, 16, 16) meshes, exactly.

The reference functions read only ``mesh.shape`` and ``mesh.axis_names``,
so its side takes a ``jax.sharding.AbstractMesh``; the port's takes a
``DeviceMesh`` built under a fake process group of the mesh's size (no
peers).  Both sides start from abstract parameters (no weight drawn).
Cache specs: the port's caches are per layer, so layer ``i * P + pos``'s
spec is the reference's stacked spec at pattern position ``pos`` without
its leading ``n_blocks`` entry."""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro import parallel as ref
from repro.configs import ARCHS
from repro.models import factory as ref_factory
from repro_torch.configs import get_arch
from repro_torch.models import factory, lm
from repro_torch.models import blocks
from repro_torch.models.blocks import layer_pattern
from repro_torch.models.config import ShapeConfig
from repro_torch import parallel as par
from repro_torch.parallel import sharding

MESHES = [((1, 4), ("data", "model")), ((2, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["1x4", "2x2", "16x16", "2x16x16"]


@pytest.fixture(scope="module", params=list(zip(MESHES, MESH_IDS)),
                ids=MESH_IDS)
def meshes(request):
    """(port DeviceMesh under a fake group, reference AbstractMesh)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    (shape, axes), _ = request.param
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    yield mesh, AbstractMesh(shape, axes)
    dist.destroy_process_group()


_ABSTRACT: dict = {}


def abstract(name):
    """(port leaves, reference abstract params) of one full-width arch,
    built once per worker."""
    if name not in _ABSTRACT:
        _ABSTRACT[name] = (factory.abstract_leaves(get_arch(name)),
                           ref_factory.abstract_params(ARCHS[name]))
    return _ABSTRACT[name]


def ref_leaves(tree):
    return [tuple(s) for s in
            jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))]


@pytest.mark.parametrize("name", list(ARCHS))
def test_param_spec_trees_equal_the_reference(meshes, name):
    mesh, amesh = meshes
    leaves, params = abstract(name)
    assert [leaf.shape for leaf in leaves] == \
        [tuple(x.shape) for x in jax.tree.leaves(params)]
    got = par.param_pspecs(leaves)
    want = ref.param_pspecs(params)
    assert got == ref_leaves(want)
    got_s = par.sanitize_pspecs(leaves, got, mesh)
    want_s = ref.sharding.sanitize_pspecs(params, want, amesh)
    assert got_s == ref_leaves(want_s)
    assert par.zero1_pspecs(leaves, got_s, mesh) == \
        ref_leaves(ref.zero1_pspecs(params, want_s, amesh))
    fsdp_axes = tuple(par.data_axes(mesh)) + ("model",)
    assert par.zero1_pspecs(leaves, got, mesh, axes=fsdp_axes) == \
        ref_leaves(ref.zero1_pspecs(params, want, amesh, axes=fsdp_axes))
    for threshold in (par.FSDP_THRESHOLD_BYTES, 7.0e9):
        g, used = par.fsdp_pspecs(leaves, got, mesh, threshold)
        w, wused = ref.fsdp_pspecs(params, want, amesh, threshold)
        assert used == wused
        assert g == ref_leaves(w)
    # the port's per-layer tensors: a stacked spec loses its first entry
    for leaf, s in zip(leaves, got):
        per = par.layer_spec(leaf, s)
        assert len(per) <= leaf.tensors[0].ndim
        assert per == (s[1:] if leaf.stacked else s)


@pytest.mark.parametrize("name", list(ARCHS))
def test_batch_and_cache_spec_trees_equal_the_reference(meshes, name):
    mesh, amesh = meshes
    cfg, rcfg = get_arch(name), ARCHS[name]
    for kind, seq, batch in (("train", 4096, 32), ("train", 2048, 3),
                             ("decode", 4096, 16), ("decode", 4096, 1)):
        shape = ShapeConfig("t", kind, seq, batch)
        got = par.batch_pspecs(
            factory.make_inputs(cfg, shape, abstract=True), mesh)
        want = ref.batch_pspecs(
            ref_factory.make_inputs(rcfg, shape, abstract=True), amesh)
        assert got == {k: tuple(v) for k, v in want.items()}
    for B, L in ((16, 4096), (1, 4096), (2, 96)):
        got = par.cache_pspecs(factory.abstract_caches(cfg, B, L), mesh)
        want = ref.cache_pspecs(ref_factory.abstract_caches(rcfg, B, L),
                                amesh)
        Pn = len(layer_pattern(cfg))
        assert len(got) == cfg.n_layers and len(want) == Pn
        for i, g in enumerate(got):
            w = want[i % Pn]
            if w is None:
                assert g is None
            elif isinstance(w, dict):
                assert g == {k: tuple(v)[1:] for k, v in w.items()}
            else:
                assert tuple(g) == tuple(tuple(v)[1:] for v in w)


def test_decode_inputs_match_the_reference():
    cfg, rcfg = get_arch("jamba-v0.1-52b"), ARCHS["jamba-v0.1-52b"]
    shape = ShapeConfig("d", "decode", 512, 4)
    batch, caches, pos = factory.decode_inputs(cfg, shape)
    rbatch, rcaches, rpos = ref_factory.decode_inputs(rcfg, shape)
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(v.shape) for k, v in rbatch.items()}
    assert pos.device.type == "meta" and pos.dtype == torch.int32
    assert tuple(pos.shape) == tuple(rpos.shape)
    Pn = len(layer_pattern(cfg))
    for i, c in enumerate(caches):
        r = rcaches[i % Pn]
        got = [tuple(x.shape) for x in
               (c.values() if isinstance(c, dict) else c)]
        want = [tuple(x.shape)[1:] for x in
                (r.values() if isinstance(r, dict) else r)]
        assert got == want
    small = get_arch("qwen2.5-3b").reduced()
    batch, caches, pos = factory.decode_inputs(small, shape, abstract=False,
                                               device="cpu")
    assert pos == 511 and caches[0]["k"].shape == \
        (4, 512, small.n_kv_heads, small.resolved_head_dim)
    assert batch["tokens"].shape == (4, 1)
    with pytest.raises(ValueError, match="not decode"):
        factory.decode_inputs(small, ShapeConfig("t", "train", 8, 2))


def test_placements_local_shard_and_blocks(meshes):
    """Each rank's block (its mesh coordinates) tiles the tensor exactly
    once; DTensor placements name the same dims."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, _ = meshes
    sizes = sharding.axis_sizes(mesh)
    dp = par.data_axes(mesh)
    for s in (sharding.spec("model", None), sharding.spec(None, dp),
              sharding.spec(dp, "model"), sharding.spec()):
        pl = par.placements(s, mesh)
        for a, p in zip(mesh.mesh_dim_names, pl):
            dims = [i for i, e in enumerate(s)
                    if a in sharding.axes_of(e)]
            assert p == (Shard(dims[0]) if dims else Replicate())
        t = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
        seen = torch.zeros_like(t)
        for coord in np.ndindex(*mesh.shape):
            blk = par.local_shard(t, s, mesh, coord=list(coord))
            covered = 1
            for e in s:
                covered *= math.prod(sizes[a] for a in sharding.axes_of(e))
            assert blk.numel() * covered == t.numel()
            seen.view(-1)[blk.reshape(-1).long()] += 1
        replicas = math.prod(mesh.shape) // covered
        assert torch.all(seen == replicas)


TP_MESHES = [(1, 2), (1, 4), (2, 2)]


def _port_name(leaf) -> str:
    """The port tensor name ``param_layout`` reads (``stack.<pos>.attn.wq``,
    ``embed.table``, ``lm_heads``)."""
    return ".".join(map(str, leaf.path))


@pytest.mark.parametrize("shape", TP_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", list(ARCHS))
def test_executed_blocks_reassemble_and_list_their_departures(name, shape):
    """At full width, on each mesh: every leaf's executed blocks over the R
    model ranks put the whole leaf back together (every entry held, at
    its place), each rank's attention heads pass the kernel's ``Hq % Hkv
    == 0``, and ``departures`` names exactly the leaves whose executed
    block differs from the sanitized spec's block on some rank (the data
    coordinate changes neither)."""
    from types import SimpleNamespace
    cfg = get_arch(name)
    leaves, _ = abstract(name)
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape)
    R = shape[1]
    specs = par.sanitize_pspecs(leaves, par.param_pspecs(leaves), mesh)
    differ = set()
    for leaf, s in zip(leaves, specs):
        t = leaf.tensors[0]
        lay = sharding.param_layout(cfg, _port_name(leaf), t.ndim, R)
        per = par.layer_spec(leaf, s)
        for dim, n in enumerate(t.shape):
            # the entries of this dim that each rank holds, both ways
            probe = [1] * t.ndim
            probe[dim] = n
            whole = torch.arange(n).reshape(probe)
            back = torch.full_like(whole, -1)
            for r in range(R):
                blk = lay.take(whole, r) if dim == lay.dim else whole
                if dim == lay.dim:
                    assert blk.shape == lay.shape(whole.shape, r)
                back.index_copy_(dim, blk.reshape(-1), blk)
                for d in range(shape[0]):
                    only = tuple(e if i == dim else None
                                 for i, e in enumerate(per))
                    spec_blk = par.local_shard(whole, only, mesh,
                                               coord=[d, r])
                    if not torch.equal(spec_blk, blk):
                        differ.add(leaf.name)
            assert torch.equal(back, whole), (leaf.name, dim)
        if not lay.whole:
            assert lay.size == t.shape[lay.dim]
    key = lambda nm: nm.split("/", 2)[2] if nm.startswith("stack/") else nm
    assert {key(nm) for nm in differ} == set(sharding.departures(cfg, R))
    for r in range(R):
        heads = sharding.head_split(cfg, R, r)
        if heads is not None:
            hkv = heads.nq if heads.expand else len(heads.kv)
            assert heads.nq % hkv == 0
            assert len(heads.expand or heads.kv) <= heads.nq


def test_departure_table_names_the_full_width_cases():
    """The departures the docstring's table names, where the published
    archs reach them: qwen2.5-3b's 2 kv heads and phi3-medium's 10 over 4
    ranks, mamba's ``[x | z]`` (jamba, falcon-mamba), musicgen's four
    codebooks; none for an arch whose kv heads split evenly."""
    dep = {n: sharding.departures(get_arch(n), 4) for n in ARCHS}
    for n in ("qwen2.5-3b", "phi3-medium-14b"):
        assert set(dep[n]) == {"attn/wk", "attn/wv"} | (
            {"attn/bk", "attn/bv"} if get_arch(n).qkv_bias else set())
    assert "mamba/in_proj" in dep["jamba-v0.1-52b"]
    assert set(dep["falcon-mamba-7b"]) == {"mamba/in_proj"}
    assert set(dep["musicgen-medium"]) == {"lm_heads"}
    assert dep["deepseek-67b"] == {} and dep["gemma-7b"] == {}
    heads = sharding.head_split(get_arch("phi3-medium-14b"), 4, 1)
    assert heads.kv == (2, 3, 4) and heads.expand is not None
    assert sharding.head_split(get_arch("jamba-v0.1-52b"), 4, 1).expand \
        is None


@pytest.mark.parametrize("name", ["qwen2.5-3b", "jamba-v0.1-52b"])
def test_abstract_params_and_caches_of_a_rank(meshes, name):
    """``abstract_params`` / ``abstract_caches`` with a mesh: this rank's
    blocks of every parameter and cache (the executed layout of its model
    axis), whole ones where the layout is whole; with ``fsdp``, each block
    also cut over the data axes (``lm.fsdp_plan``)."""
    mesh, _ = meshes
    cfg = get_arch(name)
    axis = sharding.model_axis(mesh)
    whole = factory.abstract_params(cfg)
    mine = factory.abstract_params(cfg, mesh=mesh)
    assert list(mine) == list(whole)
    for n, t in whole.items():
        lay = sharding.param_layout(cfg, n, t.ndim, axis.size)
        assert tuple(mine[n].shape) == lay.shape(t.shape, axis.rank), n
        assert mine[n].dtype == t.dtype and mine[n].device.type == "meta"
    fsdp = factory.abstract_params(cfg, mesh=mesh, fsdp=True)
    plan = lm.fsdp_plan(cfg, mesh)
    for n, t in mine.items():
        blk = plan[lm.short_name(n)]
        want = t.shape if blk is None else blk.shape(t.shape)
        assert tuple(fsdp[n].shape) == tuple(want), n
    n_data = math.prod(n for a, n in sharding.axis_sizes(mesh).items()
                       if a != "model")
    assert sum(math.prod(t.shape) for t in fsdp.values()) * n_data <= \
        1.01 * sum(math.prod(t.shape) for t in mine.values())
    caches = factory.abstract_caches(cfg, 2, 64, mesh=mesh)
    block = sharding.cache_block(cfg, mesh, 2, 64)
    for c, w in zip(caches, factory.abstract_caches(cfg, 2, 64)):
        if c is None:
            continue
        if isinstance(c, dict):
            for k in c:
                assert tuple(c[k].shape) == (block.rows, block.length,
                                             len(block.heads),
                                             w[k].shape[3])
            continue
        for i, k in enumerate(("conv", "ssm")):
            lay = sharding.state_layout(cfg, k, axis.size)
            want = (block.rows, *w[i].shape[1:])
            assert tuple(c[i].shape) == lay.shape(want, axis.rank)


@pytest.mark.parametrize("name", list(ARCHS))
def test_fsdp_blocks_follow_the_reference_order(meshes, name):
    """The FSDP layout the port executes: ``sanitize_pspecs`` of
    ``fsdp_pspecs`` (forced on) over the unsanitized ``param_pspecs``, as
    the reference's dry run orders them, exactly; each leaf's executed
    block is its spec's data entry on the per-layer tensor, and the
    departures (a data entry on the stack dim) are named."""
    mesh, amesh = meshes
    leaves, params = abstract(name)
    want, used = ref.fsdp_pspecs(params, ref.param_pspecs(params), amesh,
                                 threshold=0.0)
    assert used
    want = ref.sharding.sanitize_pspecs(params, want, amesh)
    got = sharding.fsdp_specs(leaves, mesh)
    assert got == ref_leaves(want)
    dep = sharding.fsdp_departures(leaves, mesh)
    for leaf, s in zip(leaves, got):
        blk = sharding.fsdp_block(s, leaf.stacked, mesh)
        de = sharding.data_entry(s, mesh)
        assert (leaf.name in dep) == (de is not None and leaf.stacked
                                      and de[0] == 0), leaf.name
        if blk is None:
            assert de is None or leaf.name in dep, leaf.name
            continue
        assert (blk.dim + leaf.stacked, blk.axes) == de, leaf.name
        assert blk.count == math.prod(sharding.axis_sizes(mesh)[a]
                                      for a in blk.axes)
        assert blk.index == 0                        # rank 0's block
    if dict(zip(mesh.mesh_dim_names, mesh.shape))["data"] == 2 and \
            name == "qwen2.5-3b":
        assert set(dep) == {"stack/0/attn/bq", "stack/0/attn/bk",
                            "stack/0/attn/bv"}


CACHE_MESHES = [((1, 2), ("data", "model")), *MESHES]


def _spec_block(s, shape, mesh, coord) -> list:
    """``(start, length)`` of each dim of ``shape`` in the block of spec
    ``s`` at mesh coordinates ``coord``."""
    out = []
    for n, e in zip(shape, list(s) + [None] * (len(shape) - len(s))):
        idx, count = sharding.block_index(e, mesh, coord)
        out.append((idx * (n // count), n // count))
    return out


@pytest.mark.parametrize("mesh_shape,axes", CACHE_MESHES,
                         ids=["1x2"] + MESH_IDS)
@pytest.mark.parametrize("name", list(ARCHS))
def test_cache_blocks_equal_the_reference_specs(name, mesh_shape, axes):
    """At full width, on every rank of each mesh: the decode caches
    ``init_caches`` makes for the rank's ``cache_block`` are the block of
    the reference's ``cache_pspecs`` over its ``abstract_caches`` (rows,
    positions and kv heads, where each starts and how many), for a batch
    that divides the data axes and a batch of 1, over a length every
    group divides and one (96) that the largest groups do not.  The one
    departure, L left whole with the kv heads of the rank's query heads
    where the spec holds every head, shows only at that length and a
    batch of 1."""
    from types import SimpleNamespace
    cfg, rcfg = get_arch(name), ARCHS[name]
    mesh = SimpleNamespace(mesh_dim_names=axes, shape=mesh_shape)
    amesh = AbstractMesh(mesh_shape, axes)
    n_data = math.prod(mesh_shape[:-1])
    R = mesh_shape[-1]
    Pn = len(layer_pattern(cfg))
    for B, L in ((2 * n_data, 4096), (1, 4096), (1, 96)):
        specs = ref.cache_pspecs(ref_factory.abstract_caches(rcfg, B, L),
                                 amesh)
        shapes = [None if c is None else
                  {k: tuple(v.shape)[1:] for k, v in c.items()}
                  if isinstance(c, dict) else [tuple(v.shape)[1:] for v in c]
                  for c in ref_factory.abstract_caches(rcfg, B, L)]
        seen, made = set(), {}
        for coord in np.ndindex(*mesh_shape):
            blk = sharding.cache_block(cfg, mesh, B, L, list(coord))
            key = (blk.rows, len(blk.heads), blk.length)
            if key not in made:
                tp = None if R == 1 else sharding.ModelAxis(None, R, 0)
                made[key] = blocks.init_caches(cfg, blk.rows, L,
                                               torch.device("meta"), tp,
                                               cache=blk)
            for i, c in enumerate(made[key]):
                w, shp = specs[i % Pn], shapes[i % Pn]
                if w is None:
                    assert c is None
                    continue
                if isinstance(w, dict):
                    want = _spec_block(tuple(w["k"])[1:], shp["k"], mesh,
                                       coord)
                    got = [(blk.row0, blk.rows), (blk.lo, blk.length),
                           (blk.heads[0], len(blk.heads)),
                           (0, shp["k"][3])]
                    for k in c:
                        assert tuple(c[k].shape) == tuple(n for _, n in got)
                    if got != want:
                        seen.add("attn")
                        assert got[0] == want[0] and got[1] == want[1] \
                            == (0, L), (name, coord, got, want)
                        h = sharding.head_split(cfg, R, coord[-1])
                        assert want[2] == (0, cfg.n_kv_heads) \
                            and blk.heads == h.kv
                    continue
                for j, (x, which) in enumerate(zip(c, ("conv", "ssm"))):
                    want = _spec_block(tuple(w[j])[1:], shp[j], mesh, coord)
                    lay = sharding.state_layout(cfg, which, R)
                    got = [(blk.row0, blk.rows)] + [(0, n)
                                                    for n in shp[j][1:]]
                    if not lay.whole:
                        got[lay.dim] = (lay.index[coord[-1]][0],
                                        len(lay.index[coord[-1]]))
                    assert got == want, (name, which, coord, got, want)
                    assert tuple(x.shape) == tuple(n for _, n in got)
        assert not seen or (B, L) == (1, 96), (B, L)


def test_exports_the_reference_names():
    """``repro_torch.parallel`` exports every name of the reference's
    ``__all__`` (``named`` maps specs to DTensor placements)."""
    assert set(ref.__all__) <= set(par.__all__)
    for name in par.__all__:
        assert hasattr(par, name), name


def test_stage_block_counts():
    assert par.stage_block_counts(8, 4) == [2, 2, 2, 2]
    assert par.stage_block_counts(8, 4) == \
        ref.stage_block_counts(8, 4)
    with pytest.raises(ValueError, match="not divisible"):
        par.stage_block_counts(7, 2)
