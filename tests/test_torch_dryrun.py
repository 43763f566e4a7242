"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's ``repro.launch.dryrun``, on the CPU.

The reference's compiled programs are no oracle here (its dry-run tests
fail on this jax: its meshes have Explicit axes), so what is held is its
pure-Python half, function by function:

* ``default_n_micro``, ``dp_of`` and ``_mesh_name`` for every arch x shape
  on (16, 16) and (2, 16, 16) (the reference's side takes an
  ``AbstractMesh``; the port's a ``DeviceMesh`` under a fake process group
  of the mesh's size);
* ``build_step``'s ``meta`` (``fsdp``, ``optimizer``, ``n_micro``) against
  the reference's decisions (``fsdp_pspecs`` at 1e9 / 7e9 over the prefill
  overrides' parameters, Adafactor above 1e11 parameters);
* a record's ``analytic`` and ``memory.analytic_live_bytes`` against the
  reference's ``cell_summary`` / ``analytic_live_bytes`` at rtol 1e-12,
  and its key set against the reference's (written out from its
  ``run_cell``), with the one rename;
* ``run_cell`` on every reduced arch x the three kinds at (2, 4), the
  reference test's shape, and one full-width ``decode_32k`` cell at
  (16, 16);
* the folded capture (one microbatch of a train step, one time step of the
  scan and one tile of the blockwise attention with grad disabled) against
  the unrolled one: the same record;
* ``layout="fsdp_seq"``: ``sharding.fsdp_seq_specs`` against the
  reference's ``sanitize_pspecs(zero1_pspecs(P()-tree, axes=data +
  model))`` for every arch at full width on four meshes, ``build_step``'s
  meta over every production cell, ``run_cell`` on the reduced qwen2.5-3b
  (train, prefill, decode) and jamba (prefill) at (2, 4) with no per-layer
  all-reduce, and ``launch.perf_cell`` in a subprocess against
  ``run_cell``'s record (the reference script's keys, one renamed).

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices;
the module restores it at once, so later JAX subprocesses of this worker
see the environment they had."""
import contextlib
import functools
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

_FLAGS = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as ref_dryrun                  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

from jax.sharding import AbstractMesh                    # noqa: E402

from repro import parallel as ref_par                    # noqa: E402
from repro.configs import ARCHS as REF_ARCHS             # noqa: E402
from repro.core import analytic as ref_analytic          # noqa: E402
from repro.models import factory as ref_factory          # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, cell_applicable  # noqa: E402
from repro_torch.launch import dryrun                    # noqa: E402
from repro_torch.launch.mesh import init_fake_ranks, make_mesh  # noqa: E402
from repro_torch.models.config import ShapeConfig        # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
PRODUCTION = ["16x16", "2x16x16"]
REDUCED_SHAPES = [ShapeConfig("train_4k", "train", 64, 8),
                  ShapeConfig("prefill", "prefill", 64, 8),
                  ShapeConfig("decode", "decode", 64, 8)]

#: The reference's record keys (``repro/launch/dryrun.py``, ``run_cell``),
#: ``live_bytes_tpu_estimate`` renamed ``live_bytes_device_estimate``.
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "status", "fsdp", "n_micro",
               "lower_s", "compile_s", "memory", "cost_raw", "analytic",
               "roofline", "collectives"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "live_bytes", "cpu_f32_twin_bytes",
               "live_bytes_device_estimate", "analytic_live_bytes",
               "fits_hbm_parsed", "fits_hbm"}
ROOFLINE_KEYS = {"flops", "hbm_bytes", "wire_bytes", "compute_s", "memory_s",
                 "collective_s", "dominant", "step_time_s",
                 "parsed_hbm_bytes_upper", "model_flops_per_chip",
                 "useful_flops_ratio"}


@contextlib.contextmanager
def _world(name):
    """(port DeviceMesh under a fake process group of the mesh's size,
    reference AbstractMesh); the group ends with the block."""
    shape, axes = MESHES[name]
    init_fake_ranks(math.prod(shape))
    try:
        yield make_mesh(shape, axes, "cpu"), AbstractMesh(shape, axes)
    finally:
        dist.destroy_process_group()


#: The archs both packages register (a port-only arch has its own file).
SHARED = [name for name in ARCHS if name in REF_ARCHS]


def _cells():
    return [(ARCHS[name], shape) for name in SHARED
            for shape in SHAPES.values() if cell_applicable(ARCHS[name],
                                                            shape)]


@pytest.mark.parametrize("mesh_name", PRODUCTION)
def test_mesh_helpers_match_the_reference(mesh_name):
    with _world(mesh_name) as (mesh, amesh):
        assert dryrun._mesh_name(mesh) == ref_dryrun._mesh_name(amesh)
        assert dryrun.dp_of(mesh) == ref_dryrun.dp_of(amesh)
        for cfg, shape in _cells():
            assert dryrun.default_n_micro(cfg, shape, mesh) == \
                ref_dryrun.default_n_micro(REF_ARCHS[cfg.name], shape,
                                           amesh), (cfg.name, shape.name)
    assert dryrun.RESIDUAL_BUDGET_BYTES == ref_dryrun.RESIDUAL_BUDGET_BYTES
    assert str(dryrun.DEFAULT_OUT) == "experiments/dryrun_torch"


@functools.lru_cache(maxsize=None)
def _ref_params(cfg):
    return ref_factory.abstract_params(cfg)


def _reference_meta(name, shape, amesh):
    """What the reference's ``build_step`` decides for a cell, from its
    own functions (its jit is never called)."""
    import jax
    cfg = REF_ARCHS[name]
    if shape.kind == "prefill" and cfg.n_heads and cfg.n_kv_heads:
        cfg = cfg.replace(attn_expand_kv=True, head_pad_multiple=16)
    params = _ref_params(cfg)
    threshold = 1.0e9 if shape.kind == "train" else 7.0e9
    _, fsdp = ref_par.fsdp_pspecs(params, ref_par.param_pspecs(params), amesh,
                                  threshold=threshold)
    meta = {"fsdp": fsdp, "n_micro": 1}
    if shape.kind == "train":
        big = sum(x.size for x in jax.tree.leaves(params)) > 1e11
        meta.update(optimizer="adafactor" if big else "adamw",
                    n_micro=ref_dryrun.default_n_micro(cfg, shape, amesh))
    return meta


@pytest.mark.parametrize("mesh_name", PRODUCTION)
def test_build_step_meta_matches_the_reference(mesh_name):
    """Every cell's ``meta`` on the production mesh: FSDP, the optimizer
    (``llama4-maverick`` trains with Adafactor) and the microbatches."""
    seen = set()
    with _world(mesh_name) as (mesh, amesh):
        for cfg, shape in _cells():
            _, _, meta = dryrun.build_step(cfg, shape, mesh, device="cpu",
                                           abstract=True)
            assert meta == _reference_meta(cfg.name, shape, amesh), \
                (cfg.name, shape.name)
            seen.add((meta["fsdp"], meta.get("optimizer")))
    assert (True, "adafactor") in seen and (True, "adamw") in seen


def _hold_record(rec, rcfg, shape, mesh):
    """The record's keys (the reference's, one renamed) and its analytic
    fields against the reference's functions on ``rcfg``."""
    dp = dryrun.dp_of(mesh)
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    _close(rec["analytic"], ref_analytic.cell_summary(
        rcfg, shape, dp, tp, n_micro=rec["n_micro"]))
    foot = ref_analytic.analytic_live_bytes(
        rcfg, shape, dp, tp, n_micro=rec["n_micro"], fsdp=rec["fsdp"],
        optimizer=rec.get("optimizer", "adamw"))
    _close(rec["memory"]["analytic_live_bytes"],
           {k: int(v) for k, v in foot.items()})
    assert set(rec) - {"optimizer", "retries"} == RECORD_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert set(rec["cost_raw"]) == {"flops", "bytes_accessed"}


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12)


def _cache_bytes(cfg, shape, mesh) -> int:
    """The bytes of the decode caches that ``build_step`` gives rank 0."""
    _, args, _ = dryrun.build_step(cfg, shape, mesh, device="cpu",
                                   abstract=True)
    return sum(t.numel() * t.element_size() for c in args[1]
               if isinstance(c, dict) for t in c.values())


def _ref_cache_bytes(rcfg, shape, amesh) -> int:
    """The bytes a device holds of the reference's attention decode
    caches under its ``cache_pspecs``."""
    caches = ref_factory.abstract_caches(rcfg, shape.global_batch,
                                         shape.seq_len)
    specs = ref_par.cache_pspecs(caches, amesh)
    sizes = dict(zip(amesh.axis_names, amesh.axis_sizes))
    total = 0
    for c, sp in zip(caches, specs):
        if not isinstance(c, dict):
            continue
        for k, x in c.items():
            n = math.prod(x.shape) * x.dtype.itemsize
            for e in tuple(sp[k]):
                for a in (e if isinstance(e, tuple) else (e,)):
                    n //= sizes[a] if a else 1
            total += n
    return total


def test_full_width_decode_cell():
    """``qwen2.5-3b x decode_32k`` at full width on (16, 16): the record
    against the reference's functions, its collectives (the TP
    all-reduces of 36 layers; 37 all-gathers, the head's and one an
    attention layer, of the new token's heads, and 36 all-to-alls, the
    partials' combine by head, as the caches split L over ``model``: 2 kv
    heads on 16 ranks), the reference's cache block (603,979,776 bytes a rank,
    the bytes its ``cache_pspecs`` give a device) and a footprint that
    fits the H100."""
    cfg, shape = ARCHS["qwen2.5-3b"], SHAPES["decode_32k"]
    with _world("16x16") as (mesh, amesh):
        rec = dryrun.run_cell(cfg, shape, mesh)
        _hold_record(rec, REF_ARCHS[cfg.name], shape, mesh)
        held = _cache_bytes(cfg, shape, mesh)
    assert held == _ref_cache_bytes(REF_ARCHS[cfg.name], shape, amesh) \
        == 603_979_776
    assert rec["status"] == "ok" and rec["fsdp"] is False
    assert rec["collectives"]["all-reduce"]["count"] >= 2 * cfg.n_layers
    assert rec["collectives"]["all-gather"]["count"] == 1 + cfg.n_layers
    assert rec["collectives"]["all-to-all"]["count"] == cfg.n_layers
    assert rec["memory"]["fits_hbm"]
    assert rec["roofline"]["dominant"] == "memory"


@pytest.mark.parametrize("name,gathers,exchanges", [("qwen2.5-3b", 3, 2),
                                                    ("jamba-v0.1-52b", 2, 0)])
def test_reduced_long_decode_cell_splits_the_cache(name, gathers, exchanges):
    """A ``long_500k``-shaped decode cell (batch 1) of the reduced arch at
    (2, 4): the batch stays whole on both data ranks and the caches split
    L over the data axes (and over ``model`` where the kv heads do not
    split: qwen2.5-3b's 2 on 4 ranks), so a rank holds the bytes of the
    reference's ``cache_pspecs`` block; the all-gathers are the head's
    and, per attention layer, the partials' combine over data (jamba) or
    the new token's heads over ``model`` (qwen2.5-3b, whose partials are
    combined by an all-to-all by head over data and ``model``)."""
    cfg = ARCHS[name].reduced()
    shape = ShapeConfig("long", "decode", 64, 1)
    with _world("2x4") as (mesh, amesh):
        rec = dryrun.run_cell(cfg, shape, mesh)
        _hold_record(rec, REF_ARCHS[name].reduced(), shape, mesh)
        held = _cache_bytes(cfg, shape, mesh)
    assert rec["status"] == "ok"
    assert held == _ref_cache_bytes(REF_ARCHS[name].reduced(), shape, amesh)
    assert rec["collectives"]["all-gather"]["count"] == gathers
    assert rec["collectives"].get("all-to-all", {"count": 0})["count"] \
        == exchanges


@pytest.mark.parametrize("name", SHARED)
def test_run_cell_on_every_reduced_arch(name):
    """The reference test's cells (the reduced arch, (2, 4), 64 tokens, 8
    rows) of the three kinds: a record of the reference's keys, its
    analytic fields equal to the reference's, finite roofline terms and
    the head's all-gather over ``model``."""
    cfg = ARCHS[name].reduced()
    with _world("2x4") as (mesh, _):
        for shape in REDUCED_SHAPES:
            rec = dryrun.run_cell(cfg, shape, mesh)
            _hold_record(rec, REF_ARCHS[name].reduced(), shape, mesh)
            assert rec["status"] == "ok" and rec["mesh"] == "2x4"
            r = rec["roofline"]
            assert all(np.isfinite(r[k]) and r[k] >= 0
                       for k in ("compute_s", "memory_s", "collective_s"))
            assert r["flops"] > 0 and rec["memory"]["live_bytes"] > 0
            assert rec["memory"]["cpu_f32_twin_bytes"] == 0
            assert rec["memory"]["live_bytes_device_estimate"] == \
                rec["memory"]["live_bytes"]
            assert rec["collectives"]["all-gather"]["count"] >= 1


FOLD_CASES = [("qwen2.5-3b", ShapeConfig("t", "train", 64, 16), 4),
              ("jamba-v0.1-52b", ShapeConfig("t", "train", 32, 8), 2),
              ("qwen2.5-3b", ShapeConfig("p", "prefill", 3072, 2), None),
              ("jamba-v0.1-52b", ShapeConfig("p", "prefill", 64, 8), None)]


@pytest.mark.parametrize("name,shape,n_micro", FOLD_CASES,
                         ids=["qwen-train-4", "jamba-train-2",
                              "qwen-prefill-tiles", "jamba-prefill-scan"])
def test_folded_capture_gives_the_unrolled_record(name, shape, n_micro):
    """The shortcut of ``run_cell`` (``fold=True``: a train step's
    microbatches, and with grad disabled the scan's time steps and the
    blockwise attention's tiles, captured once and counted for all)
    against the unrolled capture: every field of the record the same but
    the capture's own time."""
    cfg = ARCHS[name].reduced()
    with _world("2x4") as (mesh, _):
        folded = dryrun.run_cell(cfg, shape, mesh, n_micro=n_micro,
                                 fold=True)
        unrolled = dryrun.run_cell(cfg, shape, mesh, n_micro=n_micro,
                                   fold=False)
    for rec in (folded, unrolled):
        rec.pop("lower_s")
        rec.pop("compile_s")
    assert folded == unrolled
    if n_micro:
        assert folded["n_micro"] == n_micro


def _spec_tuple(s) -> tuple:
    """A reference ``PartitionSpec`` as the port's spec tuple."""
    from repro_torch.parallel.sharding import spec
    return spec(*tuple(s))


@pytest.mark.parametrize("mesh_name", PRODUCTION + ["2x2", "1x4"])
def test_fsdp_seq_specs_match_the_reference(mesh_name):
    """Every leaf of all ten archs at full width: the port's
    ``fsdp_seq_specs`` is the reference dry run's pure-FSDP layout,
    ``sanitize_pspecs(zero1_pspecs(params, P()-tree, axes=data + model))``,
    and every arch has leaves it splits."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.parallel.sharding import sanitize_pspecs
    from repro_torch.models.factory import abstract_leaves
    from repro_torch.parallel.sharding import data_axes, fsdp_seq_specs
    with _world(mesh_name) as (mesh, amesh):
        for name in SHARED:
            params = _ref_params(REF_ARCHS[name])
            base = jax.tree.map(lambda _: P(), params)
            axes = tuple(ref_par.data_axes(amesh)) + ("model",)
            want = jax.tree.leaves(
                sanitize_pspecs(params, ref_par.zero1_pspecs(
                    params, base, amesh, axes=axes), amesh),
                is_leaf=lambda x: isinstance(x, P))
            got = fsdp_seq_specs(abstract_leaves(ARCHS[name]), mesh)
            assert got == [_spec_tuple(w) for w in want], name
            assert any(data_axes(mesh)[0] in str(g) for g in got), name


@pytest.mark.parametrize("mesh_name", PRODUCTION)
def test_build_step_fsdp_seq_meta_matches_the_reference(mesh_name):
    """Every cell's ``meta`` under ``layout="fsdp_seq"``: FSDP always (the
    reference's ``used_fsdp = True``), the optimizer and the microbatches
    as under ``"tp"``."""
    with _world(mesh_name) as (mesh, amesh):
        for cfg, shape in _cells():
            _, _, meta = dryrun.build_step(cfg, shape, mesh, device="cpu",
                                           layout="fsdp_seq", abstract=True)
            want = dict(_reference_meta(cfg.name, shape, amesh), fsdp=True)
            assert meta == want, (cfg.name, shape.name)


SEQ_CELLS = [("qwen2.5-3b", "train_4k"), ("qwen2.5-3b", "prefill"),
             ("qwen2.5-3b", "decode"), ("jamba-v0.1-52b", "prefill")]


@pytest.mark.parametrize("name,kind", SEQ_CELLS,
                         ids=["qwen-train", "qwen-prefill", "qwen-decode",
                              "jamba-prefill"])
def test_run_cell_fsdp_seq_has_no_per_layer_all_reduce(name, kind):
    """``run_cell`` under ``"fsdp_seq"`` on the reduced arch at (2, 4):
    the reference's keys and analytic fields, FSDP, and the weights
    all-gathered per layer with no tensor-parallel all-reduce: prefill and
    decode run none, and a train step's all-reduces (the loss, the data
    ranks' scalars) do not grow with the depth."""
    shape = {s.name: s for s in REDUCED_SHAPES}[kind]
    recs = []
    with _world("2x4") as (mesh, _):
        for n_layers in (2, 4) if kind == "train_4k" else (2,):
            cfg = ARCHS[name].reduced().replace(n_layers=n_layers)
            rec = dryrun.run_cell(cfg, shape, mesh, layout="fsdp_seq")
            _hold_record(rec, REF_ARCHS[name].reduced().replace(
                n_layers=n_layers), shape, mesh)
            assert rec["status"] == "ok" and rec["fsdp"] is True
            assert rec["collectives"]["all-gather"]["count"] >= 2 * n_layers
            recs.append(rec)
    counts = [r["collectives"].get("all-reduce", {}).get("count", 0)
              for r in recs]
    if kind == "train_4k":
        assert counts[0] == counts[1] > 0
        assert recs[1]["collectives"]["all-gather"]["count"] > \
            recs[0]["collectives"]["all-gather"]["count"]
    else:
        assert counts == [0]


def test_perf_cell_prints_run_cells_terms():
    """``python -m repro_torch.launch.perf_cell`` on ``qwen2.5-3b x
    decode_32k`` (2 layers, ``fsdp_seq``) in a subprocess (its own fake
    group of 256 ranks): the reference script's keys with ``live_tpu_GB``
    renamed, and the values of ``run_cell``'s record of the same cell."""
    from repro_torch.launch import perf_cell
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.perf_cell", "--arch",
         "qwen2.5-3b", "--shape", "decode_32k", "--set", "n_layers=2",
         "--layout", "fsdp_seq"], env=env, capture_output=True, text=True,
        timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout)
    assert set(got) == {"overrides", "n_micro", "compute_s", "memory_s",
                        "collective_s", "dominant", "wire_GB",
                        "live_device_GB", "roofline_fraction",
                        "useful_ratio", "compile_s"}
    cfg = ARCHS["qwen2.5-3b"].replace(n_layers=2)
    with _world("16x16") as (mesh, _):
        rec = dryrun.run_cell(cfg, SHAPES["decode_32k"], mesh,
                              layout="fsdp_seq", retry=False)
    want = perf_cell.summary(rec, {"n_layers": 2}, 0.0)
    got.pop("compile_s")
    want.pop("compile_s")
    assert got == want


def test_cli_writes_a_record_and_its_graph(tmp_path):
    """``main`` over one cell writes the record and, with ``--graphs``,
    the step's graph code; it initialises its own fake group of 256 ranks,
    so it runs in a subprocess."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-3b", "--shape", "decode_32k", "--out", str(tmp_path),
         "--graphs"], env=env, capture_output=True, text=True, timeout=300,
        cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[ok]   qwen2.5-3b x decode_32k @ 16x16" in out.stdout
    rec = json.loads((tmp_path / "16x16" /
                      "qwen2.5-3b__decode_32k.json").read_text())
    assert rec["status"] == "ok" and rec["compile_s"] > 0
    assert (tmp_path / "16x16" / "graph" /
            "qwen2.5-3b__decode_32k.py.gz").stat().st_size > 0
