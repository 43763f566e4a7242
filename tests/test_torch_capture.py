"""Captured PyTorch steps (``repro_torch.core.graph``) against the JAX
package's compiled programs.

The JAX side compiles on 4 host devices, so it runs once per module in a
subprocess with ``XLA_FLAGS`` set before jax starts (as
``test_torch_comm.py`` does) and hands back each program's HLO text and
cost analysis; both packages' parsers read those texts in this process.
Held here:

* the stencil step and the 5-step runner on a 2x2 grid: the same
  ``collective-permute`` list (one rank's strip, group 1, the runner's
  trip count), dropped alike by ``min_group`` and with the same
  ``wire_bytes``;
* HPCG's PCG on 4 ranks (16^3, 3 iterations): the reference's multiset of
  (kind, bytes, group, multiplier), and the priced sites at rtol 1e-9;
* the message-free stencil step and PCG: the reference's lists less the
  window's all-gathers, which the port does not record (its window is
  loads), and nothing else;
* functional ``all_reduce`` / ``all_gather`` / ``reduce_scatter`` under a
  fake 4-rank process group against ``psum`` / ``all_gather`` /
  ``psum_scatter`` in ``shard_map``; the in-place API the parallel layer
  calls (``parallel.transport``) recorded as the functional form records
  the same step, and leaving the transport's counters alone;
* the flops of the scanned ``tanh(x @ w)`` (2 M K K L on both sides) and of
  the static engine's steps, and the port's byte count on a three-node
  graph, pinned by hand.
"""
import collections
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as pt
from repro_torch.apps.hpcg import torch_impl as hpcg
from repro_torch.apps.stencil import torch_impl as stencil
from repro_torch.comm import collectives, grid_mesh
from repro_torch.core.advisor import bundle_from_collectives
from repro_torch.core.graph import capture, graph_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-9
M, N = 16, 8                     # per-rank shape of the collective programs

_JAX = """
import json, sys
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import normalize_cost_analysis, shard_map
from repro.comm.topology import grid_mesh
from repro.apps.stencil import jax_impl as st
from repro.apps.hpcg import jax_impl as hp
M, N = int(sys.argv[2]), int(sys.argv[3])
out = {}

def keep(name, compiled):
    out[name] = {"text": compiled.as_text(),
                 "cost": {k: float(v) for k, v in
                          normalize_cost_analysis(compiled).items()
                          if k in ("flops", "bytes accessed")}}

mesh = grid_mesh(2, 2)
plane = jax.ShapeDtypeStruct((64, 64), jnp.float32)
keep("stencil_step", st.make_step(mesh).lower(plane).compile())
keep("stencil_run", st.make_runner(mesh).lower(plane, n_steps=5).compile())
keep("stencil_step_mf",
     st.make_step(mesh, "message_free").lower(plane).compile())
zmesh = jax.make_mesh((4,), ("z",))
lat = jax.ShapeDtypeStruct((16, 16, 16), jnp.float32)
keep("cg", hp.make_cg(zmesh, n_iter=3).lower(lat, lat).compile())
keep("cg_mf",
     hp.make_cg(zmesh, "message_free", n_iter=3).lower(lat, lat).compile())
x = jax.ShapeDtypeStruct((4 * M, N), jnp.float32)
for name, fn, spec in (
        ("psum", lambda t: jax.lax.psum(t, "z"), P()),
        ("all_gather", lambda t: jax.lax.all_gather(t, "z", tiled=True),
         P()),
        ("psum_scatter", lambda t: jax.lax.psum_scatter(
            t, "z", scatter_dimension=0, tiled=True), P("z"))):
    f = jax.jit(shard_map(fn, mesh=zmesh, in_specs=P("z"), out_specs=spec,
                          check_vma=False))
    keep(name, f.lower(x).compile())
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """{name: {"text", "cost"}} of the JAX package's compiled programs."""
    path = tmp_path_factory.mktemp("capture") / "programs.json"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX),
                           str(path), str(M), str(N)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(path.read_text())


def _sig(ops) -> collections.Counter:
    return collections.Counter((o.kind, o.result_bytes, o.group_size,
                                o.multiplier) for o in ops)


def _bundles_alike(got_ops, prog):
    """The port's shared body on the captured ops and the reference's
    ``synthesize_bundle`` on the HLO text, with the reference's flops and
    bytes on both sides (the port's unfused byte count is its own)."""
    want = ref.synthesize_bundle(prog["text"], prog["cost"],
                                 ref.ModelParams.tpu_v5e_ici())
    got = bundle_from_collectives(got_ops, want.meta["flops"],
                                  want.meta["hbm_bytes"],
                                  pt.ModelParams.tpu_v5e_ici())
    return got, want


@pytest.mark.parametrize("name", ["stencil_step", "stencil_run"])
def test_stencil_collectives_match(programs, name):
    prog = programs[name]
    ref_ops = ref.hlo.parse_collectives(prog["text"])
    assert [vars(o) for o in pt.hlo.parse_collectives(prog["text"])] \
        == [vars(o) for o in ref_ops]
    grid = grid_mesh(2, 2, device="cpu")
    plane = stencil.init_plane(64, 64, device="cpu")
    if name == "stencil_step":
        step = capture(stencil.make_step(grid), stencil.to_tiles(plane, grid))
    else:
        step = capture(stencil.make_runner(grid), plane, 5)
    ops = step.collectives()
    trips = 1.0 if name == "stencil_step" else 5.0
    assert _sig(ops) == _sig(ref_ops) == collections.Counter(
        {("collective-permute", 32 * 4, 1, trips): 4})
    got, want = _bundles_alike(ops, prog)
    assert got.call_sites == {} and want.call_sites == {}    # min_group
    assert got.meta["wire_bytes"] == want.meta["wire_bytes"] \
        == 4 * 128 * trips
    assert step.roofline().wire_bytes == want.meta["wire_bytes"]


@pytest.mark.parametrize("name", ["stencil_step", "cg"])
def test_message_free_drops_only_the_window(programs, name):
    """The JAX package's message-free emulation builds its window with an
    all-gather per exchange (each rank's two boundary strips, gathered
    over the g ranks of the axis), which its advisor prices (g >= 2).  The
    port's window is loads from the stacked strips and records none.
    Against the JAX HLO: the captures differ by exactly those all-gathers
    and agree on the rest; so the reference prices the window's sites and
    the port does not.  There is one all-gather for each pair of the
    message-based program's permutes, except where XLA folds it: each
    V-cycle level's first smooth starts from zeros, so its exchange
    gathers a constant plane, which XLA replaces by a broadcast (HPCG's
    two levels, in the loop and before it)."""
    based = _sig(ref.hlo.parse_collectives(programs[name]["text"]))
    prog = programs[name + "_mf"]
    free = ref.hlo.parse_collectives(prog["text"])
    assert [vars(o) for o in pt.hlo.parse_collectives(prog["text"])] \
        == [vars(o) for o in free]
    if name == "stencil_step":
        g, folded = 2, collections.Counter()
        grid = grid_mesh(2, 2, device="cpu")
        step = capture(stencil.make_step(grid, "message_free"),
                       stencil.to_tiles(stencil.init_plane(64, 64,
                                                           device="cpu"),
                                        grid))
    else:
        g = 4
        folded = collections.Counter({("all-gather", 4 * 2 * plane, 4, m): 1
                                      for plane in (1024, 256)
                                      for m in (3.0, 1.0)})
        b = hpcg.make_problem((16, 16, 16), device="cpu")
        step = capture(hpcg.make_cg(grid_mesh(4, device="cpu"),
                                    "message_free", n_iter=3),
                       b, torch.zeros_like(b))
    window = collections.Counter(
        {("all-gather", g * 2 * nbytes, g, mult): count // 2
         for (kind, nbytes, _, mult), count in based.items()
         if kind == "collective-permute"}) - folded
    free_sig = _sig(free)
    assert collections.Counter({k: v for k, v in free_sig.items()
                                if k[0] == "all-gather"}) == window
    assert _sig(step.collectives()) == free_sig - window
    got, want = _bundles_alike(step.collectives(), prog)
    kinds = collections.Counter(c.split("@")[0] for c in want.call_sites)
    assert kinds["all-gather"] == sum(window.values())
    kinds.pop("all-gather")
    assert collections.Counter(c.split("@")[0] for c in got.call_sites) \
        == kinds


def test_hpcg_collectives_match(programs):
    prog = programs["cg"]
    ref_ops = ref.hlo.parse_collectives(prog["text"])
    assert [vars(o) for o in pt.hlo.parse_collectives(prog["text"])] \
        == [vars(o) for o in ref_ops]
    grid = grid_mesh(4, device="cpu")
    b = hpcg.make_problem((16, 16, 16), device="cpu")
    step = capture(hpcg.make_cg(grid, n_iter=3), b, torch.zeros_like(b),
                   name="solve")
    ops = step.collectives()
    want_sig = collections.Counter({
        ("collective-permute", 1024, 1, 3.0): 8,
        ("collective-permute", 1024, 1, 1.0): 8,
        ("collective-permute", 256, 1, 3.0): 2,
        ("collective-permute", 256, 1, 1.0): 2,
        ("all-reduce", 4, 4, 3.0): 2, ("all-reduce", 4, 4, 1.0): 2})
    assert _sig(ops) == _sig(ref_ops) == want_sig

    got, want = _bundles_alike(ops, prog)
    assert got.meta == want.meta
    pg = pt.CommAdvisor().default_grid(4, 3)
    rg = ref.CommAdvisor().default_grid(4, 3)
    g = pt.price(got, pg, plan="numpy")
    w = ref.price(want, rg, plan=ref.ExecPlan("numpy"))
    assert len(g.call_ids) == len(w.call_ids) == 4

    def by_site(res, bundle):
        keys = [(bundle.call_sites[c].meta["result_bytes"],
                 bundle.call_sites[c].meta["multiplier"])
                for c in res.call_ids]
        return np.argsort(keys, axis=0, kind="stable")[:, 1], keys

    gi, gk = by_site(g, got)
    wi, wk = by_site(w, want)
    assert sorted(gk) == sorted(wk)
    for f in pt.MATRIX_FIELDS:
        a, r = getattr(g, f), getattr(w, f)
        if a.ndim == 2:
            a, r = a[:, gi], r[:, wi]
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=0.0, err_msg=f)


@pytest.fixture(scope="module")
def fake_group():
    """A fake 4-rank process group (no peers: collectives only trace)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["psum", "all_gather", "psum_scatter"])
def test_functional_collectives_match(programs, fake_group, name):
    import torch.distributed._functional_collectives as fc
    fns = {"psum": lambda t: fc.all_reduce(t, "sum", fake_group),
           "all_gather": lambda t: fc.all_gather_tensor(t, 0, fake_group),
           "psum_scatter": lambda t: fc.reduce_scatter_tensor(
               t, "sum", 0, fake_group)}
    step = capture(lambda t: fns[name](t) * 2.0, torch.zeros(M, N))
    ref_ops = ref.hlo.parse_collectives(programs[name]["text"])
    assert _sig(step.collectives()) == _sig(ref_ops)
    assert len(ref_ops) == 1 and ref_ops[0].group_size == 4
    got, want = _bundles_alike(step.collectives(), programs[name])
    assert got.meta == want.meta
    assert len(got.call_sites) == len(want.call_sites) == 1
    pg = pt.CommAdvisor().default_grid(3, 2)
    g = pt.price(got, pg, plan="numpy")
    w = ref.price(want, ref.CommAdvisor().default_grid(3, 2),
                  plan=ref.ExecPlan("numpy"))
    for f in pt.MATRIX_FIELDS:
        np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=RTOL,
                                   atol=0.0, err_msg=f)


def test_all_to_all_and_wait_are_recorded_alike(fake_group):
    """``all_to_all_single`` is an ``all-to-all`` of the group; the
    ``wait_tensor`` nodes are not ops."""
    import torch.distributed._functional_collectives as fc
    step = capture(lambda t: fc.all_to_all_single(t, None, None,
                                                  fake_group) + 1.0,
                   torch.zeros(M, N))
    assert [(o.kind, o.result_bytes, o.group_size, o.multiplier)
            for o in step.collectives()] == [("all-to-all", M * N * 4, 4,
                                              1.0)]
    assert "wait_tensor" in step.as_text()


def _transport_step(t, group):
    """all-reduce, all-gather (list form and into one tensor, along dim 1)
    and a reduce-scatter along dim 1, through ``parallel.transport``."""
    from repro_torch.parallel import transport
    x = transport.all_reduce(t.clone(), group)
    y = transport.all_gather(x, group)
    z = transport.all_gather_dim(x, group, 1)
    w = transport.reduce_scatter_dim(z, group, 1)
    return w.sum() + y.sum()


def _functional_step(t, group):
    """:func:`_transport_step` written with the functional collectives."""
    import torch.distributed._functional_collectives as fc
    x = fc.all_reduce(t, "sum", group)
    y = fc.all_gather_tensor(x, 0, group)
    z = fc.all_gather_tensor(x.movedim(1, 0).contiguous(), 0, group)
    w = fc.reduce_scatter_tensor(z, "sum", 0, group)
    return w.sum() + y.sum()


def test_transport_collectives_record_as_functional_ones(fake_group):
    """The in-place ``c10d::*_`` ops that ``parallel.transport`` reaches
    record the same ``(kind, result bytes, group, multiplier)`` as the
    functional collectives of the same step, in the same order."""
    t = torch.zeros(M, N)
    got = capture(lambda x: _transport_step(x, fake_group), t)
    want = capture(lambda x: _functional_step(x, fake_group), t)
    sig = [(o.kind, o.result_bytes, o.group_size, o.multiplier)
           for o in got.collectives()]
    assert sig == [(o.kind, o.result_bytes, o.group_size, o.multiplier)
                   for o in want.collectives()]
    assert sig == [("all-reduce", M * N * 4, 4, 1.0),
                   ("all-gather", 4 * M * N * 4, 4, 1.0),
                   ("all-gather", 4 * M * N * 4, 4, 1.0),
                   ("reduce-scatter", M * N * 4, 4, 1.0)]
    assert {"c10d::allreduce_", "c10d::allgather_",
            "c10d::_allgather_base_", "c10d::_reduce_scatter_base_"} \
        <= set(got.ops)
    got.graph_module          # the graph holds the same four collectives


def test_capture_leaves_transport_counters_alone(fake_group):
    """A capture runs nothing, so ``transport.routes`` and ``volume`` do
    not move; ``transport.as_counted`` gives what a run would count."""
    from repro_torch.parallel import transport
    before = transport.snapshot()
    step = capture(lambda x: _transport_step(x, fake_group),
                   torch.zeros(M, N))
    assert transport.snapshot() == before
    assert transport.since(before) == {}
    assert transport.as_counted(step.collectives()) == {
        "all_reduce": (1, M * N * 4), "all_gather": (2, 2 * M * N * 4),
        "reduce_scatter": (1, 4 * M * N * 4)}


def test_scanned_matmul_flops_match():
    """``test_hlo_advisor.py``'s scanned ``tanh(x @ w)``: FX unrolls the
    loop, so the flops are 2 M K K L on both sides."""
    import jax
    import jax.numpy as jnp
    from repro.compat import normalize_cost_analysis
    L, Mx, K = 6, 16, 32

    def f(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, ws)[0]

    compiled = jax.jit(f).lower(
        jax.ShapeDtypeStruct((Mx, K), jnp.float32),
        jax.ShapeDtypeStruct((L, K, K), jnp.float32)).compile()
    want, _ = ref.hlo.loop_corrected_cost(normalize_cost_analysis(compiled),
                                          compiled.as_text())

    def g(x, ws):
        for w in ws.unbind(0):
            x = torch.tanh(x @ w)
        return x

    step = capture(g, torch.zeros(Mx, K), torch.zeros(L, K, K))
    assert step.cost()["flops"] == want == 2 * Mx * K * K * L


def test_bytes_pinned_by_hand():
    """Three nodes: ``mm`` reads x and w and writes (4, 8); ``tanh`` reads
    and writes (4, 8); the transpose is a view and moves nothing."""
    step = capture(lambda x, w: torch.tanh(x @ w).t(), torch.zeros(4, 16),
                   torch.zeros(16, 8))
    calls = [n for n in step.graph_module.graph.nodes
             if n.op == "call_function"]
    assert len(calls) == 3
    f32 = 4
    assert step.cost() == {"flops": 2.0 * 4 * 16 * 8,
                           "bytes accessed": float(
                               (4 * 16 + 16 * 8 + 4 * 8) * f32
                               + (4 * 8 + 4 * 8) * f32)}


def test_pass_and_graph_agree():
    """The pass's op counts, bytes and collectives are the graph's (the
    graph is traced on demand, over the same fake inputs)."""
    grid = grid_mesh(2, 2, device="cpu")
    tiles = stencil.to_tiles(stencil.init_plane(64, 64, device="cpu"), grid)
    b = hpcg.make_problem((16, 16, 16), device="cpu")
    for step in (capture(stencil.make_step(grid), tiles),
                 capture(hpcg.make_cg(grid_mesh(4, device="cpu"), n_iter=2),
                         b, torch.zeros_like(b))):
        gm = step.graph_module
        nodes = collections.Counter(
            n.target.name() for n in gm.graph.nodes
            if n.op == "call_function" and hasattr(n.target, "name"))
        assert nodes == step.ops
        assert graph_bytes(gm) == step.cost()["bytes accessed"]
        assert step.graph_module is gm            # traced once


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "falcon-mamba-7b",
                                  "jamba-v0.1-52b", "phi3.5-moe-42b-a6.6b"])
def test_engine_step_flops_match(arch):
    """The static engine's captured steps against the reference's compiled
    ones: equal flops for the dense and SSM archs.  The reference computes
    each routing choice's capacity rank as an einsum over the experts
    (2 E flops a token a choice a MoE layer), which the port computes as a
    cumsum and a gather; that is the whole difference."""
    from _torch_serve_ref import pair
    from repro.compat import normalize_cost_analysis
    from repro.serve import ServeEngine as RefServe
    from repro_torch.models import blocks
    from repro_torch.serve import ServeEngine

    ref_model, params, model = pair(arch)
    want = RefServe(model=ref_model, params=params, max_len=24) \
        .compiled_steps(batch_size=2, prompt_len=8)
    got = ServeEngine(model=model, max_len=24).compiled_steps(
        batch_size=2, prompt_len=8)
    cfg = model.cfg
    moe_layers = sum(s.ffn == "moe" for s in blocks.layer_specs(cfg))
    for key, tokens in (("prefill@8", 16), ("decode", 2)):
        flops, _ = ref.hlo.loop_corrected_cost(
            normalize_cost_analysis(want[key]), want[key].as_text())
        rank = 2 * cfg.n_experts * cfg.experts_per_token * moe_layers * tokens
        assert got[key].cost()["flops"] + rank == flops
        assert got[key].collectives() == []


def test_kernels_are_one_node_each_and_launch_nothing():
    """A kernels-on prefill captures each kernel as one custom-op node;
    the capture runs nothing, so the launch counters stay put."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.models import blocks, make_model
    from repro_torch.serve import ServeEngine

    cfg = configs.get_arch("jamba-v0.1-52b").reduced()
    model = make_model(cfg, device="cpu", use_kernel=True)
    before = (flash_attention.launches, mamba_scan.launches)
    steps = ServeEngine(model, max_len=32).compiled_steps(2, 16)
    targets = collections.Counter(
        n.target.name() for n in steps["prefill@16"].graph_module.graph.nodes
        if n.op == "call_function" and hasattr(n.target, "name"))
    specs = blocks.layer_specs(cfg)
    assert targets["repro_torch::flash_attention"] \
        == sum(s.mixer == "attn" for s in specs)
    assert targets["repro_torch::mamba_scan"] \
        == sum(s.mixer == "mamba" for s in specs)
    assert "repro_torch::flash_attention" not in {
        n.target.name() for n in steps["decode"].graph_module.graph.nodes
        if n.op == "call_function" and hasattr(n.target, "name")}
    assert (flash_attention.launches, mamba_scan.launches) == before


def test_standin_ops_equal_the_plain_path():
    """Run eagerly, the stand-in ops give bit for bit the plain operations
    they stand for: a gather of rank slices and a sum in rank order."""
    from repro_torch.comm import message_based
    from repro_torch.comm.topology import shift_perm
    x = torch.randn(4, 3, 5, generator=torch.Generator().manual_seed(1))
    src = [0] * 4
    for i, j in shift_perm(4, +1):
        src[j] = i
    assert torch.equal(message_based.ppermute(x, 0, shift_perm(4, +1)),
                       x.index_select(0, torch.tensor(src)))
    assert torch.equal(collectives.ppermute(x, 1, [2, 0, 1], 2),
                       x.index_select(1, torch.tensor([2, 0, 1])))
    part = torch.randn(8, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(2))
    want = part[0]
    for p in part[1:]:
        want = want + p
    assert torch.equal(collectives.rank_sum(part), want)
    one = part[:1]
    assert torch.equal(collectives.rank_sum(one), one[0])


def test_roofline_takes_each_dtypes_peak():
    """The compute term takes each dtype's flops at that dtype's peak on
    the H100 (float32 outside the tensor cores, bf16 on them); on the
    TPU spec, as in the HLO's roofline, every flop at the bf16 peak."""
    a, b = torch.zeros(64, 128), torch.zeros(128, 256)
    step = capture(lambda a, b, c, d: (a @ b, c @ d), a, b, a.bfloat16(),
                   b.bfloat16())
    f = 2 * 64 * 128 * 256
    assert step.flops_by_dtype == {"float32": f, "bfloat16": f}
    assert step.flops == 2 * f
    assert step.roofline().compute_s == f / 67e12 + f / 989e12
    assert step.roofline(pt.TPU_V5E).compute_s \
        == f / 197e12 + f / 197e12


def test_step_lets_go_of_fn_once_traced():
    """A captured step keeps the fakes of its arguments, not the tensors,
    and holds ``fn`` (here, what holds the weights) only until its graph
    is traced."""
    import gc
    import weakref

    class Holder:
        def __init__(self):
            self.w = torch.zeros(16, 8)

        def __call__(self, x):
            return x @ self.w

    h, x = Holder(), torch.zeros(4, 16)
    held, arg = weakref.ref(h), weakref.ref(x)
    step = capture(h, x)
    del h, x
    gc.collect()
    assert arg() is None and held() is not None
    assert "mm" in step.as_text()
    gc.collect()
    assert held() is None
    assert step.cost()["flops"] == 2 * 4 * 16 * 8
