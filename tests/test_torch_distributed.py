"""The port's parallel layer over real ``torch.distributed`` ranks (gloo on
the CPU, each rank a spawned process; ``tests/_torch_ranks.py`` holds the
rank programs) against the JAX package on the same numpy inputs:

* ``pipeline_apply`` against the reference test's sequential oracle
  (``tests/test_distributed.py``: L 4, D 16, M 6, B 3 on (pod 2, data 2)),
  output at 1e-5 and gradients at 1e-4;
* ``compressed_psum`` on 4 ranks against the reference's (run under
  ``jax.vmap`` with a named axis): int8 payloads and scales exact, sums at
  1e-6, and the reference test's error-feedback bounds over 5 steps;
* ``moe_ffn_ep_local`` on (1, 2), (1, 4) and (2, 2) meshes against the
  reference's ``moe_ffn_scatter`` on each data shard and its
  ``moe_ffn_dense`` (reduced phi3.5-moe, capacity factor 8), and the whole
  model's every parameter gradient against the single-process scatter's;
* the DP + ZeRO-1 train step of the reduced qwen2.5-3b and jamba on 2 and
  4 data ranks against the port's 1-rank step;
* the elastic restore (saved on (1, 4), restored on (2, 2));
* the multi-rank ``"distributed"`` sweep on 1, 2 and 4 ranks (S = 37,
  chunk 10) and the adaptive sweep's shard bound (the reference test's
  1M-scenario case at a 262,144-scenario seed: the CPU time);
* one ``torchrun`` run of the train CLI on 2 gloo ranks.

Each world (4 ranks, 2 ranks) runs once per module and checks several
things; it is joined within a time limit, after which its ranks are killed
and the test fails."""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref
from repro.configs import ARCHS
from repro.models import moe as ref_moe
from repro.parallel.pipeline import compressed_psum as ref_compressed_psum
import repro_torch.core as pt
from repro_torch.configs import get_arch
from repro_torch.models import make_inputs, make_model
from repro_torch.models.config import ShapeConfig
from repro_torch.models.convert import reference_leaves
from repro_torch.train import make_data
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         cosine_schedule)

sys.path.insert(0, os.path.dirname(__file__))
import _torch_ranks as ranks                             # noqa: E402
from test_sweep_backends import small_bundle             # noqa: E402
from test_torch_sweep import _port_counters, _ref_fields  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
L, D, M, B = 4, 16, 6, 3                  # the reference pipeline test
MOE_SHAPE = (4, 16)                       # (batch, seq) of the EP checks
EP_MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
TRAIN_ARCHS = ("qwen2.5-3b", "jamba-v0.1-52b")
TRAIN_STEPS, TRAIN_SEQ = 2, 16
# the seed of the reference's 1M-scenario adaptive sweep is 500,000; the
# CPU time of the 4-rank world keeps it at 262,144 (524,288 priced), which
# still holds the reference's bound chunk < scenarios / 7
S_BIG = 262_144
BIG_PLAN = "distributed:device=cpu,devices=4,topk=64,refine=1"


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "ws": (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32),
        "xs": rng.normal(size=(M, B, D)).astype(np.float32),
        "psum": rng.normal(size=(5, 4, 64)).astype(np.float32),
    }


def _moe_inputs():
    cfg = get_arch("phi3.5-moe-42b-a6.6b").reduced()
    rng = np.random.default_rng(1)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.normal(size=(d, E)) / np.sqrt(d),
         "w_gate": rng.normal(size=(E, d, f)) / np.sqrt(d),
         "w_up": rng.normal(size=(E, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(E, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(*MOE_SHAPE, d)).astype(np.float32)
    batch = make_inputs(cfg.replace(capacity_factor=8.0),
                        ShapeConfig("t", "train", MOE_SHAPE[1], MOE_SHAPE[0]),
                        device="cpu")
    return p, x, {k: v.numpy() for k, v in batch.items()}


@pytest.fixture(scope="module")
def bundle():
    rcb = ref.compile_bundle(small_bundle())
    pcb = pt.compiled_bundle_from_arrays(
        _ref_fields(rcb), counters=_port_counters(rcb.counters),
        sampling_period=rcb.sampling_period, call_ids=rcb.call_ids)
    return rcb, pcb


def _sweep_cases(n):
    cases = [(37, 4, f"distributed:device=cpu,topk=9,chunk=10,devices={n}")]
    if n == 4:
        cases.append((S_BIG, 1, BIG_PLAN))
    return cases


def _parts(n, tmp):
    inp = _inputs()
    p, x, batch = _moe_inputs()
    parts = []
    if n == 4:
        parts += [("pipeline", {"ws": inp["ws"], "xs": inp["xs"]}),
                  ("compressed", {"xs": inp["psum"]}),
                  ("elastic", {"directory": str(tmp / "ckpt")})]
    for shape in EP_MESHES[n]:
        parts += [(f"ep_moe:{shape}", {"shape": shape, "p": p, "x": x}),
                  (f"ep_grads:{shape}", {"shape": shape, "batch": batch,
                                         "seed": 0})]
    for arch in TRAIN_ARCHS:
        for zero1 in (True, False):
            parts.append((f"dp_train:{arch}:{zero1}",
                          {"arch": arch, "zero1": zero1,
                           "steps": TRAIN_STEPS, "seq": TRAIN_SEQ}))
    return parts


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, bundle):
    """The 2- and 4-rank worlds' results, rank by rank (both worlds run at
    once)."""
    started = {}
    for n in (4, 2):
        tmp = tmp_path_factory.mktemp(f"world{n}")
        parts = _parts(n, tmp) + [("sweep", {"cb": bundle[1],
                                             "cases": _sweep_cases(n)})]
        started[n] = (ranks.start_world(n, "world", tmp, parts=parts), tmp)
    return {n: ranks.join_world(procs, "world", tmp, timeout=300.0)
            for n, (procs, tmp) in started.items()}


def _part(res, name):
    got = res[name]
    assert not (isinstance(got, dict) and "error" in got), got.get("error")
    return got


# --------------------------------------------------------------- pipeline
def test_pipeline_matches_the_sequential_oracle(worlds):
    inp = _inputs()
    ws, xs = jnp.asarray(inp["ws"]), jnp.asarray(inp["xs"])

    def block_fn(w_stack, x):
        def body(c, w):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, w_stack)[0]

    want = jax.vmap(lambda x: block_fn(ws, x))(xs)
    g_want = jax.grad(lambda w: jnp.sum(jax.vmap(
        lambda xi: block_fn(w, xi))(xs) ** 2))(ws)
    grads = {}
    for res in worlds[4]:
        got = _part(res, "pipeline")
        np.testing.assert_allclose(got["out"], np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        grads.setdefault(got["stage"], []).append(got["grad"])
    g = np.concatenate([grads[s][0] for s in sorted(grads)])
    for s, gs in grads.items():                  # both data columns agree
        np.testing.assert_array_equal(gs[0], gs[1])
    np.testing.assert_allclose(g, np.asarray(g_want), atol=1e-4, rtol=1e-4)


def test_compressed_psum_matches_the_reference(worlds):
    xs = _inputs()["psum"]                              # (steps, ranks, n)

    def steps(x):
        def body(res, xi):
            out, new = ref_compressed_psum(xi, "dp", res)
            return new, (out, res)
        _, (outs, res_in) = jax.lax.scan(
            body, jnp.zeros_like(x[0], jnp.float32), x)
        return outs, res_in

    outs, res_in = jax.vmap(steps, in_axes=1, out_axes=1,
                            axis_name="dp")(jnp.asarray(xs))
    # the reference's payloads, by its own arithmetic on its residuals
    target = jnp.asarray(xs) + res_in
    scale = jnp.maximum(jnp.max(jnp.abs(target), axis=-1), 1e-12) / 127.0
    q = jnp.round(target / scale[..., None]).astype(jnp.int8)
    for r, res in enumerate(worlds[4]):
        got = _part(res, "compressed")
        np.testing.assert_array_equal(got["q"], np.asarray(q[:, r]))
        np.testing.assert_array_equal(got["scale"],
                                      np.asarray(scale[:, r]))
        np.testing.assert_allclose(got["out"], np.asarray(outs[:, r]),
                                   rtol=1e-6, atol=1e-6)
        exact = xs.sum(axis=1)
        assert np.abs(got["out"] - exact).max() < 0.2
        assert np.abs(got["out"].cumsum(0) - exact.cumsum(0)).max() < 0.2


# ------------------------------------------------------------------ EP MoE
def _ep_cases():
    return [(n, shape) for n, shapes in EP_MESHES.items()
            for shape in shapes]


@pytest.mark.parametrize("n,shape", _ep_cases(),
                         ids=lambda v: str(v).replace(" ", ""))
def test_ep_local_matches_scatter_per_shard_and_dense(worlds, n, shape):
    p, x, _ = _moe_inputs()
    rcfg = ARCHS["phi3.5-moe-42b-a6.6b"].reduced().replace(
        capacity_factor=8.0)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    n_data = shape[0]
    rows = MOE_SHAPE[0] // n_data
    T = rows * MOE_SHAPE[1]
    dense, _ = ref_moe.moe_ffn_dense(rp, jnp.asarray(
        x.reshape(-1, x.shape[-1])), rcfg)
    dense = np.asarray(dense).reshape(x.shape)
    shard = [ref_moe.moe_ffn_scatter(rp, jnp.asarray(
        x[i * rows:(i + 1) * rows].reshape(T, -1)), rcfg)
        for i in range(n_data)]
    aux = np.mean([float(a) for _, a in shard])
    experts = set()
    for res in worlds[n]:
        got = _part(res, f"ep_moe:{shape}")
        i = got["coord"][0]
        want = np.asarray(shard[i][0]).reshape(got["y"].shape)
        np.testing.assert_allclose(got["y"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["y"], dense[i * rows:(i + 1) * rows],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["aux"], aux, rtol=1e-5)
        experts.add(got["experts"])
    E = rcfg.n_experts
    assert sorted(experts) == [(j * E // shape[1], (j + 1) * E // shape[1])
                               for j in range(shape[1])]


@pytest.mark.parametrize("n,shape", _ep_cases(),
                         ids=lambda v: str(v).replace(" ", ""))
def test_ep_local_gradients_match_single_process_scatter(worlds, n, shape):
    """Every parameter's gradient (the data ranks' mean, as data
    parallelism takes it) against the scatter model's gradient of the mean
    of its per-shard losses; an expert leaf's against its block."""
    _, _, batch = _moe_inputs()
    cfg = get_arch("phi3.5-moe-42b-a6.6b").reduced().replace(
        capacity_factor=8.0)
    model = make_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    n_data = shape[0]
    rows = MOE_SHAPE[0] // n_data
    shards = [{k: torch.tensor(v[i * rows:(i + 1) * rows])
               for k, v in batch.items()} for i in range(n_data)]
    outs = [model(s) for s in shards]
    loss = sum(model.loss(s) for s in shards) / n_data
    names = [nm for nm, _ in model.named_parameters()]
    want = dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters()))))
    n_expert_leaves = 0
    for res in worlds[n]:
        got = _part(res, f"ep_grads:{shape}")
        i, j = got["coord"]
        np.testing.assert_allclose(got["logits"],
                                   outs[i][0].detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert set(got["grads"]) == set(names)
        for nm in names:
            w = want[nm].numpy()
            if got["shapes"][nm] != w.shape:          # this rank's experts
                E_loc = got["shapes"][nm][0]
                w = w[j * E_loc:(j + 1) * E_loc]
                n_expert_leaves += 1
            scale = max(float(np.abs(w).max()), 1e-6)
            np.testing.assert_allclose(got["grads"][nm], w, rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=nm)
    assert n_expert_leaves == 3 * cfg.n_layers * n


# ---------------------------------------------------------- DP + ZeRO-1
_ONE_RANK: dict = {}


def _one_rank(arch, n):
    """The port's 1-rank step over the global batch of ``n`` rows in ``n``
    microbatches (microbatch j = row j, rank j's row)."""
    if (arch, n) not in _ONE_RANK:
        cfg = get_arch(arch).reduced()
        model = make_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        params = reference_leaves(model)
        opt = adamw_init(params)
        step = make_train_step(model.loss, AdamWConfig(**ranks.TRAIN_OPT),
                               n_micro=n)
        data = make_data(cfg, ShapeConfig("t", "train", TRAIN_SEQ, n),
                         seed=0, device="cpu")
        losses = []
        for i in range(TRAIN_STEPS):
            params, opt, m = step(params, opt, data.batch(i))
            losses.append(float(m.loss))
        _ONE_RANK[(arch, n)] = (
            losses, [leaf.value().numpy() for leaf in params],
            sum(x.numel() * x.element_size()
                for k in ("mu", "nu") for x in opt[k]))
    return _ONE_RANK[(arch, n)]


@pytest.mark.parametrize("zero1", [True, False], ids=["zero1", "replicated"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("n", [2, 4])
def test_dp_train_step_matches_one_rank(worlds, n, arch, zero1):
    """Losses and every leaf at 1e-6, but the attention key bias: its
    gradient is zero in exact arithmetic (softmax ignores a shift common to
    all keys), so AdamW's update is the sign of rounding noise, which the
    ranks' sum order (gloo's, not the microbatch loop's) may flip; it is
    held within 2 x the summed learning rates, as in
    ``test_torch_train.py``."""
    losses, leaves, moment_bytes = _one_rank(arch, n)
    opt = AdamWConfig(**ranks.TRAIN_OPT)
    lr_sum = sum(float(cosine_schedule(opt, i + 1))
                 for i in range(TRAIN_STEPS))
    names = [leaf.name for leaf in reference_leaves(make_model(
        get_arch(arch).reduced(), device="cpu"))]
    for res in worlds[n]:
        got = _part(res, f"dp_train:{arch}:{zero1}")
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
        for nm, a, b in zip(names, got["leaves"], leaves):
            if nm.endswith("/bk"):
                assert np.abs(a - b).max() <= 2 * lr_sum * (1 + 1e-6), nm
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                           err_msg=nm)
        if zero1:
            assert got["sharded"] > 0
            assert got["moment_bytes"] < moment_bytes
        else:
            assert got["moment_bytes"] == moment_bytes
    if zero1:   # the blocks tile the moments: together they are whole
        assert sum(_part(r, f"dp_train:{arch}:{zero1}")["moment_bytes"]
                   for r in worlds[n]) >= moment_bytes


def test_elastic_restore_across_meshes(worlds):
    for res in worlds[4]:
        got = _part(res, "elastic")
        assert got["block_err"] == 0.0 and got["gather_err"] == 0.0
        assert got["n_split"] > 0


# ------------------------------------------------------------------ sweep
def _check_against_reference(got, rres, k, count):
    sp = rres.predicted_speedup()
    np.testing.assert_array_equal(got["indices"], rres.topk(k))
    np.testing.assert_allclose(got["speedups"], sp[got["indices"]],
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(got["gain_ns"], rres.gain_ns[got["indices"]],
                               rtol=1e-9, atol=0)
    agg, ragg = got["agg"], ref.SweepAggregates.from_result(rres)
    assert agg["count"] == ragg.count == count
    np.testing.assert_array_equal(agg["hist"], ragg.hist)
    np.testing.assert_array_equal(agg["n_beneficial"], ragg.n_beneficial)
    np.testing.assert_allclose(
        [agg["speedup_mean"], agg["speedup_min"], agg["speedup_max"]],
        [ragg.speedup_mean, ragg.speedup_min, ragg.speedup_max], rtol=1e-9)
    np.testing.assert_allclose(agg["gain_sum"], ragg.gain_sum, rtol=1e-9)


def _stacked(pcb, n, seed, plan):
    g = pt.adaptive_sample(pt.ModelParams.multinode(), n, seed=seed,
                           mpi_transfer=["hockney", "loggp"],
                           cxl_lat_ns=(250.0, 700.0),
                           cxl_atomic_lat_ns=(300.0, 800.0))
    return g, pt.price(pcb, g, plan=plan)


def _same_as_stacked(got, res):
    np.testing.assert_array_equal(got["indices"], res.indices)
    np.testing.assert_array_equal(got["speedups"], res.speedups)
    np.testing.assert_array_equal(got["gain_ns"], res.result.gain_ns)
    assert got["shard_rows"] == res.shard_rows
    for key, val in got["agg"].items():
        np.testing.assert_allclose(val, getattr(res.aggregates, key),
                                   rtol=1e-12, atol=0, err_msg=key)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_rank_sweep_uneven_shards_match_reference(worlds, bundle, n,
                                                  tmp_path):
    """S=37, chunk 10 on 1, 2 and 4 ranks: every rank returns the same
    result, equal to the stacked form's and to the reference's matrix
    pricing (the 1-rank world runs in this process)."""
    rcb, pcb = bundle
    n_s, seed, plan = _sweep_cases(n)[0]
    if n == 1:
        from repro_torch.launch.mesh import init_ranks
        init_ranks("gloo", "cpu", init_method=f"file://{tmp_path}/init",
                   rank=0, world_size=1, timeout_s=60)
        try:
            results = [ranks.sweep(pcb, _sweep_cases(1))]
        finally:
            torch.distributed.destroy_process_group()
    else:
        results = [_part(r, "sweep") for r in worlds[n]]
    g, stacked = _stacked(pcb, n_s, seed, plan)
    ra = ref.adaptive_sample(ref.ModelParams.multinode(), n_s, seed=seed,
                             mpi_transfer=["hockney", "loggp"],
                             cxl_lat_ns=(250.0, 700.0),
                             cxl_atomic_lat_ns=(300.0, 800.0))
    rres = ref.price(rcb, ra)
    for res in results:
        _check_against_reference(res[0], rres, 9, 37)
        _same_as_stacked(res[0], stacked)
        assert res[0]["shard_rows"] == pt.sweep.padded_size(10, n) // n


def test_rank_sweep_million_scenarios_shard_bound(worlds, bundle):
    """The reference test's 1M-scenario adaptive sweep (LHS seed + one
    refined round; here a 262,144 seed) on 4 ranks: every scenario
    counted, each rank holding one chunk's shard at a time, the same
    result as the stacked form on every rank."""
    from repro_torch.core.sweep_kernel import DIST_CHUNK_DEFAULT
    _, stacked = _stacked(bundle[1], S_BIG, 1, BIG_PLAN)
    for r in worlds[4]:
        got = _part(r, "sweep")[1]
        assert got["n_scenarios"] == 2 * S_BIG
        assert got["agg"]["count"] == 2 * S_BIG
        assert len(got["indices"]) == 64
        assert list(got["speedups"]) == sorted(got["speedups"], reverse=True)
        assert got["shard_rows"] == \
            pt.sweep.padded_size(DIST_CHUNK_DEFAULT, 4) // 4
        assert got["shard_rows"] * 4 <= DIST_CHUNK_DEFAULT < (2 * S_BIG) // 7
        _same_as_stacked(got, stacked)


# ------------------------------------------------------------ entry points
def test_train_cli_under_torchrun_on_two_gloo_ranks(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("JAX_PLATFORMS", None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--arch", "qwen2.5-3b", "--reduced", "--steps", "3", "--seq", "16",
           "--batch", "4", "--mesh", "2,1", "--backend", "gloo", "--device",
           "cpu", "--summary", "--ckpt-dir", str(tmp_path / "ck")]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=180, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    assert sorted(d["rank"] for d in lines) == [0, 1]
    assert lines[0]["history"] == [
        {**h, "elapsed_s": lines[0]["history"][i]["elapsed_s"],
         "step_s": lines[0]["history"][i]["step_s"]}
        for i, h in enumerate(lines[1]["history"])]
    assert "final loss" in proc.stdout
    assert (tmp_path / "ck" / "step_00000002" / "manifest.json").exists()


def test_init_ranks_refuses_nccl_with_more_ranks_than_cards(tmp_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="one card per rank"):
        init_ranks("nccl", "cuda", init_method=f"file://{tmp_path}/i",
                   rank=0, world_size=cards + 1)
    assert not dist.is_initialized()        # no group, gloo or other
    with pytest.raises(ValueError, match="unknown backend"):
        init_ranks("mpi", "cpu", init_method=f"file://{tmp_path}/i")
    with pytest.raises(ValueError, match="CUDA devices only"):
        init_ranks("nccl", "cpu", init_method=f"file://{tmp_path}/i")
    assert not dist.is_initialized()


def test_mesh_helpers_need_a_group_of_the_right_size():
    """make_mesh refuses a missing group and a world of another size;
    the production meshes under a fake 256-rank group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as lm
    with pytest.raises(RuntimeError, match="initialized"):
        lm.make_mesh((2, 2), ("data", "model"), "cpu")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        m = lm.make_production_mesh(device_type="cpu")
        assert lm.mesh_axis_sizes(m) == {"data": 16, "model": 16}
        with pytest.raises(ValueError, match="512 ranks"):
            lm.make_production_mesh(multi_pod=True, device_type="cpu")
        with pytest.raises(ValueError, match="differ in length"):
            lm.make_mesh((256,), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_through_host_copies_back_the_outputs_only():
    """The host-staged route (gloo's point-to-point on a CUDA tensor):
    the function sees host copies; only the outputs are written back, so a
    send buffer that autograd saved keeps its version."""
    from repro_torch.parallel.transport import through_host
    src = torch.arange(6.0).tanh()
    dst = torch.full((6,), -1.0)
    untouched = torch.full((3,), 7.0)
    seen = []

    def fn(a, b, c):
        seen.append((a.data_ptr() != src.data_ptr(), b.clone(), c.clone()))
        b.copy_(a * 2)

    v = src._version
    through_host(fn, [src], [dst, untouched])
    assert seen[0][0] and torch.equal(seen[0][1], torch.full((6,), -1.0))
    assert torch.equal(dst, src * 2) and src._version == v
    assert torch.equal(untouched, torch.full((3,), 7.0))
