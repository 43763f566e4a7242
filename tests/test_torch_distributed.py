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
  model's every parameter gradient (gathered by the executed layout)
  against the single-process scatter's;
* tensor parallelism over ``model`` (every leaf this rank's block): the
  forward, loss and gradients of every reduced arch (and two variants:
  kv heads repeated per query head, fused projections) on (1, 2), (1, 4)
  and (2, 2), gathered and held against the JAX package's single-device
  forward and ``jax.value_and_grad`` on the same parameters (logits at
  1e-4, loss at 1e-5, each gradient leaf at 1e-4 of its scale); TP
  ``prefill`` + 8 greedy ``decode_step``s of the reduced qwen2.5-3b (2 kv
  heads: at R = 4 two ranks share each), jamba and falcon-mamba against
  the reference's ``ServeEngine`` (tokens equal);
* the DP + ZeRO-1 train step of the reduced qwen2.5-3b and jamba on 2 and
  4 data ranks, and TP + DP + ZeRO-1 on (2, 2), against the port's 1-rank
  step;
* FSDP on (2, 2): the forward, prefill and decode bit for bit against the
  TP-only model, FSDP + ZeRO-1 steps against TP + ZeRO-1 (1e-6), the
  captured collective schedule against the executed one, and Adafactor on
  (1, 4) and (2, 2) against one rank;
* ``layout="fsdp_seq"`` (pure FSDP over every rank, the sequence split
  over ``model``) on (1, 4) and (2, 2): the forward, loss and gradients of
  every reduced arch against the reference's single-device
  ``jax.value_and_grad`` on the global batch (the TP bounds; the same
  cached reference results as the TP test where the batch is the same),
  prefill + 8 greedy decode steps against its ``ServeEngine`` (tokens
  equal, the gathered caches at 1e-5), a MoE layer that drops tokens (the
  same drops and aux as the reference), and three train steps on (2, 2)
  against one rank (the TP training rule) with the captured collective
  schedule equal to the executed one;
* the elastic restore (saved on (1, 4), restored on (2, 2)), and
  ``launch.train``'s checkpoints across (2, 2) and (4, 1) (tensor
  parallel and not), byte for byte;
* the multi-rank ``"distributed"`` sweep on 1, 2 and 4 ranks (S = 37,
  chunk 10) and the adaptive sweep's shard bound (the reference test's
  1M-scenario case at a 262,144-scenario seed: the CPU time);
* ``torchrun`` runs of the train CLI on 2 gloo ranks (2, 1) and on 4
  (2, 2).

Each world (4 ranks, 2 ranks) runs once per module and checks several
things; it is joined within a time limit, after which its ranks are killed
and the test fails."""
import functools
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
from repro.models.config import ShapeConfig as RefShape
from repro.models.factory import make_inputs as ref_inputs
from repro.models.factory import make_model as ref_make_model
from repro.parallel.pipeline import compressed_psum as ref_compressed_psum
from repro.serve.engine import ServeEngine
import repro_torch.core as pt
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_arch
from repro_torch.models import make_inputs, make_model
from repro_torch.models.config import ShapeConfig
from repro_torch.models.convert import params_to_jax, reference_leaves
from repro_torch.train import make_data
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import (AdamWConfig, adafactor_init,
                                         adamw_init, cosine_schedule)

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
TP_MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
#: The archs both packages register, and two variants.
TP_NAMES = sorted(set(ARCHS) & set(PORT_ARCHS)) + ["irregular", "fused"]
TP_ROWS, TP_SEQ = 2, 32               # rows of each data shard, sequence
TP_DECODE = ("qwen2.5-3b", "jamba-v0.1-52b", "falcon-mamba-7b")
TP_TRAIN_MESH, TP_TRAIN_STEPS = (2, 2), 3
FSDP_NAMES = ("qwen2.5-3b", "jamba-v0.1-52b")
# TP decode with the caches' L split: the irregular phi3 (3 kv heads) over
# (1, 2) (L over model), and a batch of 1 on (2, 2) (L over data, and over
# data and model for the irregular phi3); qwen2.5-3b over (1, 4) is the
# tp_decode part above (2 kv heads on 4 ranks: L over model)
SPLIT_PARTS = {
    2: [("tp_decode:(1, 2):irregular", {"shape": (1, 2),
                                        "names": ["irregular"]})],
    4: [("tp_decode:(2, 2):1", {"shape": (2, 2),
                                "names": ["qwen2.5-3b", "irregular"],
                                "rows": 1, "global_batch": 1})]}
SPLIT_CASES = [("qwen2.5-3b", 4, "tp_decode:(1, 4)", (1, 4), 2, ("model",)),
               ("irregular", 2, "tp_decode:(1, 2):irregular", (1, 2), 2,
                ("model",)),
               ("qwen2.5-3b", 4, "tp_decode:(2, 2):1", (2, 2), 1,
                ("data",)),
               ("irregular", 4, "tp_decode:(2, 2):1", (2, 2), 1,
                ("data", "model"))]
SEQ_MESHES = ((1, 4), (2, 2))        # fsdp_seq: (data, model)
SEQ_MOE_CF = 0.5                     # a capacity factor that drops tokens
ADAFACTOR_MESHES = ((1, 4), (2, 2))
# float32 bounds: the logits and each gradient leaf at 1e-4 (of the leaf's
# largest magnitude: entries near zero are sums of terms that cancel,
# rounded in another order once the row-parallel sums are split over
# ranks), the loss at 1e-5, as in test_torch_grads.py
RTOL_TP, RTOL_TP_LOSS = 1e-4, 1e-5
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
    for shape in TP_MESHES[n]:
        parts += [(f"tp_model:{shape}", {
            "shape": shape, "names": TP_NAMES,
            "batch_shape": (TP_ROWS * shape[0], TP_SEQ)})]
    parts.append((f"tp_decode:{TP_MESHES[n][0]}",
                  {"shape": TP_MESHES[n][0], "names": TP_DECODE}))
    for part, args in SPLIT_PARTS[n]:
        parts.append((part, args))
    if n == 4:
        parts.append(("tp_elastic", {"directory": str(tmp / "tp_ckpt")}))
        parts.append(("fsdp_model:(2, 2)", {"shape": TP_TRAIN_MESH,
                                            "names": FSDP_NAMES}))
        for shape in SEQ_MESHES:
            parts += [(f"seq_model:{shape}", {
                "shape": shape, "names": TP_NAMES,
                "batch_shape": (TP_ROWS * shape[0], TP_SEQ)}),
                (f"seq_decode:{shape}", {"shape": shape,
                                         "names": TP_DECODE})]
        parts.append(("seq_moe", {"shape": (2, 2), "p": p, "x": x,
                                  "capacity_factor": SEQ_MOE_CF}))
        for arch in TRAIN_ARCHS:
            parts.append((f"dp_train:seq:{arch}",
                          {"arch": arch, "zero1": True,
                           "steps": TP_TRAIN_STEPS, "seq": TRAIN_SEQ,
                           "shape": TP_TRAIN_MESH, "layout": "fsdp_seq",
                           "schedule": True}))
            parts.append((f"dp_train:tp:{arch}",
                          {"arch": arch, "zero1": True,
                           "steps": TP_TRAIN_STEPS, "seq": TRAIN_SEQ,
                           "shape": TP_TRAIN_MESH}))
            parts.append((f"dp_train:fsdp:{arch}",
                          {"arch": arch, "zero1": True,
                           "steps": TP_TRAIN_STEPS, "seq": TRAIN_SEQ,
                           "shape": TP_TRAIN_MESH, "fsdp": True,
                           "schedule": True}))
            for shape in ADAFACTOR_MESHES:
                parts.append((f"dp_train:adafactor:{shape}:{arch}",
                              {"arch": arch, "zero1": False,
                               "steps": TRAIN_STEPS, "seq": TRAIN_SEQ,
                               "shape": shape, "fsdp": shape[0] > 1,
                               "optimizer": "adafactor"}))
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
    parallelism takes it, gathered whole by its executed layout) against
    the scatter model's gradient of the mean of its per-shard losses; an
    expert leaf is held as E / R experts a rank."""
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
            assert got["grads"][nm].shape == w.shape, nm
            if w.ndim == 3:                           # this rank's experts
                assert got["shapes"][nm][0] * shape[1] == w.shape[0], nm
                n_expert_leaves += 1
            scale = max(float(np.abs(w).max()), 1e-6)
            np.testing.assert_allclose(got["grads"][nm], w, rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=nm)
    assert n_expert_leaves == 3 * cfg.n_layers * n


# ---------------------------------------------------------- DP + ZeRO-1
_ONE_RANK: dict = {}


def _one_rank(arch, n, steps=TRAIN_STEPS, optimizer="adamw", n_micro=None):
    """The port's 1-rank step over the global batch of ``n`` rows in ``n``
    microbatches (microbatch j = row j, data rank j's row; ``n_micro``:
    that many instead)."""
    n_micro = n if n_micro is None else n_micro
    if (arch, n, steps, optimizer, n_micro) not in _ONE_RANK:
        cfg = get_arch(arch).reduced()
        model = make_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        params = reference_leaves(model)
        opt = adamw_init(params) if optimizer == "adamw" \
            else adafactor_init(params)
        step = make_train_step(model.loss, AdamWConfig(**ranks.TRAIN_OPT),
                               n_micro=n_micro, optimizer=optimizer)
        data = make_data(cfg, ShapeConfig("t", "train", TRAIN_SEQ, n),
                         seed=0, device="cpu")
        losses = []
        for i in range(steps):
            params, opt, m = step(params, opt, data.batch(i))
            losses.append(float(m.loss))
        _ONE_RANK[(arch, n, steps, optimizer, n_micro)] = (
            losses, [leaf.value().numpy() for leaf in params],
            sum(x.numel() * x.element_size()
                for k in ("mu", "nu") for x in opt.get(k, [])))
    return _ONE_RANK[(arch, n, steps, optimizer, n_micro)]


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


# ------------------------------------------------------ tensor parallelism
def _ref_cfg(name):
    """The reference's config of ``_torch_ranks._tp_cfg(name)``."""
    if name == "irregular":
        return ARCHS["phi3-medium-14b"].reduced().replace(
            n_heads=12, n_kv_heads=3, head_dim=16, qkv_bias=True)
    if name == "fused":
        return ARCHS["qwen2.5-3b"].reduced().replace(fused_proj=True)
    return ARCHS[name].reduced()


@functools.lru_cache(maxsize=None)
def _ref_step(name):
    """The reference's jitted (loss, logits) and gradients of one data
    shard (``TP_ROWS`` rows) of ``name``'s single-device model."""
    model = ref_make_model(_ref_cfg(name), moe_impl="scatter")

    def loss_logits(p, b):
        return model.loss(p, b), model.forward(p, b)[0]
    return jax.jit(jax.value_and_grad(loss_logits, has_aux=True))


@functools.lru_cache(maxsize=None)
def _whole_tree(name):
    """The whole model's parameters (seed 0) drawn in one process, as the
    reference's tree."""
    model = make_model(ranks._tp_cfg(name), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    return params_to_jax(model)


def _whole_params(name):
    return jax.tree.leaves(_whole_tree(name))


@functools.lru_cache(maxsize=None)
def _ref_out(name, n_rows, lo, rows):
    """The reference's ``((loss, logits), grads)`` of ``name``'s
    single-device model on rows ``[lo, lo + rows)`` of the ``n_rows``-row
    batch, on the whole parameters: one cache for the TP test's data
    shards and the fsdp_seq test's global batches (the same call where
    they are the same rows)."""
    batch = ref_inputs(_ref_cfg(name), RefShape("t", "train", TP_SEQ,
                                                n_rows), abstract=False)
    out = _ref_step(name)(_whole_tree(name), jax.tree.map(
        lambda x: x[lo:lo + rows], batch))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("name", TP_NAMES)
def test_tp_forward_loss_and_grads_match_the_reference(worlds, name):
    """On (1, 2), (1, 4) and (2, 2): each rank's logits (its data shard's,
    gathered over ``model``) against the reference's single-device
    forward, the loss and every gathered gradient leaf against
    ``jax.value_and_grad`` of the mean of the shards' losses, on the
    parameters the ranks gathered (equal to the whole model's, drawn in
    one process, bit for bit).  The leaves whole on every rank (norms, the
    router) have the same gradient on every rank, exactly: *f* / *g*
    already make each rank's the whole model's."""
    for n, shapes in TP_MESHES.items():
        for shape in shapes:
            res = [_part(r, f"tp_model:{shape}")[name] for r in worlds[n]]
            params = res[0]["params"]
            for got, want in zip(jax.tree.leaves(params),
                                 _whole_params(name)):
                np.testing.assert_array_equal(got, want)
            outs = [_ref_out(name, TP_ROWS * shape[0], i * TP_ROWS, TP_ROWS)
                    for i in range(shape[0])]
            loss = np.mean([float(o[0][0]) for o in outs])
            grads = [np.mean(g, axis=0) for g in zip(*(
                [np.asarray(x) for x in jax.tree.leaves(o[1])]
                for o in outs))]
            for got in res:
                logits = np.asarray(outs[got["coord"][0]][0][1])
                np.testing.assert_allclose(got["logits"], logits,
                                           rtol=RTOL_TP, atol=RTOL_TP)
                np.testing.assert_allclose(got["loss"], loss,
                                           rtol=RTOL_TP_LOSS)
                assert got["n_split"] > 0
                for k, g in got["whole"].items():
                    np.testing.assert_array_equal(g, res[0]["whole"][k],
                                                  err_msg=k)
            assert len(res[0]["grads"]) == len(grads)
            for g, w in zip(res[0]["grads"], grads):
                assert g.shape == w.shape
                scale = float(np.abs(w).max())
                np.testing.assert_allclose(g, w, rtol=RTOL_TP,
                                           atol=RTOL_TP * scale)


@functools.lru_cache(maxsize=None)
def _engine_tokens(name):
    """The reference ``ServeEngine``'s greedy tokens of the (2, 12) prompt
    (seed 7) on the whole parameters: the TP and fsdp_seq tests' oracle."""
    prompt = np.random.default_rng(7).integers(
        0, 256, ranks.TP_PROMPT).astype(np.int32)
    engine = ServeEngine(ref_make_model(_ref_cfg(name)), _whole_tree(name),
                         ranks.TP_MAX_LEN)
    return np.asarray(engine.generate(prompt, ranks.TP_NEW))


@pytest.mark.parametrize("name", TP_DECODE)
def test_tp_prefill_and_decode_match_the_reference_engine(worlds, name):
    """TP prefill + 8 greedy decode steps on (1, 2) and (1, 4): the tokens
    of the reference's ``ServeEngine`` (greedy) on the whole model's
    parameters (the gathered ones equal them bit for bit), every rank; the
    attention caches are rank 0's block of the reference's
    ``cache_pspecs`` (qwen2.5-3b's 2 kv heads: one a rank over 2 ranks,
    and over 4 ranks both heads of a quarter of the positions)."""
    for n, shapes in TP_MESHES.items():
        res = [_part(r, f"tp_decode:{shapes[0]}")[name] for r in worlds[n]]
        for got, want in zip(jax.tree.leaves(res[0]["params"]),
                             _whole_params(name)):
            np.testing.assert_array_equal(got, want)
        want = _engine_tokens(name)
        for got in res:
            np.testing.assert_array_equal(got["tokens"], want)
            assert got["params_equal"]          # params_from_jax(mesh=)
            assert got["cache_err"] <= 1e-5     # caches_from_jax(mesh=)
        cfg = ranks._tp_cfg(name)
        if cfg.n_heads:
            assert res[0]["cache_shape"] == _ref_cache_block(
                name, shapes[0], ranks.TP_PROMPT[0])


def _ref_cache_block(name, shape, batch, coord=None) -> tuple:
    """The shape of the block of an attention cache of ``batch`` rows and
    ``TP_MAX_LEN`` positions under the reference's ``cache_pspecs`` on a
    (data, model) mesh of ``shape``."""
    from jax.sharding import AbstractMesh
    from repro.models.factory import abstract_caches
    from repro.parallel import cache_pspecs
    amesh = AbstractMesh(shape, ("data", "model"))
    caches = abstract_caches(_ref_cfg(name), batch, ranks.TP_MAX_LEN)
    i = next(i for i, c in enumerate(caches) if isinstance(c, dict))
    sizes = dict(zip(("data", "model"), shape))
    out = []
    for n, e in zip(caches[i]["k"].shape[1:], tuple(
            cache_pspecs(caches, amesh)[i]["k"])[1:] + (None,) * 4):
        for a in (e if isinstance(e, tuple) else (e,)):
            n //= sizes[a] if a else 1
        out.append(n)
    return tuple(out)


@pytest.mark.parametrize("name,n,part,shape,rows,axes", SPLIT_CASES,
                         ids=["qwen-1x4", "irregular-1x2", "qwen-2x2-b1",
                              "irregular-2x2-b1"])
def test_tp_split_cache_prefill_and_decode_match_the_reference_engine(
        worlds, name, n, part, shape, rows, axes):
    """TP prefill + 8 greedy decode steps where the reference's
    ``cache_pspecs`` split the caches' L: over ``model`` where the kv heads
    do not split (qwen2.5-3b's 2 over 4 ranks, the irregular phi3's 3 over
    2), over ``data`` for a batch of 1 on (2, 2) (and over both for the
    irregular phi3).  Every rank: the greedy tokens of the reference's
    ``ServeEngine`` on the prompt's rows, exactly; its attention caches
    the reference's block at its coordinates (rank ``r``'s positions along
    the split axes, data first); the whole model's prefill caches cut to
    that block (``caches_from_jax(mesh=)``) and the rank's gathered whole
    (``caches_to_jax``) within 1e-5; a position per row raises."""
    res = [_part(r, part)[name] for r in worlds[n]]
    want = _engine_tokens(name)[:rows]
    sizes = dict(zip(("data", "model"), shape))
    block = _ref_cache_block(name, shape, rows)
    for got in res:
        np.testing.assert_array_equal(got["tokens"], want)
        assert got["params_equal"]
        assert got["cache_err"] <= 1e-5 and got["gather_err"] <= 1e-5
        assert got["cache_shape"] == block
        b = got["block"]
        assert b["axes"] == axes and b["rows"] == rows and b["row0"] == 0
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + got["coord"][("data", "model").index(a)]
        assert (b["lo"], b["length"]) == (idx * block[1], block[1])
        assert "position per row" in got["per_row"], got["per_row"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_tp_dp_zero1_train_steps_match_one_rank(worlds, arch):
    """Three TP + DP + ZeRO-1 steps on (data 2, model 2) against one rank's
    two microbatches: losses at 1e-5; the parameters (gathered) at the
    optimizer tests' rtol 1e-6 with an atol of 1e-6 of the leaf's
    magnitude for at least 99.9% of all entries, and every entry within
    2 x the summed learning rates.  The split sums round the gradients
    differently (unlike data parallelism's, which are the microbatch
    loop's bit for bit), and AdamW's update is close to ``lr * sign(m)``:
    where a gradient entry is a sum that nearly cancels (the key bias's is
    zero in exact arithmetic; a few of the head's, 7 of 16,384 here, nearly
    so), its rounding moves the entry by up to 2 lr a step."""
    losses, leaves, moment_bytes = _one_rank(arch, 2, TP_TRAIN_STEPS)
    opt = AdamWConfig(**ranks.TRAIN_OPT)
    lr_sum = sum(float(cosine_schedule(opt, i + 1))
                 for i in range(TP_TRAIN_STEPS))
    for res in worlds[4]:
        got = _part(res, f"dp_train:tp:{arch}")
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        n_close = n_all = 0
        for a, b in zip(got["leaves"], leaves):
            diff = np.abs(a - b)
            assert float(diff.max()) <= 2 * lr_sum * (1 + 1e-6)
            tight = 1e-6 * np.abs(b) + 1e-6 * float(np.abs(b).max())
            n_close += int((diff <= tight).sum())
            n_all += diff.size
        assert n_close >= 0.999 * n_all, n_close / n_all
        assert got["sharded"] > 0
        assert got["moment_bytes"] < moment_bytes / 2


def _close_or_sign(got, want, lr_sum):
    """The TP training rule (``test_tp_dp_zero1_train_steps_match_one_rank``):
    every entry within 2 x the summed learning rates, and at least 99.9%
    of all entries at rtol 1e-6 with an atol of 1e-6 of the leaf's
    magnitude."""
    n_close = n_all = 0
    for a, b in zip(got, want):
        diff = np.abs(a - b)
        assert float(diff.max()) <= 2 * lr_sum * (1 + 1e-6)
        tight = 1e-6 * np.abs(b) + 1e-6 * float(np.abs(b).max())
        n_close += int((diff <= tight).sum())
        n_all += diff.size
    assert n_close >= 0.999 * n_all, n_close / n_all


# ------------------------------------------------------------------- FSDP
@pytest.mark.parametrize("name", FSDP_NAMES)
def test_fsdp_forward_prefill_and_decode_equal_tp_only(worlds, name):
    """On (data 2, model 2), the model built with FSDP (each block also
    cut over ``data``, gathered where it is used) against the TP-only
    model from the same seed, float32: the logits of each rank's rows, the
    prefill's and all 8 decode steps' logits and the greedy tokens bit for
    bit (the gathered weights are the very tensors TP holds); the gathered
    parameters equal; ``params_from_jax(..., fsdp=True)`` gives the FSDP
    model's state dict; each rank holds half of TP's parameters."""
    for res in worlds[4]:
        got = _part(res, "fsdp_model:(2, 2)")[name]
        for key in ("logits_equal", "decode_equal", "tokens_equal",
                    "params_equal", "loaded_equal"):
            assert got[key], key
        assert got["n_fsdp"] > 0
        tp, fs = got["counts"]
        assert fs < 0.55 * tp
        assert got["whole_counts"][0] == got["whole_counts"][1]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_fsdp_zero1_train_steps_match_tp_zero1(worlds, arch):
    """Three FSDP + ZeRO-1 steps on (2, 2) against the TP + ZeRO-1 steps
    of the same world: losses at 1e-6 and every gathered leaf at rtol 1e-6
    with an atol of 1e-6 of its magnitude (the DP bound); an FSDP leaf's
    moments are its block (as many moment bytes as ZeRO-1's), and the
    parameters a rank holds are about half of TP's."""
    for res in worlds[4]:
        got = _part(res, f"dp_train:fsdp:{arch}")
        want = _part(res, f"dp_train:tp:{arch}")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        for a, b in zip(got["leaves"], want["leaves"]):
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(b).max()))
        assert got["n_fsdp"] > 0
        assert got["moment_bytes"] == want["moment_bytes"]
        assert got["param_bytes"] < 0.55 * want["param_bytes"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_fsdp_captured_schedule_equals_the_executed_one(worlds, arch):
    """The (2, 2) FSDP step captured under the captures' fake mode (a model
    built with no weight drawn) records the collectives that one rank's
    first real step counted in ``parallel.transport``: the same calls and
    bytes of each all-gather, reduce-scatter and all-reduce."""
    for res in worlds[4]:
        got = _part(res, f"dp_train:fsdp:{arch}")
        assert got["captured"] == got["executed"]
        assert {"all_gather", "reduce_scatter", "all_reduce"} <= \
            set(got["executed"])


@pytest.mark.parametrize("shape", ADAFACTOR_MESHES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_adafactor_over_ranks_matches_one_rank(worlds, arch, shape):
    """Two Adafactor steps on (1, 4) (tensor parallel) and on (2, 2) (TP +
    FSDP) against one rank's: losses at 1e-5; the parameters (gathered) by
    the TP training rule.  Adafactor's update is normalised, so an entry
    whose gradient is rounding noise (the key bias's, zero in exact
    arithmetic; a bias started at zero) moves by up to lr a step either
    way; the row and column statistics are summed over the ranks in
    another order."""
    losses, leaves, _ = _one_rank(arch, shape[0], TRAIN_STEPS, "adafactor")
    opt = AdamWConfig(**ranks.TRAIN_OPT)
    lr_sum = sum(float(cosine_schedule(opt, i + 1))
                 for i in range(TRAIN_STEPS))
    for res in worlds[4]:
        got = _part(res, f"dp_train:adafactor:{shape}:{arch}")
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        _close_or_sign(got["leaves"], leaves, lr_sum)
        assert got["n_fsdp"] > 0 if shape[0] > 1 else got["n_fsdp"] == 0


# ------------------------------------------------------------- fsdp_seq
@pytest.mark.parametrize("name", TP_NAMES)
def test_fsdp_seq_forward_loss_and_grads_match_the_reference(worlds, name):
    """``layout="fsdp_seq"`` on (1, 4) and (2, 2): each rank's logits (its
    data rows, gathered along the sequence), the loss (the data ranks'
    mean) and every gradient leaf (gathered over all ranks) against the
    reference's single-device ``jax.value_and_grad`` on the global batch,
    which the ranks' MoE layers route as one list (logits at 1e-4, loss
    at 1e-5, each gradient leaf at 1e-4 of its scale).  Every leaf is
    FSDP-cut at these widths."""
    for shape in SEQ_MESHES:
        rows = TP_ROWS * shape[0]
        (loss, logits), grads = _ref_out(name, rows, 0, rows)
        res = [_part(r, f"seq_model:{shape}")[name] for r in worlds[4]]
        for got in res:
            d = got["coord"][0]
            np.testing.assert_allclose(
                got["logits"], logits[d * TP_ROWS:(d + 1) * TP_ROWS],
                rtol=RTOL_TP, atol=RTOL_TP)
            np.testing.assert_allclose(got["loss"], float(loss),
                                       rtol=RTOL_TP_LOSS)
            assert got["n_fsdp"] > 0
        want = jax.tree.leaves(grads)
        assert len(res[0]["grads"]) == len(want)
        for g, w in zip(res[0]["grads"], want):
            assert g.shape == w.shape
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=RTOL_TP,
                                       atol=RTOL_TP * scale)


@pytest.mark.parametrize("name", TP_DECODE)
def test_fsdp_seq_prefill_and_decode_match_the_reference_engine(worlds,
                                                                name):
    """``"fsdp_seq"`` prefill of each data rank's rows of the (2, 12)
    prompt and 8 greedy decode steps on (1, 4) and (2, 2): the tokens of
    the reference's ``ServeEngine`` on the whole prompt; the attention
    caches hold ``max_len / R`` positions a rank, and gathered they are
    the whole model's at 1e-5.  A prompt the ``model`` axis does not
    split raises, naming the arch, the length and R."""
    want = _engine_tokens(name)
    cfg = ranks._tp_cfg(name)
    for shape in SEQ_MESHES:
        for res in worlds[4]:
            got = _part(res, f"seq_decode:{shape}")[name]
            n = ranks.TP_PROMPT[0] // shape[0]
            d = got["coord"][0]
            np.testing.assert_array_equal(got["tokens"],
                                          want[d * n:(d + 1) * n])
            assert got["cache_err"] <= 1e-5
            if cfg.n_heads:
                assert got["cache_len"] == ranks.TP_MAX_LEN // shape[1]
            msg = got["odd_length"]
            assert cfg.name in msg and "9" in msg \
                and f"R = {shape[1]}" in msg, msg


@pytest.mark.parametrize("impl", ["scatter", "dense"])
def test_fsdp_seq_moe_drops_and_aux_match_the_reference(worlds, impl):
    """The reduced phi3.5-moe's MoE layer at capacity factor 0.5 under
    ``"fsdp_seq"`` on (2, 2), each rank its rows and block of positions:
    the assignments kept are the reference's on the global batch (some
    are dropped), the output blocks are the reference scatter's and
    dense's (1e-5), and the aux loss is the global batch's."""
    p, x, _ = _moe_inputs()
    rcfg = ARCHS["phi3.5-moe-42b-a6.6b"].reduced().replace(
        capacity_factor=SEQ_MOE_CF)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    Bg, Lg, d = x.shape
    flat = jnp.asarray(x.reshape(-1, d))
    want = {"scatter": ref_moe.moe_ffn_scatter(rp, flat, rcfg),
            "dense": ref_moe.moe_ffn_dense(rp, flat, rcfg)}
    _, topi, _ = ref_moe._route(rp, flat, rcfg)
    topi = np.asarray(topi)
    E, k = rcfg.n_experts, rcfg.experts_per_token
    onehot = np.eye(E, dtype=np.int64)[topi.reshape(-1)]
    rank = (np.cumsum(onehot, 0) - 1)[np.arange(onehot.shape[0]),
                                      topi.reshape(-1)]
    kept = (rank < ref_moe.capacity(rcfg, Bg * Lg)).reshape(Bg, Lg, k)
    assert not kept.all()                       # the capacity drops some
    y_want = np.asarray(want[impl][0]).reshape(x.shape)
    B, L = Bg // 2, Lg // 2
    for res in worlds[4]:
        got = _part(res, "seq_moe")
        i, j = got["coord"]
        np.testing.assert_array_equal(
            got["kept"], kept[i * B:(i + 1) * B,
                              j * L:(j + 1) * L].reshape(-1))
        np.testing.assert_allclose(
            got[impl]["y"], y_want[i * B:(i + 1) * B, j * L:(j + 1) * L],
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[impl]["aux"], float(want[impl][1]),
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_fsdp_seq_train_steps_match_one_rank(worlds, arch):
    """Three ``"fsdp_seq"`` + ZeRO-1 steps on (data 2, model 2) against one
    rank's steps over the same two rows as one microbatch (the MoE layers
    route the global batch together): losses at 1e-5 and the parameters
    by the TP training rule; every leaf is FSDP-cut over all ranks."""
    losses, leaves, _ = _one_rank(arch, 2, TP_TRAIN_STEPS, n_micro=1)
    opt = AdamWConfig(**ranks.TRAIN_OPT)
    lr_sum = sum(float(cosine_schedule(opt, i + 1))
                 for i in range(TP_TRAIN_STEPS))
    for res in worlds[4]:
        got = _part(res, f"dp_train:seq:{arch}")
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        _close_or_sign(got["leaves"], leaves, lr_sum)
        assert got["n_fsdp"] == len(leaves)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_fsdp_seq_captured_schedule_equals_the_executed_one(worlds, arch):
    """The (2, 2) ``"fsdp_seq"`` step captured under the captures' fake
    mode records the collectives that one rank's first real step counted:
    the same calls and bytes of each all-gather (weights, k / v, conv
    tails, scan states), reduce-scatter and all-reduce."""
    for res in worlds[4]:
        got = _part(res, f"dp_train:seq:{arch}")
        assert got["captured"] == got["executed"]
        assert {"all_gather", "reduce_scatter", "all_reduce"} <= \
            set(got["executed"])


def test_tp_elastic_restore_is_exact(worlds):
    """``launch.train`` checkpoints of (2, 2) restored on (4, 1) and back:
    each re-save writes every file byte for byte."""
    for res in worlds[4]:
        got = _part(res, "tp_elastic")
        if got["same"]:                               # rank 0 compares
            assert len(got["same"]) == 2
            for match, other in got["same"]:
                assert match > 3 and other == 0


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


def test_train_cli_tp_under_torchrun_on_four_gloo_ranks(tmp_path):
    """``--mesh 2,2``: tensor parallel over 2 model ranks, DP over 2 data
    ranks; every rank logs the same history, and the checkpoint holds
    whole leaves."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("JAX_PLATFORMS", None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--arch", "jamba-v0.1-52b", "--reduced", "--steps", "2", "--seq",
           "16", "--batch", "2", "--mesh", "2,2", "--backend", "gloo",
           "--device", "cpu", "--summary", "--ckpt-dir", str(tmp_path / "ck")]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=180, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    assert sorted(d["rank"] for d in lines) == [0, 1, 2, 3]
    strip = lambda h: [{k: v for k, v in x.items()
                        if k not in ("elapsed_s", "step_s", "moment_bytes")}
                       for x in h]
    assert all(strip(d["history"]) == strip(lines[0]["history"])
               for d in lines)
    manifest = json.loads((tmp_path / "ck" / "step_00000001"
                           / "manifest.json").read_text())
    cfg = get_arch("jamba-v0.1-52b").reduced()
    assert manifest["leaves"]["params__embed__table"]["shape"] == \
        [cfg.padded_vocab, cfg.d_model]


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
