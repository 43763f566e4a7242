"""Rank programs for ``tests/test_torch_distributed.py``: each runs in its
own spawned process, one rank of a gloo world on the CPU, and imports
only ``torch``, ``numpy`` and the port (never the JAX package).

``start_world`` starts the ranks (``file://`` rendezvous in the test's
temporary directory, so concurrent test workers never share a port) and
``join_world`` joins them within a time limit (after which it kills them
and fails) and returns each rank's result.  One world runs several
checks, each a ``part`` whose result or traceback is recorded by name.
"""
from __future__ import annotations

import multiprocessing
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

RANK_TIMEOUT_S = 60.0           # a collective's wait before it raises


def start_world(n: int, task: str, directory, **kw) -> list:
    """Start ``TASKS[task](rank, n, **kw)`` on ``n`` gloo ranks; returns
    their processes (for :func:`join_world`)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(r, n, str(directory), task, kw))
             for r in range(n)]
    for p in procs:
        p.start()
    return procs


def join_world(procs: list, task: str, directory,
               timeout: float = 240.0) -> list:
    """Join a world within ``timeout`` seconds (past it, kill its ranks and
    fail); returns the ranks' results in rank order."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"{task}: ranks {hung} still running after {timeout} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * len(procs), f"{task}: exit codes {codes}"
    out = []
    for r in range(len(procs)):
        with open(f"{directory}/{task}-{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, n, directory, task, kw):
    from repro_torch.launch.mesh import init_ranks
    torch.set_num_threads(1)
    init_ranks("gloo", "cpu", init_method=f"file://{directory}/{task}.init",
               rank=rank, world_size=n, timeout_s=RANK_TIMEOUT_S)
    try:
        res = TASKS[task](rank, n, **kw)
    finally:
        dist.destroy_process_group()
    with open(f"{directory}/{task}-{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def _parts(res: dict, name: str, fn) -> None:
    t0 = time.perf_counter()
    try:
        res[name] = fn()
    except Exception:                       # recorded; the test fails on it
        res[name] = {"error": traceback.format_exc()}
    res.setdefault("_seconds", {})[name] = time.perf_counter() - t0


def _mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes, "cpu")


# --------------------------------------------------------------- the parts
def pipeline(ws, xs):
    """``pipeline_apply`` over ``pod`` on a (pod 2, data 2) mesh: the
    output and this stage's gradient of sum(out ** 2)."""
    from repro_torch.parallel import pipeline_apply, stage_block_counts
    mesh = _mesh((2, 2), ("pod", "data"))
    group = mesh.get_group("pod")
    stage = dist.get_rank(group)
    per = stage_block_counts(len(ws), dist.get_world_size(group))[stage]
    w = torch.tensor(ws[stage * per:(stage + 1) * per], requires_grad=True)

    def block_fn(w_stack, x):
        for wi in w_stack:
            x = torch.tanh(x @ wi)
        return x

    out = pipeline_apply(w, torch.tensor(xs), block_fn, group)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "grad": w.grad.numpy(),
            "stage": stage, "per": per}


def compressed(xs):
    """Five error-feedback steps of ``compressed_psum`` over the world,
    rank ``r`` reducing ``xs[step, r]``; the int8 payloads and scales it
    put on the wire are recorded."""
    from repro_torch.parallel import pipeline, transport
    sent = []
    gather = transport.all_gather

    def recording(t, group=None):
        sent.append(t.clone())
        return gather(t, group)

    pipeline.transport.all_gather = recording
    try:
        res, outs = None, []
        for x in xs:
            out, res = pipeline.compressed_psum(
                torch.tensor(x[dist.get_rank()]), dist.group.WORLD, res)
            outs.append(out.numpy())
    finally:
        pipeline.transport.all_gather = gather
    return {"out": np.stack(outs),
            "q": np.stack([t.numpy() for t in sent[0::2]]),
            "scale": np.array([float(t) for t in sent[1::2]])}


def _moe_cfg():
    from repro_torch.configs import get_arch
    return get_arch("phi3.5-moe-42b-a6.6b").reduced().replace(
        capacity_factor=8.0)


def ep_moe(shape, p, x):
    """``moe_ffn_ep_local`` of this rank's rows of ``x`` with its experts of
    ``p`` on a (data, model) mesh of ``shape``."""
    from repro_torch.models import moe
    from repro_torch.parallel import batch_pspecs, local_shard
    cfg = _moe_cfg()
    mesh = _mesh(shape)
    blk = moe.expert_block(cfg, mesh)
    mine = {k: torch.tensor(v) if k == "router"
            else torch.tensor(v)[blk] for k, v in p.items()}
    xt = torch.tensor(x)
    xl = local_shard(xt, batch_pspecs({"x": xt}, mesh)["x"], mesh)
    y, aux = moe.moe_ffn_ep_local(mine, xl, cfg, mesh)
    return {"y": y.numpy(), "aux": float(aux), "coord": mesh.get_coordinate(),
            "experts": (blk.start, blk.stop)}


def ep_grads(shape, batch, seed):
    """The reduced phi3.5-moe (capacity factor 8) with ``ep_local`` on a
    (data, model) mesh (tensor parallel elsewhere): this rank's logits and
    loss on its rows, every parameter's gradient averaged over the data
    ranks and gathered whole by its executed layout, and the shape of the
    block the rank holds."""
    from repro_torch.models import make_model
    from repro_torch.parallel import (batch_pspecs, local_shard, sharding,
                                      transport)
    cfg = _moe_cfg()
    mesh = _mesh(shape)
    model = make_model(cfg, moe_impl="ep_local", device="cpu", mesh=mesh,
                       generator=torch.Generator().manual_seed(seed))
    b = {k: torch.tensor(v) for k, v in batch.items()}
    specs = batch_pspecs(b, mesh)
    b = {k: local_shard(v, specs[k], mesh) for k, v in b.items()}
    logits, aux = model(b)
    loss = model.loss(b)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    group, n_data = mesh.get_group("data"), mesh.size(0)
    grads = [transport.all_reduce(g.clone(), group) / n_data for g in grads]
    axis = sharding.model_axis(mesh)
    grads = [sharding.param_layout(cfg, n, g.ndim, shape[1]).gather(g, axis)
             for n, g in zip(names, grads)]
    return {"logits": logits.detach().numpy(), "aux": float(aux),
            "loss": float(loss), "coord": mesh.get_coordinate(),
            "grads": {n: g.numpy() for n, g in zip(names, grads)},
            "shapes": {n: tuple(p.shape)
                       for n, p in model.named_parameters()}}


def _tp_cfg(name):
    """A reduced arch of the TP checks, or one of two variants: the
    ``irregular`` phi3 (12 query heads over 3 kv heads: at R = 4 a rank's
    query heads straddle kv groups, so k / v are repeated per query head,
    and two ranks share a kv head) and the ``fused`` qwen2.5-3b
    (``wqkv`` / ``w_gateup`` held whole, multiplied by columns)."""
    from repro_torch.configs import get_arch
    if name == "irregular":
        return get_arch("phi3-medium-14b").reduced().replace(
            n_heads=12, n_kv_heads=3, head_dim=16, qkv_bias=True)
    if name == "fused":
        return get_arch("qwen2.5-3b").reduced().replace(fused_proj=True)
    return get_arch(name).reduced()


def tp_model(shape, names, batch_shape):
    """Every arch of ``names`` built on a (data, model) mesh of ``shape``
    (weights from seed 0): the logits of this rank's data rows (gathered
    over ``model``) and the loss; the gradients of every leaf through
    ``loss_and_grads`` and ``reduce_over_data``, gathered whole by the
    executed layout (rank 0 also returns the gathered parameters); every
    rank's gradients of the leaves it holds whole."""
    from repro_torch.models import make_inputs, make_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.convert import params_to_jax, reference_leaves
    from repro_torch.train.loop import (data_group, local_batch,
                                        loss_and_grads, reduce_over_data)
    mesh = _mesh(shape)
    group, n_data = data_group(mesh)
    out = {}
    for name in names:
        cfg = _tp_cfg(name)
        model = make_model(cfg, device="cpu", mesh=mesh,
                           moe_impl="ep_local" if cfg.n_experts
                           else "scatter",
                           generator=torch.Generator().manual_seed(0))
        b = local_batch(make_inputs(cfg, ShapeConfig("t", "train",
                                                     batch_shape[1],
                                                     batch_shape[0]),
                                    device="cpu"), mesh)
        leaves = reference_leaves(model)
        with torch.no_grad():
            logits, _ = model(b)
        loss, grads = loss_and_grads(model.loss, leaves, b)
        loss, grads = reduce_over_data(loss, grads, group, n_data)
        params = params_to_jax(model)
        gathered = [leaf.gather(g) for leaf, g in zip(leaves, grads)]
        res = {"logits": logits.numpy(), "loss": float(loss),
               "coord": mesh.get_coordinate(),
               "whole": {leaf.name: g.numpy() for leaf, g
                         in zip(leaves, grads) if leaf.layout.whole},
               "n_split": sum(not leaf.layout.whole for leaf in leaves)}
        if dist.get_rank() == 0:
            res.update(params=params, grads=[g.numpy() for g in gathered])
        out[name] = res
    return out


TP_PROMPT = (2, 12)
TP_NEW, TP_MAX_LEN = 9, 32


def _reference_caches(cfg, caches) -> list:
    """Per-layer caches in the reference's layout: one entry per pattern
    position, each leaf stacked over the blocks (numpy)."""
    from repro_torch.models.blocks import layer_pattern
    P = len(layer_pattern(cfg))
    out = []
    for pos in range(P):
        layers_ = caches[pos::P]
        if layers_[0] is None:
            out.append(None)
        elif isinstance(layers_[0], dict):
            out.append({k: np.stack([c[k].numpy() for c in layers_])
                        for k in layers_[0]})
        else:
            out.append(tuple(np.stack([c[j].numpy() for c in layers_])
                             for j in range(2)))
    return out


def tp_decode(shape, names, rows=TP_PROMPT[0], global_batch=None):
    """TP ``prefill`` of the first ``rows`` rows of a (2, 12) prompt (seed
    7) and 8 greedy ``decode_step``s on a (data, model) mesh of ``shape``
    (every rank given those rows, of a global batch of ``global_batch``:
    ``LanguageModel.cache_block``): the 9 tokens; rank 0 also returns the
    gathered parameters.  Beside them: the whole model's parameters
    carried into this rank's blocks (``params_from_jax(..., mesh=)``)
    against the TP model's, its prefill caches (``caches_from_jax(...,
    mesh=)``) against the TP prefill's, and the TP prefill's caches
    gathered whole (``caches_to_jax``) against its; the cache block, the
    attention caches' shape, and what a position per row raises."""
    from repro_torch.models import make_model
    from repro_torch.models.convert import (caches_from_jax, caches_to_jax,
                                            params_from_jax, params_to_jax)
    mesh = _mesh(shape)
    prompt = torch.tensor(np.random.default_rng(7).integers(
        0, 256, TP_PROMPT), dtype=torch.int32)[:rows]
    out = {}
    for name in names:
        cfg = _tp_cfg(name)
        model = make_model(cfg, device="cpu", mesh=mesh,
                           moe_impl="ep_local" if cfg.n_experts
                           else "scatter",
                           generator=torch.Generator().manual_seed(0))
        whole = make_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        loaded = params_from_jax(cfg, params_to_jax(whole), mesh)
        mine = model.state_dict()
        params_equal = loaded.keys() == mine.keys() and all(
            torch.equal(loaded[k], mine[k]) for k in mine)
        kw = {"global_batch": global_batch}
        block = model.cache_block(rows, TP_MAX_LEN, global_batch)
        with torch.no_grad():
            logits, caches = model.prefill({"tokens": prompt}, TP_MAX_LEN,
                                           **kw)
            _, wc = whole.prefill({"tokens": prompt}, TP_MAX_LEN)
            want = _reference_caches(cfg, wc)
            cut = caches_from_jax(cfg, want, mesh)
            cache_err = _max_err(caches, cut)
            back = caches_to_jax(cfg, caches, mesh, block)
            gather_err = _max_err(back, want)
            toks = [logits.argmax(-1)]
            for i in range(TP_NEW - 1):
                logits, caches = model.decode_step(
                    caches, {"tokens": toks[-1]}, TP_PROMPT[1] + i,
                    max_len=TP_MAX_LEN, **kw)
                toks.append(logits.argmax(-1))
            per_row = ""
            if block is not None and block.split:
                try:
                    model.decode_step(caches, {"tokens": toks[-1]},
                                      torch.full((rows,), 20), TP_MAX_LEN,
                                      **kw)
                except NotImplementedError as e:
                    per_row = str(e)
        params = params_to_jax(model)
        attn = [c["k"] for c in caches if isinstance(c, dict)]
        out[name] = {"tokens": torch.cat(toks, 1).numpy(),
                     "cache_shape": tuple(attn[0].shape) if attn else None,
                     "block": None if block is None else {
                         k: getattr(block, k) for k in (
                             "rows", "row0", "heads", "lo", "length",
                             "axes")},
                     "coord": mesh.get_coordinate(), "per_row": per_row,
                     "params_equal": params_equal, "cache_err": cache_err,
                     "gather_err": gather_err,
                     "params": params if dist.get_rank() == 0 else None}
    return out


def _max_err(got, want) -> float:
    """The largest distance between two cache lists' tensors (either the
    port's tensors or numpy arrays)."""
    def vals(c):
        return list(c.values()) if isinstance(c, dict) else list(c)
    return max((float(np.abs(np.asarray(a, np.float64)
                             - np.asarray(b, np.float64)).max())
                for c, w in zip(got, want) if c is not None
                for a, b in zip(vals(c), vals(w))), default=0.0)


TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _train_model(cfg, mesh, tp, fsdp, optimizer, zero1, layout="tp"):
    """(model, leaves, optimizer state, ZeRO-1 blocks) of a reduced arch
    (``layout="fsdp_seq"``: sequence-sharded pure FSDP on ``mesh``)."""
    from repro_torch.models import make_model
    from repro_torch.models.convert import reference_leaves
    from repro_torch.train.optimizer import (adafactor_init, adamw_init,
                                             zero1_blocks)
    seq = layout == "fsdp_seq"
    model = make_model(cfg, device="cpu", mesh=mesh if tp or seq else None,
                       moe_impl="ep_local" if tp and cfg.n_experts
                       and not seq else "scatter", fsdp=fsdp, layout=layout,
                       generator=torch.Generator().manual_seed(0))
    params = reference_leaves(model)
    if optimizer == "adafactor":
        return model, params, adafactor_init(params), None
    blocks = zero1_blocks(params, mesh) if zero1 else None
    return model, params, adamw_init(params, blocks=blocks), blocks


def _captured_schedule(cfg, mesh, fsdp, optimizer, zero1, batch,
                       layout="tp"):
    """The collectives one rank counts for one train step, from a capture
    of the step on a model built under the captures' fake mode (no weight
    drawn): ``transport.as_counted`` of its ``CollectiveOp``s."""
    from repro_torch.core import graph
    from repro_torch.parallel import transport
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWConfig
    model, params, opt, _ = graph.abstract(_train_model, cfg, mesh, True,
                                           fsdp, optimizer, zero1, layout)
    opt["count"] = torch.zeros((), dtype=torch.int32)
    step = make_train_step(model.loss, AdamWConfig(**TRAIN_OPT), mesh=mesh,
                           zero1=zero1, optimizer=optimizer)
    return transport.as_counted(graph.capture(step, params, opt, batch)
                                .collectives())


def dp_train(arch, zero1, steps, seq, shape=None, fsdp=False,
             optimizer="adamw", schedule=False, layout="tp"):
    """``steps`` DP (+ ZeRO-1) train steps of a reduced arch over a (world,
    1) mesh (or a (data, model) mesh of ``shape``, tensor parallel, the
    model built on it; ``fsdp``: also cut over the data axes;
    ``layout="fsdp_seq"``: sequence-sharded pure FSDP instead), one row per
    data rank: losses, the whole leaves after (gathered), and this rank's
    moment bytes.  ``schedule``: also the collectives the first step
    counted (``transport.since``) and those of its capture."""
    from repro_torch.configs import get_arch
    from repro_torch.models.config import ShapeConfig
    from repro_torch.parallel import transport
    from repro_torch.train import make_data
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWConfig
    n = dist.get_world_size()
    cfg = get_arch(arch).reduced()
    tp = shape is not None
    mesh = _mesh(shape if tp else (n, 1))
    n = mesh.size(0)
    model, params, opt, blocks = _train_model(cfg, mesh, tp, fsdp,
                                              optimizer, zero1, layout)
    step = make_train_step(model.loss, AdamWConfig(**TRAIN_OPT), mesh=mesh,
                           zero1=zero1, optimizer=optimizer)
    data = make_data(cfg, ShapeConfig("t", "train", seq, n), seed=0,
                     device="cpu")
    out = {}
    if schedule:
        out["captured"] = _captured_schedule(cfg, mesh, fsdp, optimizer,
                                             zero1, data.batch(0), layout)
    losses = []
    for i in range(steps):
        before = transport.snapshot()
        params, opt, m = step(params, opt, data.batch(i))
        if i == 0 and schedule:
            out["executed"] = transport.since(before)
        losses.append(float(m.loss))
    state = [x for k in ("mu", "nu") for x in opt.get(k, [])] + \
        [x for v in opt.get("v", []) for x in v.values()]
    out.update({"losses": losses,
                "leaves": [leaf.gather(leaf.value()).numpy()
                           for leaf in params],
                "moment_bytes": sum(x.numel() * x.element_size()
                                    for x in state),
                "param_bytes": sum(t.numel() * t.element_size()
                                   for t in model.parameters()),
                "n_fsdp": sum(leaf.fsdp is not None for leaf in params),
                "sharded": sum(b is not None for b in blocks or [])})
    return out


def fsdp_model(shape, names):
    """Each arch of ``names`` built on a (data, model) mesh of ``shape``
    twice from seed 0, tensor parallel and with FSDP: the logits of this
    rank's rows, a prefill of a (2, 12) prompt and 8 greedy decode steps
    (every step's logits), and the gathered parameters, each pair compared
    bit for bit; the FSDP state dict against ``params_from_jax(...,
    fsdp=True)`` of the whole model's parameters."""
    from repro_torch.models import make_inputs, make_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.convert import (params_from_jax, params_to_jax,
                                            reference_leaves)
    from repro_torch.train.loop import local_batch
    mesh = _mesh(shape)
    prompt = torch.tensor(np.random.default_rng(7).integers(
        0, 256, TP_PROMPT), dtype=torch.int32)
    out = {}
    for name in names:
        cfg = _tp_cfg(name)
        models = [make_model(cfg, device="cpu", mesh=mesh, fsdp=f,
                             moe_impl="ep_local" if cfg.n_experts
                             else "scatter",
                             generator=torch.Generator().manual_seed(0))
                  for f in (False, True)]
        b = local_batch(make_inputs(cfg, ShapeConfig("t", "train", 32,
                                                     2 * shape[0]),
                                    device="cpu"), mesh)
        runs = []
        with torch.no_grad():
            for model in models:
                logits, _ = model(b)
                lg, caches = model.prefill({"tokens": prompt}, TP_MAX_LEN)
                steps, toks = [lg], [lg.argmax(-1)]
                for i in range(TP_NEW - 1):
                    lg, caches = model.decode_step(
                        caches, {"tokens": toks[-1]}, TP_PROMPT[1] + i)
                    steps.append(lg)
                    toks.append(lg.argmax(-1))
                runs.append((logits, torch.stack(steps),
                             torch.cat(toks, 1)))
        whole = [params_to_jax(m) for m in models]
        same_params = all(np.array_equal(a, c) for a, c in zip(
            *(jax_leaves(w) for w in whole)))
        loaded = params_from_jax(cfg, whole[0], mesh, fsdp=True)
        mine = models[1].state_dict()
        out[name] = {
            "logits_equal": torch.equal(runs[0][0], runs[1][0]),
            "decode_equal": torch.equal(runs[0][1], runs[1][1]),
            "tokens_equal": torch.equal(runs[0][2], runs[1][2]),
            "params_equal": same_params,
            "loaded_equal": loaded.keys() == mine.keys() and all(
                torch.equal(loaded[k], mine[k]) for k in mine),
            "n_fsdp": sum(leaf.fsdp is not None
                          for leaf in reference_leaves(models[1])),
            "counts": [m.param_count() for m in models],
            "whole_counts": [m.whole_param_count() for m in models]}
    return out


def _seq_model(cfg, mesh):
    """A reduced arch built with ``layout="fsdp_seq"`` on ``mesh`` (seed
    0, MoE layers routing with ``"scatter"``)."""
    from repro_torch.models import make_model
    return make_model(cfg, device="cpu", mesh=mesh, layout="fsdp_seq",
                      generator=torch.Generator().manual_seed(0))


def seq_model(shape, names, batch_shape):
    """Every arch of ``names`` under ``"fsdp_seq"`` on a (data, model) mesh
    of ``shape``: the logits of this rank's data rows (gathered along the
    sequence), the loss, and every leaf's gradient through
    ``loss_and_grads`` and ``reduce_over_data``, gathered whole (rank 0);
    an arch whose length the ``model`` axis does not divide records the
    ``ValueError``'s message."""
    from repro_torch.models import make_inputs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.convert import reference_leaves
    from repro_torch.train.loop import (data_group, local_batch,
                                        loss_and_grads, reduce_over_data)
    mesh = _mesh(shape)
    group, n_data = data_group(mesh)
    out = {}
    for name in names:
        cfg = _tp_cfg(name)
        model = _seq_model(cfg, mesh)
        b = local_batch(make_inputs(cfg, ShapeConfig("t", "train",
                                                     batch_shape[1],
                                                     batch_shape[0]),
                                    device="cpu"), mesh)
        leaves = reference_leaves(model)
        with torch.no_grad():
            logits, aux = model(b)
        loss, grads = loss_and_grads(model.loss, leaves, b)
        loss, grads = reduce_over_data(loss, grads, group, n_data,
                                       [leaf.fsdp is not None
                                        for leaf in leaves])
        gathered = [leaf.gather(g) for leaf, g in zip(leaves, grads)]
        res = {"logits": logits.numpy(), "loss": float(loss),
               "aux": float(aux), "coord": mesh.get_coordinate(),
               "n_fsdp": sum(leaf.fsdp is not None for leaf in leaves)}
        if dist.get_rank() == 0:
            res["grads"] = [g.numpy() for g in gathered]
        out[name] = res
    return out


def _gathered_caches(caches, seq) -> list:
    """The decode caches whole: the attention caches' blocks gathered
    along the positions over ``model``, the mamba states as they are."""
    from repro_torch.parallel import transport
    out = []
    for c in caches:
        if isinstance(c, dict):
            out.append({k: transport.all_gather_dim(v, seq.group, 1)
                        for k, v in c.items()})
        else:
            out.append(c)
    return out


def seq_decode(shape, names):
    """``"fsdp_seq"`` ``prefill`` of this rank's rows of a (2, 12) prompt
    (seed 7) and 8 greedy ``decode_step``s on a (data, model) mesh of
    ``shape``: the 9 tokens of its rows, the block of positions its
    attention caches hold, and the gathered prefill caches' largest
    distance to the whole model's (one process, same seed)."""
    from repro_torch.models import make_model
    from repro_torch.train.loop import local_batch
    mesh = _mesh(shape)
    prompt = torch.tensor(np.random.default_rng(7).integers(
        0, 256, TP_PROMPT), dtype=torch.int32)
    out = {}
    for name in names:
        cfg = _tp_cfg(name)
        model = _seq_model(cfg, mesh)
        whole = make_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        mine = local_batch({"tokens": prompt}, mesh)
        with torch.no_grad():
            logits, caches = model.prefill(mine, TP_MAX_LEN)
            got = _gathered_caches(caches, model.seq)
            _, want = whole.prefill({"tokens": prompt}, TP_MAX_LEN)
            n = mine["tokens"].shape[0]
            lo = mesh.get_coordinate()[0] * n
            want = [None if w is None else
                    {k: v[lo:lo + n] for k, v in w.items()}
                    if isinstance(w, dict) else [v[lo:lo + n] for v in w]
                    for w in want]
            cache_err = max((float((a - b).abs().max())
                             for c, w in zip(got, want) if c is not None
                             for a, b in zip(c.values() if isinstance(c, dict)
                                             else c, w.values()
                                             if isinstance(w, dict) else w)),
                            default=0.0)
            toks = [logits.argmax(-1)]
            for i in range(TP_NEW - 1):
                logits, caches = model.decode_step(
                    caches, {"tokens": toks[-1]}, TP_PROMPT[1] + i)
                toks.append(logits.argmax(-1))
        try:
            model.prefill({"tokens": prompt[:, :9]}, TP_MAX_LEN)
            odd = ""
        except ValueError as e:
            odd = str(e)
        out[name] = {"tokens": torch.cat(toks, 1).numpy(),
                     "coord": mesh.get_coordinate(), "odd_length": odd,
                     "cache_len": next((c["k"].shape[1] for c in caches
                                        if isinstance(c, dict)), None),
                     "cache_err": cache_err}
    return out


def seq_moe(shape, p, x, capacity_factor):
    """``moe_ffn`` under ``"fsdp_seq"`` (scatter and dense) of this rank's
    rows and block of positions of ``x`` (B, L, d), the reduced
    phi3.5-moe at ``capacity_factor``: its output block, the aux loss, and
    which of its assignments (flat (B_r L_r, k) order) were kept."""
    from repro_torch.models import moe
    from repro_torch.parallel import sharding
    cfg = _moe_cfg().replace(capacity_factor=capacity_factor)
    mesh = _mesh(shape)
    seq = sharding.seq_axis(mesh)
    pt = {k: torch.tensor(v) for k, v in p.items()}
    d_rank, m_rank = mesh.get_coordinate()
    B, L = x.shape[0] // shape[0], x.shape[1] // shape[1]
    xb = torch.tensor(x[d_rank * B:(d_rank + 1) * B,
                        m_rank * L:(m_rank + 1) * L])
    out = {"coord": mesh.get_coordinate()}
    for impl in ("scatter", "dense"):
        y, aux = moe.moe_ffn(pt, xb, cfg, impl=impl, seq=seq)
        out[impl] = {"y": y.numpy(), "aux": float(aux)}
    _, topi, _ = moe._route(pt, xb.reshape(B * L, -1), cfg)
    ranks, tokens = moe._global_ranks(topi.reshape(B, L, -1),
                                      cfg.n_experts, seq, False)
    out["kept"] = (ranks < moe.capacity(cfg, tokens)).numpy()
    return out


def jax_leaves(tree) -> list:
    """The numpy leaves of a nested parameter tree, in ``jax.tree`` order
    (``models.convert.flatten``)."""
    from repro_torch.models.convert import flatten
    return [leaf for _, leaf in flatten(tree)]


def elastic(directory):
    """Save the reduced qwen2.5-3b's parameters from a (1, 4) mesh (rank 0
    writes whole leaves), restore them onto (2, 2) as each rank's block of
    ``param_pspecs``, and hold every block and the gathered leaves to the
    saved values."""
    from repro_torch.configs import get_arch
    from repro_torch.models import make_model
    from repro_torch.models.convert import flatten, nest, reference_leaves
    from repro_torch.parallel import (gather, local_shard, param_pspecs,
                                      sanitize_pspecs)
    from repro_torch.train import checkpoint as ckpt
    cfg = get_arch("qwen2.5-3b").reduced()
    model = make_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    leaves = reference_leaves(model)
    paths = [leaf.path for leaf in leaves]
    _mesh((1, 4))
    if dist.get_rank() == 0:
        ckpt.save(directory, 3, nest((p, leaf.value())
                                     for p, leaf in zip(paths, leaves)))
    dist.barrier()
    mesh2 = _mesh((2, 2))
    specs = sanitize_pspecs(leaves, param_pspecs(leaves), mesh2)
    like = nest((leaf.path, torch.empty(leaf.shape, dtype=leaf.dtype))
                for leaf in leaves)
    restored, _ = ckpt.restore(directory, 3, like,
                               shardings=nest(zip(paths, specs)), mesh=mesh2)
    block_err = gather_err = 0.0
    n_split = 0
    for leaf, s, (_, blk) in zip(leaves, specs, flatten(restored)):
        full = leaf.value()
        want = local_shard(full, s, mesh2)
        n_split += blk.numel() < full.numel()
        block_err = max(block_err, float((blk - want).abs().max()))
        gather_err = max(gather_err,
                         float((gather(blk, s, mesh2) - full).abs().max()))
    return {"block_err": block_err, "gather_err": gather_err,
            "n_split": n_split, "n_leaves": len(leaves)}


def tp_elastic(directory):
    """``launch.train.train`` of the reduced jamba: 2 steps on (2, 2)
    (tensor parallel, ZeRO-1) saved; restored on (4, 1), which has no step
    left and saves again; then 3 steps on (4, 1) from there, restored on
    (2, 2) and saved again.  Each re-save must write the restored files
    byte for byte (rank 0 compares)."""
    import filecmp
    import pathlib
    import shutil
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    from repro_torch.models.config import ShapeConfig
    cfg = get_arch("jamba-v0.1-52b").reduced()
    shape = ShapeConfig("t", "train", 16, 4)
    d = pathlib.Path(directory)
    kw = dict(log_every=100, device="cpu")
    same = []

    def resave(src, dst, mesh_shape, steps, step):
        if dist.get_rank() == 0:
            shutil.copytree(src, dst)
        dist.barrier()
        train(cfg, shape, steps, ckpt_dir=dst, mesh=_mesh(mesh_shape), **kw)
        if dist.get_rank() == 0:
            a, b = src / f"step_{step:08d}", dst / f"step_{step:08d}"
            files = sorted(p.name for p in a.iterdir())
            match, mismatch, errors = filecmp.cmpfiles(a, b, files,
                                                       shallow=False)
            same.append((len(match), len(mismatch) + len(errors)))

    train(cfg, shape, 2, ckpt_dir=d / "a", mesh=_mesh((2, 2)), **kw)
    resave(d / "a", d / "b", (4, 1), 2, 1)              # (2, 2) -> (4, 1)
    train(cfg, shape, 3, ckpt_dir=d / "b", mesh=_mesh((4, 1)), **kw)
    resave(d / "b", d / "c", (2, 2), 3, 2)              # (4, 1) -> (2, 2)
    return {"same": same}


def sweep(cb, cases):
    """The ``"distributed"`` plan over the world's ranks: per case (``(n,
    seed, plan)``) the result's indices, speedups, gains, aggregates and
    shard rows."""
    from repro_torch.core import ExecPlan, ModelParams, adaptive_sample, price
    out = []
    for n, seed, plan in cases:
        g = adaptive_sample(ModelParams.multinode(), n, seed=seed,
                            mpi_transfer=["hockney", "loggp"],
                            cxl_lat_ns=(250.0, 700.0),
                            cxl_atomic_lat_ns=(300.0, 800.0))
        t0 = time.perf_counter()
        res = price(cb, g, plan=ExecPlan.parse(plan))
        agg = res.aggregates
        out.append({"indices": res.indices, "speedups": res.speedups,
                    "gain_ns": res.result.gain_ns,
                    "n_scenarios": len(res.scenarios),
                    "shard_rows": res.shard_rows,
                    "seconds": time.perf_counter() - t0,
                    "agg": {k: getattr(agg, k) for k in (
                        "count", "speedup_mean", "speedup_min",
                        "speedup_max", "hist", "n_beneficial",
                        "gain_sum")}})
    return out


# ----------------------------------------------------------------- worlds
def world(rank, n, **kw):
    """Every part named in ``kw["parts"]``, in order, with its keyword
    arguments."""
    res = {}
    for name, args in kw["parts"]:
        _parts(res, name, lambda: PARTS[name.split(":")[0]](**args))
    return res


PARTS = {"pipeline": pipeline, "compressed": compressed, "ep_moe": ep_moe,
         "ep_grads": ep_grads, "dp_train": dp_train, "elastic": elastic,
         "sweep": sweep, "tp_model": tp_model, "tp_decode": tp_decode,
         "tp_elastic": tp_elastic, "fsdp_model": fsdp_model,
         "seq_model": seq_model, "seq_decode": seq_decode,
         "seq_moe": seq_moe}
TASKS = {"world": world}
