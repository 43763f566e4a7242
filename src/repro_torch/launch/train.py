"""Training driver: the train loop with fault-tolerant checkpointing, the
JAX package's ``launch/train.py``, on one device or over the ranks of a
mesh: data parallelism over its data axes (AdamW's moments ZeRO-1-sharded
by default) and tensor parallelism over its ``model`` axis (the model
built on the mesh; MoE archs dispatch ``ep_local``), or with
``--layout fsdp_seq`` pure FSDP over every rank with the sequence split
over ``model`` (``models.lm.LanguageModel``; MoE archs route
``scatter``).

Fault-tolerance contract:
  * restart-safe: on launch, restores the latest checkpoint if present;
  * deterministic data: batches are pure functions of (seed, step), so a
    restore resumes the exact batch stream;
  * elastic: the checkpoints hold whole leaves (rank 0 writes the
    parameters and moments gathered over the data and model ranks), so a
    run on any mesh resumes another's.

The checkpoints have the reference's layout and leaves (``{"params",
"opt"}``, see ``train.checkpoint``), so either package restores the
other's.  A save in flight is finished before :func:`train` returns or
raises.  The model is built without the kernels, as the reference's
trainer builds it; it runs on the card unless ``device`` names another.

    python -m repro_torch.launch.train --arch qwen2.5-3b --reduced --steps 20
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch qwen2.5-3b --reduced --steps 20 \
        --mesh 2,2 --backend gloo --device cpu [--layout fsdp_seq]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.distributed as dist

from ..configs import get_arch
from ..models import factory
from ..models.config import ShapeConfig
from ..models.convert import flatten, nest, reference_leaves
from ..train import checkpoint as ckpt
from ..parallel import sharding
from ..train.data import make_data
from ..train.loop import make_train_step
from ..train.optimizer import AdamWConfig, adamw_init, zero1_blocks
from . import mesh as meshes


def _tree(params, opt_state, host: bool = False, blocks=None,
          mesh=None) -> dict:
    """The reference's checkpoint tree (``{"params", "opt"}``) of the leaves
    and the AdamW state, the moments gathered from their ZeRO-1 ``blocks``
    and every leaf from its blocks over ``model`` (a collective: every
    rank calls it); with ``host``, empty host tensors of the leaves' whole
    shapes and dtypes instead, for ``restore`` to read into (a restart
    then copies each leaf, or this rank's block, onto the device, so it
    holds no second copy of the state there)."""
    blocks = blocks or [None] * len(params)
    cols = {"params": params, "mu": opt_state["mu"], "nu": opt_state["nu"]}
    if host:
        cols = {k: [torch.empty(leaf.whole_shape, dtype=x.dtype)
                    for leaf, x in zip(params, v)]
                for k, v in cols.items()}
    else:
        cols["params"] = [leaf.gather(leaf.value()) for leaf in params]
        for k in ("mu", "nu"):
            cols[k] = [leaf.gather(
                x if b is None else sharding.gather(x, b.spec, mesh))
                for leaf, x, b in zip(params, cols[k], blocks)]
    paths = [leaf.path for leaf in params]
    tree = {k: nest(zip(paths, v)) for k, v in cols.items()}
    return {"params": tree["params"],
            "opt": {"count": opt_state["count"], "mu": tree["mu"],
                    "nu": tree["nu"]}}


def _shardings(params, blocks) -> dict:
    """``restore``'s shardings of :func:`_tree`: each leaf's block under
    its executed layout (``Leaf.take``), and each moment's ZeRO-1 block of
    that."""
    blocks = blocks or [None] * len(params)
    paths = [leaf.path for leaf in params]

    def moment(leaf, b):
        if b is None:
            return leaf.take
        return lambda t: b.take(leaf.take(t))
    moments = nest(zip(paths, [moment(leaf, b)
                               for leaf, b in zip(params, blocks)]))
    return {"params": nest(zip(paths, [leaf.take for leaf in params])),
            "opt": {"count": None, "mu": moments, "nu": moments}}


@torch.no_grad()
def _load(params, opt_state, tree) -> None:
    """Write a restored :func:`_tree` into the leaves and the state."""
    for leaf, (_, value) in zip(params, flatten(tree["params"])):
        leaf.assign(value)
    for key in ("mu", "nu"):
        for dst, (_, value) in zip(opt_state[key], flatten(tree["opt"][key])):
            dst.copy_(value)
    opt_state["count"] = tree["opt"]["count"]


def train(cfg, shape: ShapeConfig, n_steps: int,
          opt_cfg: AdamWConfig | None = None, n_micro: int = 1,
          ckpt_dir=None, ckpt_every: int = 50, restore: bool = True,
          log_every: int = 10, seed: int = 0,
          fail_at_step: int | None = None, device="cuda", mesh=None,
          zero1: bool = True, layout: str = "tp"):
    """Returns (the trained model, history list of dicts).

    ``mesh``: data parallelism over its data axes and tensor parallelism
    over its ``model`` axis (every rank of the process group calls
    :func:`train` with the same arguments; each takes its data rows of
    every global batch); ``zero1``: AdamW's moments as each rank's block;
    ``layout``: ``"tp"`` or ``"fsdp_seq"`` (``LanguageModel``).  A history
    entry holds the step's loss (the global batch's), grad norm, lr, its
    wall time ``step_s`` and this rank's moment bytes."""
    dev = factory.torch_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=n_steps)
    rank = 0
    if mesh is not None:
        rank = dist.get_rank()
    tp = sharding.model_axis(mesh) is not None and layout == "tp"
    model = factory.make_model(
        cfg, device=dev, generator=torch.Generator(device=dev)
        .manual_seed(seed), mesh=mesh, layout=layout,
        moe_impl="ep_local" if tp and cfg.n_experts else "scatter")
    data = make_data(cfg, shape, seed=seed, device=dev)
    params = reference_leaves(model)
    blocks = zero1_blocks(params, mesh) if mesh is not None and zero1 \
        else None
    opt_state = adamw_init(params, blocks=blocks)
    moment_bytes = sum(x.numel() * x.element_size()
                       for k in ("mu", "nu") for x in opt_state[k])

    def log(msg):
        if rank == 0:
            print(msg, flush=True)

    start_step = 0
    saver = None
    if ckpt_dir is not None:
        saver = ckpt.AsyncCheckpointer(ckpt_dir)
        latest = ckpt.latest_step(ckpt_dir)
        if restore and latest is not None:
            restored, extra = ckpt.restore(
                ckpt_dir, latest, _tree(params, opt_state, host=True),
                shardings=_shardings(params, blocks), mesh=mesh)
            _load(params, opt_state, restored)
            start_step = int(extra.get("step", latest)) + 1
            log(f"[train] restored step {latest}, resuming at {start_step}")

    def save(step):
        tree = _tree(params, opt_state, blocks=blocks, mesh=mesh)
        if rank == 0:
            saver.save(step, tree, {"step": step})

    step_fn = make_train_step(model.loss, opt_cfg, n_micro=n_micro,
                              mesh=mesh, zero1=zero1)
    history = []
    t0 = time.time()
    try:
        for step in range(start_step, n_steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            ts = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state,
                                           data.batch(step))
            if step % log_every == 0 or step == n_steps - 1:
                loss = float(m.loss)
                history.append({"step": step, "loss": loss,
                                "grad_norm": float(m.grad_norm),
                                "lr": float(m.lr),
                                "elapsed_s": time.time() - t0,
                                "step_s": time.perf_counter() - ts,
                                "moment_bytes": moment_bytes})
                log(f"[train] step {step:5d} loss {loss:8.4f} "
                    f"gnorm {float(m.grad_norm):7.3f}")
            if saver is not None and step % ckpt_every == 0 and step > 0:
                save(step)
        if saver is not None:
            save(n_steps - 1)
    finally:
        if saver is not None:
            saver.wait()
    if mesh is not None and saver is not None:
        dist.barrier()                 # the files exist for every rank
    return model, history


# --------------------------------------------------------------------------
# Captured entry point (repro_torch.analysis.ircheck registration)
# --------------------------------------------------------------------------

def _ircheck_train_step_spec(device="cpu", abstract=True):
    """The train step as :func:`train` builds it (``make_train_step``,
    AdamW with float32 moments), over the reference's reduced qwen2.5-3b at
    sequence 16 and batch 2.  The parameters and both moments are updated
    in place; the step count is a fresh host scalar each step.  Built
    under fake tensors when ``abstract`` (a capture's gradients need the
    parameters the capture sees), the count stays a real host scalar (the
    schedule reads it)."""
    from ..analysis.ircheck import EntrySpec, src_for
    from ..core.graph import abstract as fake

    cfg = get_arch("qwen2.5-3b").reduced()
    shape = ShapeConfig("ircheck", "train", 16, 2)
    build = lambda: factory.make_model(cfg, device=device)
    model = fake(build) if abstract else build()
    params = reference_leaves(model)
    opt_state = fake(adamw_init, params) if abstract else adamw_init(params)
    opt_state["count"] = torch.zeros((), dtype=torch.int32)
    batch = factory.make_inputs(cfg, shape, device=device)
    step = make_train_step(model.loss, AdamWConfig(total_steps=10))
    return EntrySpec(name="train.step", fn=step,
                     args=(params, opt_state, batch),
                     inplace=(0, (1, "mu"), (1, "nu")), grad=True,
                     allow_syncs={
                         "aten::lift_fresh@src/repro_torch/train/optimizer.py":
                         "the learning-rate schedule's float32 scalars are "
                         "made and read on the host (the reference's float32 "
                         "arithmetic); they never reach the card"},
                     src=src_for(make_train_step))


def register_ircheck_entrypoints(register) -> None:
    """Register the train step with ``repro_torch.analysis.ircheck``."""
    register("train.step", _ircheck_train_step_spec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="training driver")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    ap.add_argument("--mesh", default=None,
                    help="D,M or P,D,M: the mesh over the axes data,model "
                    "(pod,data,model) of the torchrun world")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (needed with --mesh)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch to this many layers")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--layout", default="tp", choices=("tp", "fsdp_seq"),
                    help="with --mesh: tensor parallelism over model, or "
                    "pure FSDP with the sequence split over model")
    ap.add_argument("--summary", action="store_true",
                    help="print one JSON line per rank: history, moment "
                    "and peak device bytes")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    opt_cfg = AdamWConfig(total_steps=args.steps, **(
        {"lr": args.lr} if args.lr is not None else {}))
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    mesh = None
    if args.mesh is not None:
        if args.backend is None:
            ap.error("--mesh needs --backend (gloo or nccl)")
        dims = tuple(int(x) for x in args.mesh.split(","))
        axes = ("data", "model") if len(dims) == 2 \
            else ("pod", "data", "model")
        dev = meshes.init_ranks(args.backend, args.device)
        mesh = meshes.make_mesh(dims, axes, dev.type)
    else:
        dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        _, history = train(cfg, shape, args.steps, opt_cfg=opt_cfg,
                           n_micro=args.micro, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           log_every=args.log_every,
                           fail_at_step=args.fail_at_step, device=dev,
                           mesh=mesh, layout=args.layout)
        if args.summary:
            # one write per line: ranks share the launcher's stdout, and an
            # unbuffered print writes the text and its newline apart
            sys.stdout.write(json.dumps({
                "rank": dist.get_rank() if mesh is not None else 0,
                "world": dist.get_world_size() if mesh is not None else 1,
                "history": history,
                "peak_bytes": torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None}) + "\n")
            sys.stdout.flush()
        if history and (mesh is None or dist.get_rank() == 0):
            print(f"final loss: {history[-1]['loss']:.4f}")
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
