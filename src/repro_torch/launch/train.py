"""Training driver: the train loop with fault-tolerant checkpointing, the
JAX package's ``launch/train.py`` on one device (its mesh and ZeRO-1
sharding are not ported).

Fault-tolerance contract:
  * restart-safe: on launch, restores the latest checkpoint if present;
  * deterministic data: batches are pure functions of (seed, step), so a
    restore resumes the exact batch stream.

The checkpoints have the reference's layout and leaves (``{"params",
"opt"}``, see ``train.checkpoint``), so either package restores the
other's.  A save in flight is finished before :func:`train` returns or
raises.  The model is built without the kernels, as the reference's
trainer builds it; it runs on the card unless ``device`` names another.

    python -m repro_torch.launch.train --arch qwen2.5-3b --reduced --steps 20
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_arch
from ..models import factory
from ..models.config import ShapeConfig
from ..models.convert import flatten, nest, reference_leaves
from ..train import checkpoint as ckpt
from ..train.data import make_data
from ..train.loop import make_train_step
from ..train.optimizer import AdamWConfig, adamw_init


def _tree(params, opt_state, host: bool = False) -> dict:
    """The reference's checkpoint tree (``{"params", "opt"}``) of the leaves
    and the AdamW state; with ``host``, empty host tensors of the same
    shapes and dtypes instead, for ``restore`` to read into (a restart
    then copies each leaf onto the device, so it holds no second copy of
    the state there)."""
    cols = {"params": params, "mu": opt_state["mu"], "nu": opt_state["nu"]}
    if host:
        cols = {k: [torch.empty(x.shape, dtype=x.dtype) for x in v]
                for k, v in cols.items()}
    else:
        cols["params"] = [leaf.value() for leaf in params]
    paths = [leaf.path for leaf in params]
    tree = {k: nest(zip(paths, v)) for k, v in cols.items()}
    return {"params": tree["params"],
            "opt": {"count": opt_state["count"], "mu": tree["mu"],
                    "nu": tree["nu"]}}


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
          fail_at_step: int | None = None, device="cuda"):
    """Returns (the trained model, history list of dicts)."""
    dev = factory.torch_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=n_steps)
    model = factory.make_model(
        cfg, device=dev, generator=torch.Generator(device=dev)
        .manual_seed(seed))
    data = make_data(cfg, shape, seed=seed, device=dev)
    params = reference_leaves(model)
    opt_state = adamw_init(params)

    start_step = 0
    saver = None
    if ckpt_dir is not None:
        saver = ckpt.AsyncCheckpointer(ckpt_dir)
        latest = ckpt.latest_step(ckpt_dir)
        if restore and latest is not None:
            restored, extra = ckpt.restore(
                ckpt_dir, latest, _tree(params, opt_state, host=True))
            _load(params, opt_state, restored)
            start_step = int(extra.get("step", latest)) + 1
            print(f"[train] restored step {latest}, resuming at "
                  f"{start_step}")

    step_fn = make_train_step(model.loss, opt_cfg, n_micro=n_micro)
    history = []
    t0 = time.time()
    try:
        for step in range(start_step, n_steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            params, opt_state, m = step_fn(params, opt_state,
                                           data.batch(step))
            if step % log_every == 0 or step == n_steps - 1:
                loss = float(m.loss)
                history.append({"step": step, "loss": loss,
                                "grad_norm": float(m.grad_norm),
                                "lr": float(m.lr),
                                "elapsed_s": time.time() - t0})
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(m.grad_norm):7.3f}")
            if saver is not None and step % ckpt_every == 0 and step > 0:
                saver.save(step, _tree(params, opt_state), {"step": step})
        if saver is not None:
            saver.save(n_steps - 1, _tree(params, opt_state),
                       {"step": n_steps - 1})
    finally:
        if saver is not None:
            saver.wait()
    return model, history


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
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    _, history = train(cfg, shape, args.steps, n_micro=args.micro,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       fail_at_step=args.fail_at_step, device=args.device)
    print(f"final loss: {history[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
