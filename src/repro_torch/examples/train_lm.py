"""End-to-end training: a ~100M-parameter LM for a few hundred
steps, with checkpointing and restart safety (``launch.train.train`` on
one device).

The config is a scaled member of the qwen2.5 family (same topology).  On
the CPU use ``--small`` (a ~25M model) for a fast run; the default ~100M
config is the deliverable shape and trains identically.  The checkpoints
go to ``--ckpt-dir``, or to a temporary directory that is removed after.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --small --steps 200
"""
from __future__ import annotations

import tempfile

from ..configs import get_arch
from ..launch.train import train
from ..models.config import ShapeConfig
from ..train.optimizer import AdamWConfig
from ._args import parser


def config_100m():
    return get_arch("qwen2.5-3b").replace(
        name="qwen-family-100m", n_layers=10, d_model=640, n_heads=10,
        n_kv_heads=2, d_ff=2560, vocab_size=50304, dtype="float32",
        remat=False)


def config_small():
    return get_arch("qwen2.5-3b").replace(
        name="qwen-family-25m", n_layers=6, d_model=384, n_heads=6,
        n_kv_heads=2, d_ff=1536, vocab_size=16384, dtype="float32",
        remat=False)


def run(args) -> list:
    """Train as ``args`` say; returns the history."""
    cfg = config_small() if args.small else config_100m()
    n_params_est = (2 * cfg.vocab_size * cfg.d_model
                    + cfg.n_layers * (4 * cfg.d_model * cfg.d_model
                                      + 3 * cfg.d_model * cfg.d_ff))
    print(f"training {cfg.name} (~{n_params_est / 1e6:.0f}M params) for "
          f"{args.steps} steps on {args.device}")
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=min(20, args.steps // 2),
                      total_steps=args.steps)
    with tempfile.TemporaryDirectory() as tmp:
        _, history = train(cfg, shape, args.steps, opt_cfg=opt,
                           ckpt_dir=args.ckpt_dir or tmp, ckpt_every=100,
                           log_every=args.log_every, device=args.device)
    return history


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    history = run(args)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({history[-1]['elapsed_s']:.0f}s)")
    if not last < first:
        raise SystemExit("training did not make progress")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
