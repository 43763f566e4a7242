"""Batched serving: prefill a batch of prompts, decode continuations.

Static engine (one batch, ends together):
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --new-tokens 24
Continuous batching (slots + queue, staggered arrivals):
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --continuous

The arch is cut to its reduced config (float32); its weights come from a
``torch.Generator`` seeded 0 and its prompts from
``np.random.default_rng(1)``.  On the card the prefills run the LM kernels.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..configs import get_arch
from ..models.factory import make_model
from ..serve import ContinuousEngine, ServeEngine
from ._args import parser


def build(arch: str, device):
    """The reduced arch's model on ``device``, weights from seed 0."""
    cfg = get_arch(arch).reduced()
    dev = torch.device(device)
    return make_model(cfg, use_kernel=dev.type == "cuda",
                      moe_impl="dense", device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))


def prompts(cfg, batch: int, prompt_len: int) -> np.ndarray:
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)


def arguments(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--continuous", action="store_true")
    return ap.parse_args(argv)


def serve(args):
    """``(engine, outputs, seconds)``: the static engine's ``(batch,
    new_tokens)`` continuation, or the continuous engine's one array per
    request (staggered arrivals, ``new_tokens - 3 * (i % 3)`` tokens)."""
    model = build(args.arch, args.device)
    max_len = args.prompt_len + args.new_tokens
    toks = prompts(model.cfg, args.batch, args.prompt_len)
    if args.continuous:
        engine = ContinuousEngine(model=model,
                                  n_slots=max(2, args.batch // 2),
                                  max_len=max_len,
                                  temperature=args.temperature)
        # stagger arrivals and vary lengths: the scheduler keeps the decode
        # slots busy while requests come and go
        reqs = [(toks[i], args.new_tokens - 3 * (i % 3), 2 * i)
                for i in range(args.batch)]
        t0 = time.time()
        outs = engine.run(reqs)
        return engine, outs, time.time() - t0
    engine = ServeEngine(model=model, max_len=max_len,
                         temperature=args.temperature)
    t0 = time.time()
    out = engine.generate(toks, args.new_tokens)
    return engine, out, time.time() - t0


def main(argv=None) -> int:
    args = arguments(argv)
    engine, out, dt = serve(args)
    if args.continuous:
        n_tok = sum(len(o) for o in out)
        print(f"{len(out)} requests on {engine.n_slots} slots on "
              f"{args.device}: {dt:.2f}s, {n_tok} tokens "
              f"({n_tok / max(dt, 1e-9):.1f} tok/s), occupancy "
              f"{engine.stats.occupancy:.2f}")
        for i, o in enumerate(out[:3]):
            print(f"  request {i} ({len(o)} tokens): "
                  f"...{np.asarray(o)[:10].tolist()}")
        return 0
    print(f"batch={args.batch} prompt={args.prompt_len} "
          f"new={args.new_tokens} on {args.device}: {dt:.2f}s "
          f"({args.batch * args.new_tokens / max(dt, 1e-9):.1f} tok/s)")
    for i in range(min(2, args.batch)):
        print(f"  request {i}: ...{out[i, :12].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
