"""Serving driver: batched generation with the static, continuous or paged
engine, plus an optional CXL-scenario pricing pass over the deployment's
collectives (``--price-sweep``, the ``price(engine, grid)`` front door);
the JAX package's ``launch/serve.py``.

The model's weights come from a generator seeded with 0 and the prompt is
drawn with numpy (``default_rng(1)``), not with ``jax.random``: the tokens
differ from the reference driver's.  It runs on the card unless
``--device cpu`` is given.

    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --reduced \\
        --paged --price-sweep
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_arch
from ..models import factory
from ..serve.engine import ServeEngine
from ..serve.scheduler import ContinuousEngine, ServeStats


def _price_deployment(engine, plan_spec: str, **compile_kwargs) -> None:
    """Price every compiled step of ``engine`` under the advisor's default
    CXL latency-band grid in one batched call and print the verdict."""
    from ..core import CommAdvisor, ExecPlan, price
    plan = ExecPlan.parse(plan_spec)
    adv = CommAdvisor()
    grid = adv.default_grid(4, 4)
    multi = price(engine.compiled_steps(**compile_kwargs), grid, plan=plan,
                  advisor=adv)
    speed = multi.predicted_speedup()
    best = multi.best_scenario()
    print(f"price-sweep: {len(multi)} steps x {len(grid)} scenarios "
          f"(backend={plan.backend})")
    for name, r in zip(multi.names, multi):
        s = r.predicted_speedup()
        print(f"  {name:16s} {r.compiled.n_calls:3d} collectives, "
              f"speedup band [{s.min():.3f}, {s.max():.3f}]x")
    print(f"  best scenario {grid.labels()[best]} -> {speed[best]:.3f}x "
          "deployment speedup")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="serving driver")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="retire sequences that sample this token")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching scheduler (slots + queue) "
                         "instead of the static batch")
    ap.add_argument("--paged", action="store_true",
                    help="block/paged KV cache from a shared pool "
                         "(implies --continuous)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block for --paged (also the "
                         "chunked-prefill chunk length)")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="shared KV pool size for --paged (0: the dense "
                         "equivalent, no admission backpressure)")
    ap.add_argument("--slots", type=int, default=0,
                    help="decode slots for --continuous (default: --batch)")
    ap.add_argument("--price-sweep", action="store_true",
                    help="price the deployment's collectives under the "
                         "advisor's CXL latency grid after generating")
    ap.add_argument("--price-backend", default="numpy",
                    help="ExecPlan spec for --price-sweep, e.g. 'fused' or "
                         "'torch:device=cpu' (see ExecPlan.parse)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.frontend is not None:
        raise SystemExit("serve driver supports token-LM archs; "
                         "multimodal decode is exercised by the tests")
    model = factory.make_model(cfg, device=args.device)
    max_len = args.prompt_len + args.new_tokens
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)

    if args.continuous or args.paged:
        if args.paged:
            from ..serve.paged import PagedContinuousEngine
            engine = PagedContinuousEngine(
                model=model, n_slots=args.slots or args.batch,
                max_len=max_len, temperature=args.temperature,
                eos_id=args.eos_id, block_size=args.block_size,
                pool_blocks=args.pool_blocks)
        else:
            engine = ContinuousEngine(model=model,
                                      n_slots=args.slots or args.batch,
                                      max_len=max_len,
                                      temperature=args.temperature,
                                      eos_id=args.eos_id)
        # warmup: the first prefill and decode step off the clock
        engine.run([(prompt[0], 2)])
        engine.stats = ServeStats(n_slots=engine.n_slots)  # drop warmup stats
        t0 = time.perf_counter()
        outs = engine.run([(prompt[i], args.new_tokens)
                           for i in range(args.batch)])
        dt = max(time.perf_counter() - t0, 1e-9)
        n_tok = sum(len(o) for o in outs)
        s = engine.stats
        print(f"generated {len(outs)} requests / {n_tok} tokens in "
              f"{dt:.2f}s ({n_tok / dt:.1f} tok/s, occupancy "
              f"{s.occupancy:.2f}, {s.decode_steps} decode steps)")
        if args.paged:
            frac = engine.kv_bytes_peak / max(engine.kv_bytes_dense, 1)
            print(f"kv bytes: peak {engine.kv_bytes_peak} vs dense "
                  f"{engine.kv_bytes_dense} ({frac:.0%} of the dense cache)")
        print("sample:", np.asarray(outs[0])[:16].tolist())
        if args.price_sweep:
            _price_deployment(engine, args.price_backend)
        return 0

    engine = ServeEngine(model=model, max_len=max_len,
                         temperature=args.temperature)
    # warmup generate off the clock, so the reported tok/s is steady state
    engine.generate(prompt, min(2, args.new_tokens))
    sync = torch.cuda.synchronize if model.device.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = engine.generate(prompt, args.new_tokens, eos_id=args.eos_id)
    sync()
    dt = max(time.perf_counter() - t0, 1e-9)   # clock granularity guard
    arr = out.cpu().numpy()
    if args.eos_id is None:
        n_tok = args.batch * args.new_tokens
    else:                       # count up to and including each row's eos —
        hit = arr == args.eos_id    # the padding after it was never generated
        n_tok = int(np.where(hit.any(axis=1), hit.argmax(axis=1) + 1,
                             arr.shape[1]).sum())
    tok_s = n_tok / dt
    print(f"generated {tuple(arr.shape)} ({n_tok} real tokens) in {dt:.2f}s "
          f"({tok_s:.1f} tok/s)")
    print("sample:", arr[0, :16].tolist())
    if args.price_sweep:
        _price_deployment(engine, args.price_backend,
                          batch_size=args.batch, prompt_len=args.prompt_len)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
