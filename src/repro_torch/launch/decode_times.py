"""Times of a language model's TP prefill and decode steps over gloo ranks
that share one card.

    torchrun --nproc-per-node 4 src/repro_torch/launch/decode_times.py \\
        [--mesh 1,4] [--prompt 2,1024] [--steps 8] [--out FILE]

Each rank builds qwen2.5-3b at its published widths and depth (bf16, its
weights from a ``torch.Generator`` seeded 0, the flash kernel on) under
``layout="tp"`` on a (data, model) mesh, prefills a random prompt of
``--prompt`` rows and tokens into a 4,096-position cache twice (the second
timed) and takes ``--steps`` greedy decode steps, each timed with the card
synchronized around it.  Rank 0 prints one JSON object (and writes it to
``--out``): for every rank the prefill's ms, each step's ms and their
median, the attention caches' bytes, the collectives a decode step makes
(calls and bytes put in, over all routes), the peak memory and the greedy
tokens.

It uses only the port's public entry points and passes ``global_batch=``
and ``max_len=`` only where they are taken, so the one file also times
another checkout of the port:
``PYTHONPATH=<checkout>/src torchrun --nproc-per-node 4 <this file>``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import time

import torch

ARCH, CACHE, SEED = "qwen2.5-3b", 4096, 0


def _ints(text: str) -> tuple:
    return tuple(int(x) for x in text.split(","))


def arguments(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", type=_ints, default=(1, 4),
                    help="data,model")
    ap.add_argument("--prompt", type=_ints, default=(2, 1024),
                    help="rows,tokens of the global batch")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def _taken(fn, **kw) -> dict:
    """The keywords of ``kw`` that ``fn`` takes."""
    names = inspect.signature(fn).parameters
    return {k: v for k, v in kw.items() if k in names}


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rank_times(args) -> dict:
    """This rank's prefill and decode times, cache bytes and collectives."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.models import make_model
    from repro_torch.parallel import transport

    dev = init_ranks("gloo", "cuda")
    mesh = make_mesh(args.mesh, ("data", "model"), "cuda")
    cfg = configs.get_arch(ARCH)
    model = make_model(cfg, use_kernel=True, device=dev, mesh=mesh,
                       generator=torch.Generator(device=dev)
                       .manual_seed(SEED))
    B, S = args.prompt
    prompt = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                           dtype=torch.int32,
                           generator=torch.Generator(device=dev)
                           .manual_seed(SEED + 1))
    n_data, d = args.mesh[0], mesh.get_coordinate()[0]
    if B % n_data == 0:                     # the rank's rows of the batch
        prompt = prompt[d * (B // n_data):(d + 1) * (B // n_data)]
    pkw = _taken(model.prefill, global_batch=B)
    dkw = _taken(model.decode_step, max_len=CACHE, global_batch=B)
    out = {"rank": dist.get_rank(), "coord": list(mesh.get_coordinate())}
    with torch.inference_mode():
        prefill = lambda: model.prefill({"tokens": prompt}, CACHE,
                                        **pkw)
        _, out["prefill_first_ms"] = _timed(prefill)
        dist.barrier()
        (logits, caches), out["prefill_ms"] = _timed(prefill)
        tok = logits.argmax(-1)
        tokens, steps = [tok.cpu()], []
        before = transport.snapshot()
        for i in range(args.steps):
            (logits, caches), ms = _timed(lambda: model.decode_step(
                caches, {"tokens": tok}, S + i, **dkw))
            tok = logits.argmax(-1)
            tokens.append(tok.cpu())
            steps.append(ms)
        coll = transport.since(before)
    out.update(
        decode_ms=steps, decode_median_ms=statistics.median(steps),
        cache_bytes=sum(t.numel() * t.element_size() for c in caches
                        if isinstance(c, dict) for t in c.values()),
        decode_collectives={op: [calls / args.steps, nbytes / args.steps]
                            for op, (calls, nbytes) in coll.items()},
        peak_bytes=torch.cuda.max_memory_allocated(),
        tokens=torch.cat(tokens, 1).tolist())
    return out


def main(argv=None) -> int:
    import torch.distributed as dist
    args = arguments(argv)
    mine = rank_times(args)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    if dist.get_rank() == 0:
        rec = {"arch": ARCH, "mesh": list(args.mesh),
               "prompt": list(args.prompt), "cache": CACHE,
               "steps": args.steps,
               "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "ranks": ranks}
        text = json.dumps(rec)
        print(text)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text + "\n")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
