"""Wall times of the host-bound paths that the kernel wrappers sit on.

``python -m repro_torch.launch.wall_times [--reps N]`` times on the card,
with the device synchronized around every call:

* ``price()`` of 262,144 multinode scenarios as an ``ArraySet`` (one
  bracket kernel launch through its wrapper);
* the streaming ``price(plan="distributed:topk=64,refine=1")`` over
  1,048,576 scenarios (17 bracket launches);
* ``fused_bracket_segsum`` through its wrapper on 512 scenarios and
  three prepared groups of 64 samples over 4 sites (the host's cost a
  call; the mean of 200 calls in a row);
* ``flash_attention`` and ``mamba_scan`` through their wrappers, at a small
  shape (the host's cost a call: the checks, the guard, the op dispatch,
  the launch; the mean of 200 calls in a row) and at the LM prefill's (q
  (2, 4096, 32, 128) bf16 causal; x (2, 4096, 8192), 16 states).

It prints one JSON object: every run's times and their medians, in
seconds.  It uses only ``repro_torch``'s public pricing and kernel entry
points, so the one file also times another checkout of the port:
``PYTHONPATH=<checkout>/src python <this file>``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

S_PRICE = 262_144
S_STREAM = 524_288                      # x 2 MPI transfer models
STREAM_PLAN = "distributed:topk=64,refine=1"
SMALL_CALLS = 200


def bundle():
    """A compiled bundle of four call sites with 64 load samples each (the
    size of the stencil's at tile 4,096), made from fixed numbers."""
    from repro_torch.core.sweep import compile_bundle
    from repro_torch.core.traces import (CommRecord, CounterSet, DataSource,
                                         LoadSample, TraceBundle)
    b = TraceBundle(sampling_period=500.0)
    b.counters = CounterSet(ld_ins=5e9, l1_ldm=6e8, l3_ldm=9e7,
                            tot_cyc=3.1e9, imc_reads=2.2e8,
                            wall_time_ns=1.5e9)
    sources = tuple(DataSource)
    for i in range(4):
        cid = f"site_{i}"
        for j in range(64):
            b.add_sample(LoadSample(
                call_id=cid, lat_ns=30.0 + 17.0 * ((3 * i + j) % 13),
                source=sources[(i + j) % len(sources)],
                weight=1.0 + 0.25 * (j % 8)))
        b.add_comm(CommRecord(call_id=cid, bytes=4096 * (i + 1), count=3))
    return compile_bundle(b)


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def per_call(fn, n: int) -> float:
    """The mean wall time of ``n`` calls in a row (one sync at the end)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.wall_times",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5,
                    help="timed runs of each path (default 5)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wall_times: no CUDA device")

    import repro_torch.core as pt
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.sweep_bracket import (csr_group,
                                                   fused_bracket_segsum)

    dev = torch.device("cuda")
    cb = bundle()
    ranges = dict(cxl_lat_ns=(250, 700), cxl_atomic_lat_ns=(300, 800))
    aset = pt.adaptive_sample(pt.ModelParams.multinode(), S_PRICE, seed=0,
                              **ranges)
    seed = pt.adaptive_sample(pt.ModelParams.multinode(), S_STREAM, seed=1,
                              mpi_transfer=["hockney", "loggp"], **ranges)
    rng = np.random.default_rng(0)

    def t(shape, dtype=torch.float32, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape) * scale, dtype=dtype,
                               device=dev)

    def attn(B, S, Hq, Hkv, D):
        q, k, v = (t(s, torch.bfloat16) for s in (
            (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
        return lambda: flash_attention(q, k, v, causal=True)

    def scan(B, L, d):
        x, Bt, Ct = t((B, L, d)), t((B, L, 16)), t((B, L, 16))
        dt = torch.abs(t((B, L, d), scale=0.02)) + 0.05
        A = -torch.abs(t((d, 16), scale=0.3)) - 1.0
        D = t((d,))
        return lambda: mamba_scan(x, dt, Bt, Ct, A, D)

    def bracket(S, n_seg, n):
        f64 = torch.float64
        seg = [torch.as_tensor(np.sort(rng.integers(0, n_seg, n)),
                               device=dev) for _ in range(3)]
        groups = [csr_group(t((n,), f64, 100.0).abs() + 1.0,
                            t((n,), f64).abs(), s, n_seg) for s in seg]
        d, x = t((S,), f64, 100.0), t((S,), f64, 100.0).abs() + 150.0
        return lambda: fused_bracket_segsum(*groups, d, x, n_seg)

    paths = {
        "bracket small a call": (bracket(512, 4, 64), SMALL_CALLS),
        "price ArraySet": (lambda: pt.price(cb, aset), None),
        "streaming": (lambda: pt.price(cb, seed, plan=STREAM_PLAN), None),
        "flash small a call": (attn(1, 128, 8, 2, 128), SMALL_CALLS),
        "scan small a call": (scan(1, 64, 64), SMALL_CALLS),
        "flash prefill": (attn(2, 4096, 32, 8, 128), None),
        "scan prefill": (scan(2, 4096, 8192), None),
    }
    runs = {name: [] for name in paths}
    for name, (fn, n) in paths.items():
        fn()                                       # builds, warms the cache
        torch.cuda.synchronize()
    for _ in range(args.reps):                     # paths in turns
        for name, (fn, n) in paths.items():
            runs[name].append(per_call(fn, n) if n else timed(fn))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "median_s": {k: statistics.median(v) for k, v in runs.items()},
        "runs_s": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
