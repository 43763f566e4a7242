#!/usr/bin/env python3
"""Drive the PyTorch port's pricing path on one CUDA GPU, and check it.

    python3 chip_smoke.py

Run from the root of the checkout on a machine with an NVIDIA H100 (any
sm_90 card), ``nvcc`` and PyTorch built for CUDA.  Phases, in order; any
failure exits non-zero and no result line is printed:

  1. device   — the card's name and power limit (nvidia-smi), CUDA version;
  2. build    — ``nvcc`` builds ``csrc/sweep_bracket.cu`` for sm_90a;
  3. kernels  — both CUDA kernels against their plain PyTorch versions on
                the card (f64 and f32, the reference's test shapes);
  4. main path — for each Fig. 7 stencil tile: memsim ``collect`` ->
                ``compile_bundle`` -> ``price`` of 262,144 scenarios under
                the default plan (the fused kernel on "cuda"); the kernel's
                launch count must rise; the result must agree with the
                "torch" backend on every row and with the host "numpy"
                backend on 16,384 rows (rtol 1e-9), and scenario chunking
                must be bit-identical;
  5. times    — CUDA-event medians of the kernels, their plain versions and
                ``index_add_``, and ``price()`` split into host view, H2D,
                device pricing and D2H;
  6. the ``kernels`` JSON line, the nvidia-smi line, and last
     ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

S_MAIN = 262_144              # scenarios per price() call (2**18)
S_HOST = 16_384               # rows also priced on the host
CHUNK = 65_536
TILES = (32, 128, 512, 1024, 2048, 4096)     # the paper's Fig. 7 tiles
RTOL_PATH = 1e-9
DEVICE = "cuda"
TOL = {"f64": dict(rtol=1e-12, atol=1e-9), "f32": dict(rtol=2e-5, atol=1e-2),
       "segsum": dict(rtol=1e-12, atol=1e-12)}
# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, and float64
# operations/s outside the tensor cores (the kernels' type and unit).
HBM_BYTES_S = 3.35e12
FP64_OPS_S = 34e12
BRACKET_CASES = [(1, 1, 4, 0, 3), (3, 5, 40, 17, 29), (16, 3, 128, 128, 128),
                 (7, 130, 200, 150, 90), (2, 4, 0, 0, 0), (2, 3, 640, 10, 5),
                 (0, 3, 10, 5, 2), (4, 0, 0, 0, 0)]


def log(*args):
    print(*args, flush=True)


def cuda_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_s(torch, fn, reps: int) -> tuple:
    """(median seconds, last result) of ``fn()`` ending in a synchronize."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def max_abs_err(got: dict, want: dict, tol: dict) -> float:
    """Hold every tensor of ``got`` against ``want`` (raises on a miss)."""
    import numpy as np
    err = 0.0
    for k in want:
        a, b = got[k].cpu().numpy(), want[k].cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape)
        np.testing.assert_allclose(a, b, err_msg=k, **tol)
        if a.size:
            err = max(err, float(np.max(np.abs(a - b))))
    return err


def rel_diff(np, a, b) -> float:
    """Largest |a - b| / |b| (zeros of ``b`` count as the smallest normal)."""
    tiny = np.finfo(np.float64).tiny
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), tiny)))


def phase_kernels(torch, np, sb):
    """Both kernels against their plain versions at the reference's test
    shapes (f64 and f32 for the fused kernel, unsorted ids for the segment
    sum)."""
    dev = torch.device(DEVICE)
    for dtype, tol in ((torch.float64, TOL["f64"]), (torch.float32, TOL["f32"])):
        for S, n_seg, *ns in BRACKET_CASES:
            rng = np.random.default_rng(S * 100 + sum(ns))
            groups = []
            for n in ns:
                seg = np.sort(rng.integers(0, max(n_seg, 1), size=n))
                groups.append((
                    torch.as_tensor(rng.uniform(1.0, 500.0, n), dtype=dtype,
                                    device=dev),
                    torch.as_tensor(rng.uniform(0.1, 3.0, n), dtype=dtype,
                                    device=dev),
                    torch.as_tensor(seg, dtype=torch.int32, device=dev)))
            d = torch.as_tensor(rng.uniform(-150, 400, (S, 1)), dtype=dtype,
                                device=dev)
            x = torch.as_tensor(rng.uniform(150, 700, (S, 1)), dtype=dtype,
                                device=dev)
            before = sb.fused_bracket_segsum.launches
            out = sb.fused_bracket_segsum(*groups, d, x, n_seg)
            torch.cuda.synchronize()
            launched = sb.fused_bracket_segsum.launches - before
            assert launched == (1 if S and n_seg else 0), (S, n_seg, launched)
            err = max_abs_err(out, sb.bracket_segsum_ref(*groups, d, x, n_seg),
                              tol)
            log(f"kernel fused_bracket_segsum {str(dtype)[6:]} S={S} "
                f"n_seg={n_seg} n={ns}: ok, max_abs_err={err:.3e}")
    rng = np.random.default_rng(5)
    xs = torch.as_tensor(rng.normal(size=(3, 70)), device=dev)
    ids = torch.as_tensor(rng.integers(0, 6, size=70), dtype=torch.int32,
                          device=dev)
    out = sb.segment_sum(xs, ids, 6)
    torch.cuda.synchronize()
    err = max_abs_err({"x": out}, {"x": sb.segment_sum_ref(xs, ids, 6)},
                      TOL["segsum"])
    log(f"kernel segment_sum f64 unsorted ids (3, 70) -> 6: ok, "
        f"max_abs_err={err:.3e}")


def phase_main_path(torch, np, pt, ms, sb, stencil):
    """Price every Fig. 7 tile's bundle under 262,144 scenarios on the card
    and hold the result against the torch and numpy backends."""
    t0 = time.perf_counter()
    grid = pt.ParamGrid.sample(pt.ModelParams.multinode(), S_MAIN, seed=0,
                               cxl_lat_ns=(250, 700),
                               cxl_atomic_lat_ns=(300, 800))
    log(f"main: ParamGrid.sample({S_MAIN}) {time.perf_counter() - t0:.3f} s")
    rows = np.sort(np.random.default_rng(1).choice(S_MAIN, S_HOST,
                                                   replace=False))
    host_grid = grid.subset(rows)
    launches = {"fused_bracket_segsum": 0, "segment_sum": 0}
    bundles = {}
    for tile in TILES:
        bundle = ms.collect(stencil.build_spec(stencil.StencilConfig(
            tile, grid=(8, 8), ranks_per_socket=6)),
            network=ms.NetworkParams.multinode(), seed=0)
        cb = pt.compile_bundle(bundle)
        bundles[tile] = (bundle, cb)

        sb.fused_bracket_segsum.launches = 0
        sb.segment_sum.launches = 0
        t0 = time.perf_counter()
        res = pt.price(cb, grid)                 # the default plan
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_fused = sb.fused_bracket_segsum.launches
        assert n_fused > 0, f"tile {tile}: the fused kernel never launched"
        launches["fused_bracket_segsum"] += n_fused
        launches["segment_sum"] += sb.segment_sum.launches

        for f in pt.MATRIX_FIELDS:
            m = getattr(res, f)
            assert m.shape == (S_MAIN, cb.n_calls) and np.isfinite(m).all(), f
        sp = res.predicted_speedup()
        assert np.isfinite(sp).all() and (sp > 0).all()

        unf = pt.price(cb, grid, plan=pt.ExecPlan("torch"))
        worst_t = 0.0
        for f in pt.MATRIX_FIELDS:
            a, b = getattr(res, f), getattr(unf, f)
            np.testing.assert_allclose(a, b, rtol=RTOL_PATH, atol=0,
                                       err_msg=f"torch {f}")
            worst_t = max(worst_t, rel_diff(np, a, b))
        host = pt.price(cb, host_grid, plan="numpy")
        worst_h = 0.0
        for f in pt.MATRIX_FIELDS:
            a, b = getattr(res, f)[rows], getattr(host, f)
            np.testing.assert_allclose(a, b, rtol=RTOL_PATH, atol=0,
                                       err_msg=f"numpy {f}")
            worst_h = max(worst_h, rel_diff(np, a, b))
        np.testing.assert_allclose(sp[rows], host.predicted_speedup(),
                                   rtol=RTOL_PATH, atol=0)
        chunked = pt.price(cb, grid, plan=pt.ExecPlan(
            "fused", chunk_scenarios=CHUNK))
        for f in pt.MATRIX_FIELDS:
            assert np.array_equal(getattr(chunked, f), getattr(res, f)), f
        for i in rows[:3]:
            run = pt.predict_run(bundle, grid.params[i])
            for cid, call in res.scenario_calls(int(i)).items():
                np.testing.assert_allclose(call.t_access_cxl_ns,
                                           run.calls[cid].t_access_cxl_ns,
                                           rtol=RTOL_PATH)
        log(f"main: tile {tile}: {cb.n_calls} sites, samples hit/lfb/miss "
            f"{len(cb.hit_lat)}/{len(cb.lfb_lat)}/{len(cb.miss_lat)}; "
            f"price() {dt:.3f} s, fused launches {n_fused}; speedup "
            f"min/median/max {sp.min():.6f}/{np.median(sp):.6f}/"
            f"{sp.max():.6f}; max rel diff vs torch {worst_t:.3e}, vs numpy "
            f"({S_HOST} rows) {worst_h:.3e}; chunk={CHUNK} bit-identical")
    return grid, bundles, launches


def phase_times(torch, np, pt, sb, grid, bundles, card):
    """Kernel, plain-version and library times at the main path's shapes,
    and the split of one price() call."""
    from repro_torch.core import sweep as sweep_mod
    from repro_torch.core.sweep_kernel import price_grid_fused

    dev = torch.device(DEVICE)
    tile = TILES[-1]
    bundle, cb = bundles[tile]
    view = sweep_mod._scenario_view(grid).to(dev)
    delta = view.cxl_lat_ns - view.mem_lat_ns
    cxl = view.cxl_lat_ns
    t = cb.tensors(dev)
    g = t.groups
    S, C = len(grid), cb.n_calls
    nh, nl, nm = len(cb.hit_lat), len(cb.lfb_lat), len(cb.miss_lat)

    # kernel 1 at the main path's shape, against its plain version
    fused = lambda: sb.fused_bracket_segsum(g["hit"], g["lfb"], g["miss"],
                                            delta, cxl, C)
    plain = lambda: sb.bracket_segsum_ref(
        *[(gg.lat, gg.w, gg.seg) for gg in (g["hit"], g["lfb"], g["miss"])],
        delta, cxl, C)
    err1 = max_abs_err(fused(), plain(), TOL["f64"])
    k1_ms = cuda_ms(torch, fused)
    k1_plain = cuda_ms(torch, plain)
    k1_bytes = 16 * (nh + nl + nm) + 3 * 4 * (C + 1) + 16 * S + 4 * 8 * S * C
    k1_ops = S * (4 * nh + 8 * nl + 4 * nm + 1)
    k1_bound = max(k1_bytes / HBM_BYTES_S, k1_ops / FP64_OPS_S) * 1e3
    k1_by = "bytes" if k1_bytes / HBM_BYTES_S >= k1_ops / FP64_OPS_S \
        else "operations"

    # kernel 2 where the unfused sweep would call it: the (S, n_hit) terms
    x = (t.hit_w * torch.maximum(t.hit_lat + delta, delta.new_zeros(())))
    seg = t.hit_seg
    k2 = lambda: sb.segment_sum(x, seg, C)
    plain2 = lambda: sb.segment_sum_ref(x, seg, C)
    out_lib = torch.zeros((S, C), dtype=x.dtype, device=dev)
    lib2 = lambda: out_lib.index_add_(1, seg, x)
    err2 = max_abs_err({"x": k2()}, {"x": plain2()}, TOL["segsum"])
    k2_ms = cuda_ms(torch, k2)
    k2_plain = cuda_ms(torch, plain2)
    k2_lib = cuda_ms(torch, lib2)
    k2_bytes = 8 * S * nh + 8 * nh + 8 * S * C
    k2_ops = S * nh
    k2_bound = max(k2_bytes / HBM_BYTES_S, k2_ops / FP64_OPS_S) * 1e3
    k2_by = "bytes" if k2_bytes / HBM_BYTES_S >= k2_ops / FP64_OPS_S \
        else "operations"

    log(f"time [{card}]: fused_bracket_segsum S={S} n_seg={C} "
        f"n={nh}/{nl}/{nm}: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms, "
        f"bound {k1_bound:.4f} ms ({k1_by})")
    log(f"time [{card}]: segment_sum ({S}, {nh}) -> {C}: kernel "
        f"{k2_ms:.4f} ms, plain {k2_plain:.4f} ms, index_add_ "
        f"{k2_lib:.4f} ms, bound {k2_bound:.4f} ms ({k2_by})")

    # one price() call, split into its layers
    host_view_s, hview = wall_s(torch, lambda: sweep_mod._scenario_view(grid),
                                3)
    h2d_s, dview = wall_s(torch, lambda: hview.to(dev), 5)
    dev_ms = cuda_ms(torch, lambda: price_grid_fused(cb, dview), reps=10)
    mats = price_grid_fused(cb, dview)
    d2h_s, _ = wall_s(torch, lambda: sweep_mod._finalize(mats, S, C), 5)
    total_s, _ = wall_s(torch, lambda: pt.price(cb, grid), 3)
    log(f"time [{card}]: price() tile {tile} S={S}: total {total_s:.4f} s = "
        f"{S / total_s:.1f} scenarios/s; host view {host_view_s:.4f} s, "
        f"H2D {h2d_s * 1e3:.3f} ms, device pricing {dev_ms:.4f} ms (kernel "
        f"{k1_ms:.4f} ms), D2H {d2h_s * 1e3:.3f} ms")
    phase_price_split(torch, pt, sweep_mod, price_grid_fused, grid, cb, card)
    return [
        dict(name="fused_bracket_segsum", route="cuda",
             source="src/repro_torch/kernels/sweep_bracket/csrc/sweep_bracket.cu",
             replaces="src/repro/kernels/sweep_bracket/sweep_bracket.py:68",
             launches=None, max_abs_err=err1, ms=k1_ms, plain_ms=k1_plain,
             bound_ms=k1_bound, bound_by=k1_by, library_ms=None),
        dict(name="segment_sum", route="cuda",
             source="src/repro_torch/kernels/sweep_bracket/csrc/sweep_bracket.cu",
             replaces="src/repro/kernels/sweep_bracket/sweep_bracket.py:151",
             launches=None, max_abs_err=err2, ms=k2_ms, plain_ms=k2_plain,
             bound_ms=k2_bound, bound_by=k2_by, library_ms=k2_lib),
    ]


def phase_price_split(torch, pt, sweep_mod, price_grid_fused, grid, cb,
                      card):
    """One price() call taken apart in sequence, so that its stages add up
    to the staged total, and one profiler trace of a whole price() call for
    the card's busy time (kernels and copies) against the call's wall time."""
    dev = torch.device(DEVICE)
    S, C = len(grid), cb.n_calls
    stages = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    for _ in range(2):                     # the second pass is the one kept
        stages.clear()
        v = stage("host view", lambda: sweep_mod._scenario_view(grid))
        dv = stage("H2D", lambda: v.to(dev))
        mats = stage("device pricing", lambda: price_grid_fused(cb, dv))
        host = stage("D2H", lambda: sweep_mod._finalize(mats, S, C))
        stage("result", lambda: pt.SweepResult(grid=grid, compiled=cb, **host))
    staged = sum(stages.values())
    total_s, _ = wall_s(torch, lambda: pt.price(cb, grid), 1)
    log(f"time [{card}]: price() staged: " + ", ".join(
        f"{k} {s * 1e3:.3f} ms ({100 * s / staged:.1f}%)"
        for k, s in stages.items())
        + f"; staged sum {staged * 1e3:.3f} ms, price() right after "
        f"{total_s * 1e3:.3f} ms")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pt.price(cb, grid)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    cuda_type = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof.events()
                  if getattr(e, "device_type", None) == cuda_type]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    if dev_events:
        log(f"time [{card}]: price() traced (torch.profiler): wall "
            f"{traced_s * 1e3:.3f} ms, {len(dev_events)} device events "
            f"(kernels and copies) busy {busy_us / 1e3:.3f} ms = "
            f"{100 * busy_us / 1e3 / (traced_s * 1e3):.2f}% of the call; "
            f"idle {100 - 100 * busy_us / 1e3 / (traced_s * 1e3):.2f}%")
    else:
        log(f"time [{card}]: price() traced (torch.profiler): wall "
            f"{traced_s * 1e3:.3f} ms; the trace holds no device events, "
            f"so the card's busy share is not measured")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    import repro_torch.core as pt
    import repro_torch.memsim as ms
    from repro_torch.apps import stencil
    from repro_torch.kernels import sweep_bracket as sb
    from repro_torch.kernels.sweep_bracket import sweep_bracket as build_mod

    # 2. build
    t0 = time.perf_counter()
    lib = build_mod.build()
    log(f"build: {lib.path.name} in {time.perf_counter() - t0:.2f} s")
    if lib.report:
        log("\n".join("build: " + ln for ln in lib.report.strip().splitlines()
                      if ln.strip()))

    # 3. kernels against their plain versions
    phase_kernels(torch, np, sb)

    # 4. main path
    grid, bundles, launches = phase_main_path(torch, np, pt, ms, sb, stencil)

    # 5. times
    kernels = phase_times(torch, np, pt, sb, grid, bundles, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # 6. result lines
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
