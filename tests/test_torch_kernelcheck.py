"""The port's launch-geometry checker (``repro_torch.analysis.kernelcheck``)
and the wrappers' guards, beside the JAX package's kernelcheck
(``tests/test_kernelcheck.py``).

Every registered case passes; seeded shapes the card refuses (shared
memory over 227 KB, a cluster of 16, grid y above 65,535, a cooperative
grid larger than the card holds, a misaligned TMA stride) fail with
error-severity checks; float64 is a warning.  On the reference's cases
and its seeded bad shapes, the port's shape-contract verdict equals the
reference's.  The reference's VMEM budget and Mosaic tile-legality tests
have no counterpart: the shared-memory limit and the TMA rules take their
place.  The guards raise before a launch the card would refuse; they are
exercised on fake CUDA tensors, which need no card.
"""
import dataclasses
import json

import pytest
import torch

from repro.analysis import kernelcheck as ref_kc
from repro_torch.analysis import kernelcheck as kc
from repro_torch.core import graph
from repro_torch.kernels import _plan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.halo_exchange import ops as hx_ops
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.sweep_bracket import ops as sb_ops

ALL_KERNELS = {"sweep_bracket", "segment_sum", "flash_attention",
               "mamba_scan", "halo_exchange", "stencil27", "mamba2_state"}


def errors(rep) -> set:
    return {c.name for c in rep.errors}


def test_every_registered_case_passes():
    reports = kc.check_kernels()
    assert {r.kernel for r in reports} == ALL_KERNELS
    for r in reports:
        assert r.ok, (r.kernel, r.case, [(c.name, c.detail)
                                         for c in r.errors])
        assert r.plan.threads >= 32 and min(r.plan.grid) >= 1


def test_main_path_shapes_are_registered():
    shapes = {(r.kernel, r.case) for r in kc.check_kernels()}
    assert ("flash_attention",
            "B=2,S=4096,Hq=32,Hkv=8,T=4096,D=128,dtype=bfloat16") in shapes
    assert ("mamba_scan", "B=2,L=4096,d=8192,N=16,dtype=float32") in shapes
    assert any(k == "sweep_bracket" and c.startswith("S=262144")
               for k, c in shapes)
    assert {c for k, c in shapes if k == "halo_exchange"} >= {
        f"n=8,plane=({s}, {s}),dtype=float32" for s in (256, 128, 64, 32)}


@pytest.mark.parametrize("name", sorted(set(ref_kc.known_kernels())))
def test_shape_contract_verdict_matches_the_reference(name):
    budget = ref_kc.VMEM_BUDGET_BYTES
    checker = {"sweep_bracket": kc.check_sweep_bracket,
               "flash_attention": kc.check_flash_attention,
               "mamba_scan": kc.check_mamba_scan,
               "halo_exchange": None}[name]
    if checker is None:                        # planes, not ranks: no contract
        assert {r.ok for r in ref_kc.check_kernels([name])} == {True}
        return
    for case in ref_kc._CASES[name]:
        ref = ref_kc._CHECKERS[name](dict(case), budget)
        assert checker(dict(case)).contract_ok == ref.ok, case


@pytest.mark.parametrize("case,what", [
    ({"B": 1, "S": 250, "Hq": 8, "Hkv": 8, "T": 512, "D": 128,
      "dtype": "float32"}, "query axis divisible"),
    ({"B": 1, "S": 512, "Hq": 10, "Hkv": 4, "T": 512, "D": 128,
      "dtype": "float32"}, "GQA head mapping"),
    ({"B": 1, "L": 256, "d": 300, "N": 16, "dtype": "float32"},
     "channel axis divisible"),
])
def test_seeded_bad_shapes_fail_as_in_the_reference(case, what):
    budget = ref_kc.VMEM_BUDGET_BYTES
    if "L" in case:
        port, ref = kc.check_mamba_scan(case), ref_kc.check_mamba_scan(
            case, budget)
    else:
        port, ref = kc.check_flash_attention(case), \
            ref_kc.check_flash_attention(case, budget)
    assert not ref.ok and not port.contract_ok and not port.ok
    assert what in errors(port)


def _plan_of(**kw):
    base = dict(kernel="k", grid=(4, 1, 1), block=(128, 1, 1))
    base.update(kw)
    return _plan.LaunchPlan(**base)


def test_smem_over_227_kb_fails():
    rep = kc.report("k", {}, _plan_of(smem=232_449))
    assert errors(rep) == {"shared memory within 227 KB"}
    rep = kc.report("k", {}, _plan_of(smem=200_000, static_smem=40_000))
    assert errors(rep) == {"shared memory within 227 KB"}


def test_cluster_of_16_fails():
    rep = kc.report("k", {}, _plan_of(grid=(32, 1, 1), cluster=(16, 1, 1)))
    assert errors(rep) == {"cluster within 8"}


def test_grid_y_above_65535_fails():
    rep = kc.check_flash_attention({"B": 4096, "S": 64, "Hq": 16,
                                    "Hkv": 16, "T": 64, "D": 32,
                                    "dtype": "float32"})
    assert rep.plan.kernel == "attn_kernel" and rep.plan.grid[1] == 65536
    assert errors(rep) == {"grid y within 65535"}
    rep = kc.check_segment_sum({"rows": 8, "n": 70_000, "n_seg": 70_000,
                                "dtype": "float32"})
    assert errors(rep) == {"grid y within 65535"}


def test_threads_come_in_warps_and_warpgroups():
    assert errors(kc.report("k", {}, _plan_of(block=(96, 1, 1)))) == set()
    assert errors(kc.report("k", {}, _plan_of(block=(100, 1, 1)))) == {
        "threads a multiple of 32"}
    assert errors(kc.report("k", {}, _plan_of(block=(1056, 1, 1)))) == {
        "threads per block within 1024"}
    assert errors(kc.report("k", {}, _plan_of(block=(320, 1, 1),
                                              thread_quantum=128))) == {
        "threads a multiple of 128"}


def test_cooperative_grid_must_be_co_resident():
    rep = kc.check_halo_exchange({"n": 3, "plane": (129, 127),
                                  "dtype": "float32", "route": "flags",
                                  "max_ctas": 64})
    assert rep.ok and rep.plan.ctas == 63        # capped at 21 chunks a rank
    plan = dataclasses.replace(rep.plan, grid=(66, 1, 1))
    assert errors(kc.report("halo_exchange", {}, plan, co_resident=64)) \
        == {"cooperative grid co-resident"}
    rep = kc.check_halo_exchange({"n": 64, "plane": (33, 31),
                                  "dtype": "float64", "max_ctas": 32})
    assert errors(rep) == {"ranks co-resident"}


def test_cluster_route_refuses_a_ring_above_8():
    rep = kc.check_halo_exchange({"n": 9, "plane": (1, 256),
                                  "dtype": "float32", "route": "cluster"})
    assert "route takes the ring" in errors(rep)


def test_tma_maps_are_checked():
    plan = fa_ops.plan(2, 4096, 4096, 32, 8, 128, "sm90")
    assert {m.name for m in plan.tma} == {"q", "k", "v"}
    assert all(m.box == (64, 1, m.box[2], 1) for m in plan.tma)
    bad = dataclasses.replace(plan, tma=(dataclasses.replace(
        plan.tma[0], strides=(2 * 100, 2 * 100 * 32, 2 * 100 * 32 * 4096)),
        dataclasses.replace(plan.tma[1], box=(64, 1, 512, 1))))
    assert errors(kc.report("flash_attention", {}, bad)) == {
        "TMA q strides 16-byte aligned", "TMA k box within 256"}
    # the scan's x and dt rows are d floats: d a multiple of 4
    assert errors(kc.report("mamba_scan", {}, ms_ops.plan(1, 64, 6))) == {
        "TMA x strides 16-byte aligned", "TMA dt strides 16-byte aligned"}


def test_f64_is_warning_not_error():
    rep = kc.check_sweep_bracket({"S": 64, "n_max": 640, "n_seg": 12,
                                  "dtype": "float64"})
    assert rep.ok and [c.name for c in rep.warnings] == ["float64 operands"]


def test_bracket_plan_takes_the_cards_sms_and_occupancy():
    case = {"S": 262_144, "n_max": 192, "n_seg": 4, "dtype": "float64"}
    assert sb_ops.case_plan(dict(case, occ=1)).grid == (132, 1, 1)
    assert sb_ops.case_plan(dict(case, occ=3, sms=100)).grid == (300, 1, 1)
    assert sb_ops.case_plan(case).grid == (512, 1, 1)     # every tile
    tiled = sb_ops.case_plan({"S": 4096, "n_max": 8192, "n_seg": 257,
                              "dtype": "float32"})
    assert dict((n, b) for n, b, _ in tiled.buffers)["window"] == 512 * 8


def test_flash_routes_plan_their_kernels():
    sm90 = fa_ops.case_plan({"B": 2, "S": 4096, "Hq": 32, "Hkv": 8,
                             "T": 4096, "D": 128, "dtype": "bfloat16"})
    simt = fa_ops.case_plan({"B": 2, "S": 4096, "Hq": 32, "Hkv": 8,
                             "T": 4096, "D": 128, "dtype": "float32"})
    assert (sm90.kernel, sm90.grid, sm90.threads, sm90.smem) == (
        "attn_sm90_kernel", (64, 32, 1), 384, 230_504)
    assert (simt.kernel, simt.grid, simt.threads, simt.smem) == (
        "attn_kernel", (64, 64, 1), 256, 116_736)


def test_registry_rejects_duplicate_and_unknown():
    with pytest.raises(ValueError, match="already registered"):
        @kc.register_kernel_checker("flash_attention", ())
        def dup(case):                             # pragma: no cover
            return None
    with pytest.raises(ValueError, match="unknown kernel"):
        kc.check_kernels(["nonexistent"])


def test_register_new_checker_roundtrip():
    @kc.register_kernel_checker("tmp_kernel", ({"n": 8},))
    def tmp(case):
        return kc.report("tmp_kernel", case, _plan_of())
    try:
        (rep,) = kc.check_kernels(["tmp_kernel"])
        assert rep.ok and rep.case == "n=8"
        assert kc.dataflow_module("tmp_kernel") is None
    finally:
        for reg in (kc._CHECKERS, kc._CASES, kc._DATAFLOW):
            reg.pop("tmp_kernel", None)


def test_cli_json_format(capsys):
    assert kc.main(["--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert set(payload) == {"tool", "n_errors", "n_warnings", "reports"}
    assert payload["tool"] == "repro_torch.analysis.kernelcheck"
    assert payload["n_errors"] == 0 and payload["n_warnings"] >= 1
    assert {r["kernel"] for r in payload["reports"]} == ALL_KERNELS
    assert set(payload["reports"][0]["plan"]) >= {"grid", "block", "smem"}


def test_cli_exit_codes(capsys):
    assert kc.main([]) == 0
    assert kc.main(["--kernel", "nonexistent"]) == 2
    assert kc.main(["--kernel", "mamba_scan", "--verbose"]) == 0
    assert "[ok ] grid y within 65535" in capsys.readouterr().out


# ------------------------------------------------------------- guards

def _fake(shape, dtype=torch.float32):
    return graph.abstract(torch.zeros, shape, dtype=dtype, device="cuda")


def test_flash_guard_refuses_batch_heads_above_grid_y():
    q = _fake((4096, 64, 16, 32))
    with pytest.raises(ValueError, match="grid y within 65535"):
        graph.abstract(flash_attention, q, q, q)
    q = _fake((2, 64, 16, 32))
    assert graph.abstract(flash_attention, q, q, q).shape == q.shape


def test_flash_guard_refuses_q_blocks_above_grid_y():
    q = _fake((1, 128 * 65536, 1, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="attn_sm90_kernel.*grid y"):
        graph.abstract(flash_attention, q, q, q, block_q=128 * 65536,
                       block_k=128 * 65536)


def test_scan_guard_refuses_batch_above_grid_y():
    B, L, d = 65536, 1, 4
    x, B_ = _fake((B, L, d)), _fake((B, L, 16))
    A, D = _fake((d, 16)), _fake((d,))
    with pytest.raises(ValueError, match="scan_kernel.*grid y"):
        graph.abstract(mamba_scan, x, x, B_, B_, A, D)
    x, B_ = _fake((2, L, d)), _fake((2, L, 16))
    y, h = graph.abstract(mamba_scan, x, x, B_, B_, A, D)
    assert y.shape == (2, L, d) and h.shape == (2, d, 16)


def _grid_ok(p):
    return all(ok for name, ok, _ in _plan.limits(p) if name.startswith("grid"))


@pytest.mark.parametrize("edge", [65535, 65536])
def test_guards_agree_with_the_plans_limits(edge):
    """The wrappers' grid guard refuses exactly the plans whose grid
    :func:`_plan.limits` fails, on both sides of grid y's limit."""
    cases = [(fa_ops.plan(1, 128 * edge, 64, 1, 1, 64, "sm90"),
              fa_ops.grid(1, 128 * edge, 1, "sm90")),
             (fa_ops.plan(edge, 64, 64, 1, 1, 64, "simt"),
              fa_ops.grid(edge, 64, 1, "simt")),
             (ms_ops.plan(edge, 4, 8), ms_ops.grid(edge, 8))]
    for p, g in cases:
        assert p.grid == g
        try:
            _plan.refuse_grid(p.kernel, g)
            refused = False
        except ValueError as e:
            assert p.kernel in str(e) and "grid y within 65535" in str(e)
            refused = True
        assert refused == (not _grid_ok(p)) == (edge > 65535), p


def test_halo_plan_mirrors_chunk_count():
    p = hx_ops.plan(8, 256 * 256 * 4 // 16, "cluster", 132)
    assert p.grid == (8 * 16, 1, 1) and p.cluster == (8, 1, 1)
    assert not p.cooperative and p.static_smem == 16
    p = hx_ops.plan(64, 1023, "flags", 132, 1056)
    assert p.grid == (128, 1, 1) and p.cooperative and p.cluster == (1, 1, 1)
