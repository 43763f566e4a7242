"""HPCG's 27-point operator kernel (``repro_torch.kernels.stencil27``): the
CPU path (the port's old path: the ``cat``, the pad and ``apply_a_padded``)
against the single-program oracle rank by rank, bit for bit, the wrapper's
argument checks, the launch plan and its dataflow at HPCG's four level
shapes, the capture's one node a call, and — on a CUDA device only — the
kernel against its plain version bit for bit and its launches in a solve.

The kernel keeps the plain version's order of operations (27 c rounded,
then 27 rounded subtractions), so every comparison is exact equality.
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch.analysis import dataflow as dfl
from repro_torch.analysis import kernelcheck as kc
from repro_torch.apps.hpcg import torch_impl as hpcg
from repro_torch.comm import grid_mesh
from repro_torch.core.graph import abstract, capture
from repro_torch.kernels import _plan
from repro_torch.kernels.stencil27 import apply_27pt, apply_27pt_ref, ops

#: The cell's four multigrid levels, a rank's slab at each.
LEVELS = [(256, 256, 256), (128, 128, 128), (64, 64, 64), (32, 32, 32)]
#: Ragged slabs: tiles cut at the y and x edges, one z-run and several.
RAGGED = [(5, 7, 9), (2, 3, 33), (19, 40, 70)]
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    """The CUDA device; decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, slab, dtype, device="cpu", seed=0, ghosts="random"):
    g = torch.Generator(device=device).manual_seed(seed)
    blocks = torch.randn((n, *slab), generator=g, dtype=dtype, device=device)
    planes = torch.randn((2, n, 1, *slab[1:]), generator=g, dtype=dtype,
                         device=device)
    if ghosts == "zero":
        planes.zero_()
    return blocks, planes[0], planes[1]


def _by_oracle(blocks, below, above):
    """Each rank's slab between its ghost planes through the
    single-program oracle ``reference_apply_a``, which pads z with zeros
    too: its planes 1..nz read only the slab and the two ghost planes."""
    return torch.stack([
        hpcg.reference_apply_a(torch.cat([lo, b, hi]))[1:-1]
        for b, lo, hi in zip(blocks, below, above)])


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("slab", RAGGED[:2] + [(8, 16, 16)])
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_is_the_old_path(dtype, n, slab):
    blocks, below, above = _inputs(n, slab, dtype, seed=n)
    before = apply_27pt.launches
    got = apply_27pt(blocks, below, above)
    assert got.shape == blocks.shape and got.dtype == dtype
    assert torch.equal(got, _by_oracle(blocks, below, above))
    assert torch.equal(got, apply_27pt_ref(blocks, below, above))
    assert apply_27pt.launches == before


@pytest.mark.parametrize("bad,match", [
    (lambda b, lo, hi: (b.to(torch.int64), lo.to(torch.int64),
                        hi.to(torch.int64)), "float32/float64"),
    (lambda b, lo, hi: (b, lo[:, :, :-1], hi), r"below \(n, 1, ny, nx\)"),
    (lambda b, lo, hi: (b, lo, hi[:2]), r"above \(n, 1, ny, nx\)"),
    (lambda b, lo, hi: (b.transpose(2, 3).contiguous().transpose(2, 3), lo,
                        hi), "blocks must be contiguous"),
    (lambda b, lo, hi: (b, lo.to(torch.float32), hi),
     "share blocks' dtype"),
    (lambda b, lo, hi: (b[0], lo, hi), r"want blocks \(n, nz, ny, nx\)"),
])
def test_argument_checks_raise(bad, match):
    blocks, below, above = _inputs(3, (4, 5, 5), torch.float64)
    with pytest.raises(ValueError, match=match):
        apply_27pt(*bad(blocks, below, above))


def test_no_plain_version_off_the_cpu():
    meta = torch.empty(2, 3, 4, 5, device="meta")
    ghost = torch.empty(2, 1, 4, 5, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        apply_27pt(meta, ghost, ghost)


@pytest.mark.parametrize("slab,grid,run", [
    ((256, 256, 256), (64, 8, 8), 32),
    ((128, 128, 128), (16, 16, 8), 8),
    ((64, 64, 64), (4, 8, 8), 8),
    ((32, 32, 32), (1, 4, 8), 8),
])
def test_plan_covers_every_tile_and_run(slab, grid, run):
    """At the cell's four levels the grid is (tiles, z-runs, ranks): every
    (rank, y-tile, x-tile, z-run) has one CTA, the runs are non-empty and
    tile z, and the launch fits the card."""
    nz, ny, nx = slab
    p = ops.plan(8, *slab)
    assert p.grid == grid and p.threads == ops.TX * ops.WARPS
    tiles_x, tiles_y, got_run, runs = ops.geometry(8, *slab)
    assert got_run == run
    assert p.grid == (tiles_x * tiles_y, runs, 8)
    assert tiles_x * ops.TX >= nx and tiles_y * ops.TY >= ny
    starts = [z * run for z in range(runs)]
    assert all(s < nz for s in starts) and runs * run >= nz
    assert not [name for name, ok, _ in _plan.limits(p) if not ok]
    if nz * ny * nx >= 128 ** 3:            # enough CTAs to fill 132 SMs
        assert p.ctas >= 2048


@pytest.mark.parametrize("n,slab", [(1, (1, 1, 1)), (3, (5, 7, 9)),
                                    (8, (2, 3, 33)), (2, (100, 1, 1)),
                                    (5, (17, 33, 31))])
def test_geometry_runs_are_non_empty(n, slab):
    tiles_x, tiles_y, run, runs = ops.geometry(n, *slab)
    assert run >= 1 and (runs - 1) * run < slab[0] <= runs * run
    assert tiles_x == -(-slab[2] // ops.TX)
    assert tiles_y == -(-slab[1] // ops.TY)


def test_registered_cases_and_dataflow():
    """kernelcheck holds the cell's four levels in both float types and two
    ragged slabs; the dataflow tier finds every element of y written by
    one CTA and none by two."""
    cases = kc.cases("stencil27")
    assert {(c["slab"], c["dtype"]) for c in cases if c["n"] == 8} >= {
        (s, d) for s in LEVELS for d in ("float64", "float32")}
    ragged = [c for c in cases if c["slab"] not in LEVELS]
    assert len(ragged) >= 2
    assert all(r.ok for r in kc.check_kernels(["stencil27"]))
    contract = dfl.dataflow_contract("stencil27")
    for case in cases:
        rep = dfl.analyze_case("stencil27", dict(case), contract)
        rules = {f.rule for f in rep.findings}
        assert not rules & {"tile-uncovered", "write-race"}, (case, rules)
        assert rep.ok, (case, [str(f) for f in rep.findings])


def test_capture_holds_one_node_a_call():
    """A captured solve records the operator as one custom-op node per
    ``apply_a`` (two ppermutes each, message-based), and launches
    nothing."""
    b = hpcg.make_problem((16, 16, 16), dtype=torch.float32, device="cpu")
    before = apply_27pt.launches
    step = capture(hpcg.make_cg(grid_mesh(4, device="cpu"), "message_based",
                                n_iter=2), b, torch.zeros_like(b))
    ops_ = collections.Counter(step.ops)
    assert ops_["repro_torch::apply_27pt"] > 0
    assert 2 * ops_["repro_torch::apply_27pt"] == ops_["repro_torch::ppermute"]
    assert apply_27pt.launches == before


# ------------------------------------------------- on the card only

@pytest.mark.cuda
@pytest.mark.parametrize("ghosts", ["random", "zero"])
@pytest.mark.parametrize("slab", LEVELS + RAGGED)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain(cuda, dtype, slab, ghosts):
    n = 8 if slab in LEVELS else 3
    blocks, below, above = _inputs(n, slab, dtype, cuda, seed=len(slab),
                                   ghosts=ghosts)
    before = apply_27pt.launches
    got = apply_27pt(blocks, below, above)
    torch.cuda.synchronize()
    assert apply_27pt.launches == before + 1
    want = apply_27pt_ref(blocks, below, above)
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["message_free", "message_based"])
def test_solve_launches_the_kernel(cuda, backend):
    """A 50-iteration solve at 4 ranks x 32^3 (four levels) launches the
    kernel once an ``apply_a``: 204 + 153 + 153 + 51 = 561, and both
    backends agree bit for bit."""
    grid = grid_mesh(4, device=cuda)
    b = hpcg.make_problem((4 * 32, 32, 32), dtype=torch.float64,
                          device=cuda)
    out = {}
    for be in ("message_free", "message_based"):
        before = apply_27pt.launches
        out[be] = hpcg.make_cg(grid, be, n_iter=50)(b, torch.zeros_like(b))
        torch.cuda.synchronize()
        if be == backend:
            assert apply_27pt.launches - before == 561
    (xf, rf), (xb, rb) = out["message_free"], out["message_based"]
    assert torch.equal(xf, xb) and torch.equal(rf, rb)
    assert float((xf - 1.0).abs().max()) < 1e-6


@pytest.mark.cuda
def test_apply_a_matches_the_oracle_on_the_card(cuda):
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(8 * 16, 24,
                                                                 40)),
                        device=cuda)
    want = hpcg.reference_apply_a(x)
    for backend in ("message_based", "message_free"):
        got = hpcg.from_slabs(hpcg.apply_a(hpcg.to_slabs(x, 8), backend))
        assert torch.equal(got, want), backend


@pytest.mark.cuda
def test_capture_on_the_card_launches_nothing(cuda):
    """A solve captured over fake CUDA tensors (the advisor's path) holds
    one ``repro_torch::apply_27pt`` node an ``apply_a`` and launches
    nothing."""
    b, x0 = (abstract(torch.zeros, (4 * 16, 16, 16), dtype=torch.float64,
                      device=cuda) for _ in range(2))
    before = apply_27pt.launches
    step = capture(hpcg.make_cg(grid_mesh(4, device=cuda), "message_based",
                                n_iter=2), b, x0)
    ops_ = collections.Counter(step.ops)
    assert ops_["repro_torch::apply_27pt"] > 0
    assert 2 * ops_["repro_torch::apply_27pt"] == ops_["repro_torch::ppermute"]
    assert apply_27pt.launches == before
