"""The program's spans (``repro_torch.spans``) and exchange counters
(``repro_torch.comm.counters``) on the CPU, at small sizes.

* Off by default: a profiler window over a heat step and an HPCG solve
  holds no event named by a span.
* Under ``spans.recording()`` the spans appear with their names and
  nesting, one ``hpcg.apply_a`` for each application of the operator that
  ``perfbench.counts.hpcg_applies_per_set`` counts, level by level.
* Outputs are bit-identical with the spans on and off, for both apps and
  both backends.
* The counters give the exact calls and bytes of both backends of both
  exchanges; HPCG's message-free exchange on the CPU (the kernel wrapper's
  CPU branch) counts once; a call on fake tensors counts nothing.
"""
import pathlib
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.analysis.lint import lint_paths
from repro_torch.apps.hpcg import torch_impl as hpcg
from repro_torch.apps.stencil import torch_impl as stencil
from repro_torch.comm import counters, grid_mesh, message_based, message_free
from repro_torch.kernels.halo_exchange import ops as halo_ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from perfbench import counts  # noqa: E402

BACKENDS = ("message_based", "message_free")
RANKS, SIDE, ITERS = 4, 16, 3
HPCG_SPANS = {"hpcg.solve", "hpcg.apply_a", "hpcg.exchange", "hpcg.pdot"} \
    | {f"hpcg.v_cycle.L{i}" for i in range(hpcg.N_LEVELS)}
HEAT_SPANS = {"heat.step", "heat.exchange", "heat.update"}


def _hpcg(backend):
    b = torch.randn((RANKS * SIDE, SIDE, SIDE), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(7))
    solve = hpcg.make_cg(grid_mesh(RANKS, device="cpu"), backend,
                         n_iter=ITERS)
    return lambda: solve(b, torch.zeros_like(b))


def _heat(backend, steps=3):
    g = torch.Generator().manual_seed(3)
    tiles = torch.rand((2, 3, 8, 8), generator=g)
    step = stencil.make_step(grid_mesh(2, 3, device="cpu"), backend)

    def run():
        t = tiles
        for _ in range(steps):
            t = step(t)
        return t
    return run


def _events(fn, record: bool):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if record:
            with spans.recording():
                out = fn()
        else:
            out = fn()
    return out, list(prof.events())


@pytest.mark.parametrize("app", ["hpcg", "heat"])
def test_spans_are_off_by_default(app):
    assert not spans.is_recording()
    fn = _hpcg("message_free") if app == "hpcg" else _heat("message_free")
    _, events = _events(fn, record=False)
    assert events
    assert not {e.name for e in events} & (HPCG_SPANS | HEAT_SPANS)
    assert spans.span("hpcg.solve") is spans.span("heat.step")


def test_recording_is_off_again_after_its_block():
    with pytest.raises(RuntimeError):
        with spans.recording():
            assert spans.is_recording()
            raise RuntimeError
    assert not spans.is_recording()


def _parent(e):
    p = e.cpu_parent
    return None if p is None else p.name


@pytest.mark.parametrize("backend", BACKENDS)
def test_hpcg_spans_nest_and_count_every_apply_a(backend):
    _, events = _events(_hpcg(backend), record=True)
    mine = [e for e in events if e.name in HPCG_SPANS]
    assert {e.name for e in mine} == HPCG_SPANS
    solves = [e for e in mine if e.name == "hpcg.solve"]
    assert len(solves) == 1 and _parent(solves[0]) is None
    levels = counts.hpcg_slabs((SIDE,) * 3, hpcg.N_LEVELS)
    per_level = [0] * len(levels)
    for e in mine:
        parent = _parent(e)
        if e.name == "hpcg.exchange":
            assert parent == "hpcg.apply_a"
        elif e.name == "hpcg.pdot":
            assert parent == "hpcg.solve"
        elif e.name.startswith("hpcg.v_cycle.L"):
            level = int(e.name.rsplit("L", 1)[1])
            assert parent == ("hpcg.solve" if level == 0
                              else f"hpcg.v_cycle.L{level - 1}")
        elif e.name == "hpcg.apply_a":
            level = 0 if parent == "hpcg.solve" \
                else int(parent.rsplit("L", 1)[1])
            per_level[level] += 1
    assert per_level == counts.hpcg_applies_per_set(ITERS, len(levels))
    assert sum(e.name == "hpcg.pdot" for e in mine) == 2 * ITERS + 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_heat_spans_nest(backend):
    _, events = _events(_heat(backend, steps=2), record=True)
    mine = [e for e in events if e.name in HEAT_SPANS]
    assert sorted(e.name for e in mine) == sorted(
        ["heat.step", "heat.exchange", "heat.update"] * 2)
    for e in mine:
        assert _parent(e) == (None if e.name == "heat.step"
                              else "heat.step")


@pytest.mark.parametrize("app", ["hpcg", "heat"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_outputs_are_bit_identical_with_spans_on_and_off(app, backend):
    fn = _hpcg(backend) if app == "hpcg" else _heat(backend)
    off = fn()
    with spans.recording():
        on = fn()
    off, on = (off, on) if app == "hpcg" else ((off,), (on,))
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def _strip_bytes(t):
    px, py, h, w = t.shape
    return px * py * (2 * w + 2 * h) * t.element_size()


def _plane_bytes(b):
    n, _, ny, nx = b.shape
    return 2 * n * ny * nx * b.element_size()


@pytest.mark.parametrize("fn,backend", [
    (message_based.exchange_halos_2d, "message_based"),
    (message_free.exchange_halos_2d, "message_free")])
def test_halos_2d_counted_exactly(fn, backend):
    tiles = torch.rand((3, 2, 5, 7))
    before = counters.snapshot()
    fn(tiles)
    fn(tiles)
    assert counters.since(before) == {
        ("halos_2d", backend): (2, 2 * _strip_bytes(tiles))}


@pytest.mark.parametrize("fn,backend", [
    (message_based.exchange_planes_1d, "message_based"),
    (message_free.exchange_planes_1d, "message_free"),
    (halo_ops.exchange_planes_1d, "message_free")])
def test_planes_1d_counted_once(fn, backend):
    blocks = torch.rand((4, 3, 5, 6), dtype=torch.float64)
    before = counters.snapshot()
    fn(blocks)
    assert counters.since(before) == {
        ("planes_1d", backend): (1, _plane_bytes(blocks))}


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_solve_and_a_step_count_every_exchange(backend):
    levels = counts.hpcg_slabs((SIDE,) * 3, hpcg.N_LEVELS)
    applies = counts.hpcg_applies_per_set(ITERS, len(levels))
    before = counters.snapshot()
    _hpcg(backend)()
    assert counters.since(before) == {("planes_1d", backend): (
        sum(applies),
        sum(c * 2 * RANKS * s[1] * s[2] * 8 for c, s in zip(applies,
                                                             levels)))}
    before = counters.snapshot()
    _heat(backend, steps=3)()
    assert counters.since(before) == {
        ("halos_2d", backend): (3, 3 * 2 * 3 * (2 * 8 + 2 * 8) * 4)}


def test_fake_tensors_count_nothing():
    before = counters.snapshot()
    with FakeTensorMode():
        tiles = torch.empty((2, 2, 4, 4))
        message_free.exchange_halos_2d(tiles)
        message_based.exchange_planes_1d(torch.empty((2, 3, 4, 4)))
    assert counters.since(before) == {}


def test_new_modules_lint_clean():
    port = ROOT / "src" / "repro_torch"
    assert lint_paths([port / "spans.py", port / "comm" / "counters.py"]) \
        == []
