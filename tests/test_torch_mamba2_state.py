"""One Mamba-2 decode step's state update and readout
(``repro_torch.kernels.mamba2_state``): the plain version against the
lines ``models.mamba2.mamba2_decode`` ran before the kernel, bit for bit,
at a reduced granite's widths and at the published ones; the wrapper's
argument checks; the launch plan, the threads' rows and the dataflow; the
given state left unwritten; and — on a CUDA device only — the kernel
against its plain version at the benchmark cell's 256 slots and at ragged
shapes, on views as the decode passes them, and its one launch a call
under the span ``lm.mamba2.state``.

On the card the kernel and the plain version round differently in two
places, so they are held to error bounds, not to equality:

* the new state: the kernel fuses ``S da + u B`` into one fma, where the
  plain ``addcmul_`` may round ``u B`` first.  Each side is within 3
  roundings of the exact value, so the two are within ``6 u (|S da| + |u
  B|)``, ``u = 2^-24``;
* ``y``: the kernel sums the ``N`` products by an fma chain in each lane
  and a butterfly of shuffles across lanes, the plain version in its
  gemv's order.  Each order is within ``(N + 3) u`` of the exact sum
  relative to the sum of the terms' magnitudes (``sum_n (|S da| + |u B|)
  |C_n| + |D x|``), so the two are within twice that.
"""
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, spans
from repro_torch.analysis import dataflow as dfl
from repro_torch.analysis import kernelcheck as kc
from repro_torch.kernels import _plan
from repro_torch.kernels.mamba2_state import (mamba2_state_update,
                                              mamba2_state_update_ref, ops)
from repro_torch.models import blocks, make_model

#: (b, H, P, N, G): the benchmark cell (granite-4.0-h-small at 256 slots).
CELL = (256, 128, 64, 128, 1)
#: the published widths with a few slots, and the reduced test arch's.
PUBLISHED = (3, 128, 64, 128, 1)
REDUCED = (3, 8, 16, 8, 1)
#: ragged: P that no warp's rows divide, the narrowest N with a group a
#: head, a thread's rows taken in two and in ten turns, lanes of 16.
RAGGED = [(5, 6, 20, 8, 2), (2, 4, 7, 4, 4), (2, 2, 128, 128, 1),
          (2, 3, 300, 4, 1), (7, 16, 33, 64, 4)]
U = 2.0 ** -24


@pytest.fixture
def cuda():
    """The CUDA device; decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, device="cpu", seed=0, layout="views"):
    """The state and the step's inputs as ``mamba2_decode`` holds them.
    ``"views"``: ``x``, ``Bt`` and ``Ct`` split from one conv output laid
    out batch-innermost (as the CPU's einsum gives it), the state strided
    across ``b`` and ``h`` (as the chunked prefill leaves it);
    ``"packed"``: every tensor contiguous.  Returns the wrapper's seven
    arguments and the conv output's split ``(xs, Bt, Ct)``, 2-D."""
    b, H, P, N, G = shape
    g = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device)
    cd = H * P + 2 * G * N
    if layout == "views":
        conv = torch.randn((cd, b), generator=g, **f32).t()
        ssm = torch.randn((b, H, 2, P, N), generator=g, **f32)[:, :, 1]
    else:
        conv = torch.randn((b, cd), generator=g, **f32)
        ssm = torch.randn((b, H, P, N), generator=g, **f32)
    xs, Bt, Ct = conv.split([H * P, G * N, G * N], dim=-1)
    dt = F.softplus(torch.randn((b, H), generator=g, **f32) - 4.0)
    A_log = torch.log(torch.empty((H,), **f32).uniform_(1.0, 16.0,
                                                        generator=g))
    D = torch.randn((H,), generator=g, **f32)
    args = (ssm, xs.reshape(b, H, P), dt, Bt.reshape(b, G, N),
            Ct.reshape(b, G, N), A_log, D)
    return args, (xs, Bt, Ct)


def _parent(ssm, xs, dt, Bt, Ct, A_log, D, G):
    """The lines ``mamba2_decode`` ran under ``lm.mamba2.state`` before the
    kernel, as they stood (``p`` its parameters; ``xs``, ``Bt``, ``Ct`` the
    conv output's split)."""
    Bsz, H, P, N = ssm.shape
    p = {"A_log": A_log, "D": D}
    xh = xs.reshape(Bsz, G, H // G, P)
    da = torch.exp(dt * -torch.exp(p["A_log"])).reshape(Bsz, G, -1)
    u = dt.reshape(Bsz, G, -1)[..., None] * xh        # (B, G, J, P)
    S = ssm.reshape(Bsz, G, H // G, P, N) * da[..., None, None]
    S.addcmul_(u[..., None], Bt.reshape(Bsz, G, 1, 1, N))
    y = torch.einsum("bgjpn,bgn->bgjp", S, Ct.reshape(Bsz, G, N))
    y = y + xh * p["D"].reshape(G, -1)[..., None]
    return y.reshape(Bsz, H, P), S.reshape(Bsz, H, P, N)


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("layout", ["views", "packed"])
@pytest.mark.parametrize("shape", [REDUCED, PUBLISHED, RAGGED[0],
                                   RAGGED[3]])
def test_plain_version_is_the_parents_lines(shape, layout):
    args, split = _inputs(shape, seed=shape[0], layout=layout)
    want = _parent(args[0], *split[:1], args[2], *split[1:], *args[5:],
                   G=shape[4])
    before = mamba2_state_update.launches
    for fn in (mamba2_state_update_ref, mamba2_state_update):
        y, S = fn(*args)
        assert y.shape == shape[:3] and S.shape == shape[:4]
        assert torch.equal(y, want[0]) and torch.equal(S, want[1])
    assert mamba2_state_update.launches == before


def test_the_decode_runs_the_plain_version_on_the_cpu():
    """A reduced granite's decode step from a prefill's state (strided
    across ``b`` and ``h``) goes through the wrapper, launching nothing."""
    cfg = configs.get_arch("granite-4.0-h-small").reduced(n_layers=4)
    m = make_model(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        _, caches = m.prefill({"tokens": torch.arange(9)[None] % 256}, 16)
        before = mamba2_state_update.launches
        logits, new = m.decode_step(caches, {"tokens": torch.zeros(
            (1, 1), dtype=torch.long)}, torch.tensor([9]))
    assert torch.isfinite(logits).all()
    assert mamba2_state_update.launches == before
    assert any(getattr(c, "ssm", None) is not None and c.ssm.is_contiguous()
               for c in new)


@pytest.mark.parametrize("layout", ["views", "packed"])
def test_the_given_state_is_left_unwritten(layout):
    args, _ = _inputs(REDUCED, seed=4, layout=layout)
    before = args[0].clone()
    version = args[0]._version
    y, S = mamba2_state_update(*args)
    assert torch.equal(args[0], before) and args[0]._version == version
    assert S.data_ptr() != args[0].data_ptr()
    assert not torch.equal(S, before)


def _bad(name):
    """A change of one argument the wrapper must refuse."""
    def go(a):
        ssm, x, dt, Bt, Ct, A_log, D = a
        return {
            "dtype": (ssm, x.double(), dt, Bt, Ct, A_log, D),
            "x shape": (ssm, x[:, :, :-1], dt, Bt, Ct, A_log, D),
            "dt shape": (ssm, x, dt[:, :-1], Bt, Ct, A_log, D),
            "C groups": (ssm, x, dt, Bt, Ct[:, :, :-1], A_log, D),
            "state n strided": (ssm.transpose(2, 3).contiguous()
                                .transpose(2, 3), x, dt, Bt, Ct, A_log, D),
            "state rows unaligned": (torch.randn((*ssm.shape[:3], 9))
                                     [..., :8], x, dt, Bt, Ct, A_log, D),
            "A_log strided": (ssm, x, dt, Bt, Ct,
                              A_log.repeat_interleave(2)[::2], D),
            "state rank": (ssm[0], x, dt, Bt, Ct, A_log, D),
        }[name]
    return go


@pytest.mark.parametrize("name,match", [
    ("dtype", "takes float32"), ("x shape", r"want x \(3, 8, 16\)"),
    ("dt shape", r"want dt \(3, 8\)"), ("C groups", r"want Ct \(3, 1, 8\)"),
    ("state n strided", "last dimension must be packed"),
    ("state rows unaligned", "16-byte boundaries"),
    ("A_log strided", "must be contiguous"),
    ("state rank", r"want ssm \(b, H, P, N\)"),
])
def test_argument_checks_raise(name, match):
    args, _ = _inputs(REDUCED, seed=1, layout="packed")
    with pytest.raises(ValueError, match=match):
        mamba2_state_update(*_bad(name)(args))


def test_groups_must_divide_the_heads():
    args, _ = _inputs((2, 6, 16, 8, 2), seed=2, layout="packed")
    ssm, x, dt, Bt, Ct, A_log, D = args
    Bt4, Ct4 = (torch.cat([t, t], 1) for t in (Bt, Ct))
    with pytest.raises(ValueError, match="6 heads do not split into 4"):
        mamba2_state_update(ssm, x, dt, Bt4, Ct4, A_log, D)


def test_no_plain_version_off_the_cpu():
    args, _ = _inputs(REDUCED, seed=3, layout="packed")
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mamba2_state_update(*meta)


@pytest.mark.parametrize("P,N,want", [
    (64, 128, (32, 8, 8)), (16, 8, (2, 1, 1)), (20, 8, (2, 1, 2)),
    (7, 4, (1, 1, 1)), (128, 128, (32, 8, 16)), (1, 128, (32, 1, 1)),
    (33, 64, (16, 3, 6)), (256, 4, (1, 1, 8)), (300, 4, (1, 2, 5)),
    (300, 128, (32, 8, 38))])
def test_threads_cover_each_state_once(P, N, want):
    """The kernel's mapping, from ``geometry``: row ``p = (k warps + warp)
    per_warp + lane / lanes`` of pass ``k``, four states from ``(lane %
    lanes) 4``.
    Every ``(p, n)`` of a tile is one thread's, once; a row's lanes are
    one aligned group of a warp, so the readout's xor shuffles stay in
    the row."""
    lanes, warps, passes = ops.geometry(P, N)
    assert (lanes, warps, passes) == want
    assert warps <= ops.WARPS and (passes <= ops.ROWS or warps == ops.WARPS)
    per_warp = 32 // lanes
    seen = np.zeros((P, N), dtype=int)
    for warp in range(warps):
        for lane in range(32):
            assert all((lane ^ off) // lanes == lane // lanes
                       for off in range(1, lanes))
            for k in range(passes):
                p = (k * warps + warp) * per_warp + lane // lanes
                if p < P:
                    n0 = (lane % lanes) * 4
                    seen[p, n0:n0 + 4] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("P,N", [(64, 12), (64, 256), (64, 2), (64, 0)])
def test_shapes_the_kernel_does_not_take_raise(P, N):
    with pytest.raises(ValueError, match="mamba2_state takes"):
        ops.plan(2, 4, P, N)


def test_plan_at_the_cell():
    """The cell's launch: a CTA a (slot, head) tile, 32,768 of 256
    threads, 1 KB of shared memory for B and C, within the card's limits."""
    b, H, P, N, _ = CELL
    p = ops.plan(b, H, P, N)
    assert p.grid == (H, b, 1) and p.block == (256, 1, 1)
    assert p.ctas == 32768 and p.smem == 0 and p.static_smem == 1024
    assert not [name for name, ok, _ in _plan.limits(p) if not ok]
    with pytest.raises(ValueError, match="grid y within 65535"):
        _plan.refuse_grid("mamba2_state", ops.plan(70000, H, P, N).grid)


def test_registered_cases_and_dataflow():
    """kernelcheck holds the cell's shape, the reduced widths and ragged
    rows; the dataflow tier finds every element of the new state and of
    y written by one CTA and none by two."""
    cases = kc.cases("mamba2_state")
    assert {"b": 256, "H": 128, "P": 64, "N": 128} in cases
    assert {"b": 3, "H": 8, "P": 16, "N": 8} in cases
    assert all(r.ok for r in kc.check_kernels(["mamba2_state"]))
    contract = dfl.dataflow_contract("mamba2_state")
    for case in cases:
        rep = dfl.analyze_case("mamba2_state", dict(case), contract)
        assert rep.ok, (case, [str(f) for f in rep.findings])


# ------------------------------------------------- on the card only

def _bounds(args, S_new):
    """The state's and y's error bounds of the module's docstring, from
    the inputs and the plain version's new state."""
    ssm, x, dt, Bt, Ct, A_log, D = args
    b, H, P, N = ssm.shape
    G = Bt.shape[1]
    heads = torch.arange(H, device=ssm.device) // (H // G)
    da = torch.exp(dt * -torch.exp(A_log))[..., None, None]
    uB = (dt[..., None] * x)[..., None] * Bt[:, heads, None, :]
    mag = (ssm * da).abs_().add_(uB.abs_())
    del uB
    terms = torch.einsum("bhpn,bhn->bhp", mag, Ct[:, heads].abs()) \
        + (x * D[:, None]).abs()
    return mag.mul_(6 * U), terms.mul_(2 * (N + 3) * U)


def _hold(got, want, bound, what):
    excess = float(((got - want).abs() - bound).max())
    assert excess <= 0.0, f"{what}: beyond its bound by {excess:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["views", "packed"])
@pytest.mark.parametrize("shape", [CELL, REDUCED] + RAGGED)
def test_kernel_matches_plain(cuda, shape, layout):
    args, _ = _inputs(shape, cuda, seed=shape[0] + len(layout),
                      layout=layout)
    before_state = args[0].clone()
    before = mamba2_state_update.launches
    y, S = mamba2_state_update(*args)
    torch.cuda.synchronize()
    assert mamba2_state_update.launches == before + 1
    assert torch.equal(args[0], before_state)
    del before_state
    assert y.is_contiguous() and S.is_contiguous()
    y_ref, S_ref = mamba2_state_update_ref(*args)
    bound_s, bound_y = _bounds(args, S_ref)
    _hold(S, S_ref, bound_s, "state")
    del bound_s, S_ref
    _hold(y, y_ref, bound_y, "y")
    y2, S2 = mamba2_state_update(*args)
    assert torch.equal(y2, y) and torch.equal(S2, S), "not deterministic"


@pytest.mark.cuda
def test_kernel_refuses_grad_fake_and_unaligned(cuda):
    args, _ = _inputs(REDUCED, cuda, seed=5, layout="packed")
    shifted = torch.zeros(args[0].numel() + 1, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte boundaries"):
        mamba2_state_update(shifted.view(args[0].shape), *args[1:])
    with pytest.raises(RuntimeError, match="forward-only"):
        mamba2_state_update(*args[:5], args[5].requires_grad_(), args[6])
    from repro_torch.core.graph import abstract
    fake = [abstract(torch.zeros, tuple(t.shape), dtype=t.dtype,
                     device=cuda) for t in args]
    with pytest.raises(ValueError, match="no fake version"):
        mamba2_state_update(*fake)


def _kernels_under(trace: dict, span: str) -> list:
    """The names of the device kernels launched inside each ``span`` of a
    profiler trace, joined by the launch's correlation id."""
    events = trace["traceEvents"]
    kernels = {e["args"]["correlation"]: e["name"] for e in events
               if e.get("cat") == "kernel"}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e["args"].get("correlation") in kernels]
    out = []
    for s in (e for e in events if e.get("cat") == "user_annotation"
              and e["name"] == span):
        lo, hi = s["ts"], s["ts"] + s["dur"]
        out.append([kernels[e["args"]["correlation"]] for e in launches
                    if lo <= e["ts"] <= hi])
    return out


@pytest.mark.cuda
def test_one_launch_a_call_under_the_span(cuda, tmp_path):
    """A reduced granite's decode step on the card: each
    ``lm.mamba2.state`` span launches the kernel once and nothing else, and
    ``launches`` counts one a Mamba-2 layer."""
    cfg = configs.get_arch("granite-4.0-h-small").reduced(n_layers=4)
    m = make_model(cfg, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(0))
    layers = sum(s.mixer == "mamba2" for s in blocks.layer_specs(cfg))
    with torch.inference_mode():
        _, caches = m.prefill({"tokens": torch.arange(9, device=cuda)[None]
                               % 256}, 16)
        step = lambda: m.decode_step(caches, {"tokens": torch.zeros(
            (1, 1), dtype=torch.long, device=cuda)},
            torch.tensor([9], device=cuda))
        step()
        torch.cuda.synchronize()
        before = mamba2_state_update.launches
        with spans.recording(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    assert mamba2_state_update.launches - before == layers == 3
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    under = _kernels_under(json.loads((tmp_path / "trace.json").read_text()),
                           "lm.mamba2.state")
    assert len(under) == layers
    for names in under:
        assert len(names) == 1 and "mamba2_state_kernel" in names[0], names
