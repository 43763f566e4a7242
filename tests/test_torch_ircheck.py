"""The port's captured-step checker (``repro_torch.analysis.ircheck``),
beside the JAX package's (``repro.analysis.ircheck``,
``tests/test_ircheck.py``).

Seeded bad steps trip exactly their pass (a reallocated in-place
argument, an f32-to-f64 promotion, an ``.item()``, a mesh mismatch, a
single-member group, a busted budget) while clean ones stay silent, and the
registered entries run clean on the repo against the committed budgets.
The reference's x64 re-trace, its while/scan carry-aliasing liveness and
its HLO alias parsing have no counterpart: PyTorch's promotions are real
in the one capture, the capture counts storages as the step holds them
(no loop carries), and the in-place writes are ops the audit sees.
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis import ircheck as ref_irc
from repro_torch.analysis import ircheck as irc
from repro_torch.launch.mesh import init_fake_ranks

#: The reference's entry points, with the one rename.
RENAMED = {"sweep.price_grid_jax": "sweep.price_grid_torch"}


def x8():
    return torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 8)).astype(np.float32))


@pytest.fixture(scope="module")
def repo_reports():
    """Every registered entry, captured once for the module, against the
    committed budgets."""
    return irc.check_entrypoints(baseline=irc.load_baseline(irc.BASELINE))


# ------------------------------------------------------------- registry

def test_entry_names_cover_the_reference():
    want = {RENAMED.get(n, n) for n in ref_irc.known_entrypoints()}
    assert want == set(irc.known_entrypoints())
    assert len(want) == 8


def test_registry_rejects_duplicate_unless_overwrite():
    irc.register_entrypoint("tmp.dup", lambda **_: None)
    try:
        with pytest.raises(ValueError, match="already registered"):
            irc.register_entrypoint("tmp.dup", lambda **_: None)
        irc.register_entrypoint("tmp.dup", lambda **_: None, overwrite=True)
    finally:
        irc._ENTRYPOINTS.pop("tmp.dup", None)


def test_check_unknown_entrypoint_errors():
    with pytest.raises(ValueError, match="unknown entry point"):
        irc.check_entrypoints(["not.an.entry"])


def test_four_rank_entry_skips_under_another_group():
    init_fake_ranks(2)
    try:
        (rep,) = irc.check_entrypoints(["sweep.price_topk_chunk"])
    finally:
        dist.destroy_process_group()
    assert rep.status == "skipped" and "needs 4 ranks" in rep.note


# ----------------------------------------------------------- clean spec

def test_clean_entry_is_ok_with_metrics():
    rep, cap = irc.check_entry(irc.EntrySpec(
        "t.clean", lambda x: torch.tanh(x @ x), args=(x8(),)))
    assert rep.status == "ok" and rep.findings == []
    assert rep.metrics["peak_live_bytes"] == cap.peak_bytes > 0
    assert rep.metrics["copy_transpose_bytes"] == 0


def test_peak_live_bytes_counts_simultaneous_liveness():
    def two_live(x):
        a, b = x @ x, x + 1.0
        return a * b
    one = irc.check_entry(irc.EntrySpec("t.one", lambda x: x @ x,
                                        args=(x8(),)))[0]
    two = irc.check_entry(irc.EntrySpec("t.two", two_live,
                                        args=(x8(),)))[0]
    assert one.metrics["peak_live_bytes"] == 8 * 8 * 4
    assert two.metrics["peak_live_bytes"] == 3 * 8 * 8 * 4


def test_copy_bytes_count_layout_changes():
    rep = irc.check_entry(irc.EntrySpec(
        "t.copy", lambda x: x.t().contiguous(), args=(x8(),)))[0]
    assert rep.metrics["copy_transpose_bytes"] == 8 * 8 * 4


# ------------------------------------------------------ in-place pass

def test_reallocated_inplace_argument_is_a_finding():
    def realloc(state, x):
        return {"k": state["k"] + x}, x          # a new tensor, no write
    rep = irc.check_entry(irc.EntrySpec(
        "t.realloc", realloc, args=({"k": x8()}, x8()), inplace=(0,)))[0]
    assert [f.rule for f in rep.findings] == ["inplace-dead"]
    assert "[t.realloc]" in rep.findings[0].message
    assert "1 of its 1 tensors" in rep.findings[0].message


def test_inplace_write_through_a_view_is_clean():
    def write(cache, x):
        cache[:, :4].copy_(x[:, :4])
        return cache
    rep = irc.check_entry(irc.EntrySpec(
        "t.write", write, args=(x8(), x8()), inplace=(0,)))[0]
    assert rep.findings == []


def test_inplace_path_selects_part_of_an_argument():
    def step(state):
        state["mu"].mul_(0.5)
        state["count"] = state["count"] + 1      # a fresh host scalar
        return state
    args = ({"mu": x8(), "count": torch.zeros((), dtype=torch.int32)},)
    ok = irc.check_entry(irc.EntrySpec("t.mu", step, args=args,
                                       inplace=((0, "mu"),)))[0]
    bad = irc.check_entry(irc.EntrySpec("t.all", step, args=args,
                                        inplace=(0,)))[0]
    assert ok.findings == []
    assert [f.rule for f in bad.findings] == ["inplace-dead"]


# ------------------------------------------------------ promotion pass

def test_silent_f64_promotion_is_a_finding():
    rep = irc.check_entry(irc.EntrySpec(
        "t.promo", lambda x: x.to(torch.float64) * 1.5, args=(x8(),)))[0]
    assert {f.rule for f in rep.findings} == {"f64-promotion"}
    assert "aten::_to_copy" in rep.findings[0].message


def test_x64_entry_exempt_from_promotion_pass():
    rep = irc.check_entry(irc.EntrySpec(
        "t.promo64", lambda x: x.to(torch.float64) * 1.5, args=(x8(),),
        x64=True))[0]
    assert rep.findings == []


# ------------------------------------------------------ host-sync pass

def test_item_under_fake_tensors_is_a_host_sync_not_an_error():
    def sync(x):
        return x * x.sum().item()
    rep = irc.check_entry(irc.EntrySpec("t.item", sync, args=(x8(),)))[0]
    assert rep.status == "findings"
    assert [f.rule for f in rep.findings] == ["host-sync"]
    assert "_local_scalar_dense" in rep.findings[0].message
    assert "tests/test_torch_ircheck.py:" in rep.findings[0].message
    assert rep.metrics["peak_live_bytes"] > 0     # the capture went on


def test_allowed_sync_is_clean_and_counted():
    rep = irc.check_entry(irc.EntrySpec(
        "t.nz", lambda x: x[torch.nonzero(x > 0)[:, 0]], args=(x8(),),
        allow_syncs={"aten::nonzero": "test: a data-dependent shape"}))[0]
    assert rep.findings == [] and rep.metrics["host_syncs"] == 1


def test_constant_host_scalar_is_no_sync():
    rep = irc.check_entry(irc.EntrySpec(
        "t.const", lambda x, n: x * float(n),
        args=(x8(), torch.tensor(3.0))))[0]
    assert rep.findings == [] and rep.metrics["host_syncs"] == 0


def test_transfers_on_a_fake_card():
    """Copies between the host and the card, on fake CUDA tensors (no card
    needed): one to the host and one from it are host syncs, counted
    apart, and neither is layout churn."""
    from repro_torch.core import graph
    x = graph.abstract(torch.zeros, (8, 8), device="cuda")

    def step(x):
        two = torch.tensor(2.0, device=x.device)
        return x * two, x.sum().cpu()
    rep = irc.check_entry(irc.EntrySpec("t.moves", step, args=(x,)))[0]
    assert [f.rule for f in rep.findings] == ["host-sync", "host-sync"]
    assert "(device to host)" in rep.findings[0].message
    # torch.tensor on the card: a lift_fresh and a copy, one finding
    assert "(a tensor from host data)" in rep.findings[1].message
    assert rep.metrics["host_syncs"] == 1
    assert rep.metrics["host_to_device"] == 2
    assert rep.metrics["copy_transpose_bytes"] == 0


def test_tensors_made_from_host_data_are_counted():
    """``torch.tensor(...)`` inside a step (on the card, a copy from the
    host) is a host sync on any device, so the host's and the card's
    captures agree; allowed, it is clean and listed."""
    step = lambda x: x * torch.tensor(2.0)          # noqa: E731
    rep = irc.check_entry(irc.EntrySpec("t.lift", step, args=(x8(),)))[0]
    assert [f.rule for f in rep.findings] == ["host-sync"]
    assert rep.metrics["host_to_device"] == 1
    rep = irc.check_entry(irc.EntrySpec(
        "t.lift", step, args=(x8(),),
        allow_syncs={"aten::lift_fresh": "test: a host constant"}))[0]
    assert rep.findings == [] and rep.metrics["host_to_device"] == 1
    assert [op for op, _ in rep.allowed] == [
        "aten::lift_fresh (a tensor from host data)"]


def test_planted_new_tensor_in_a_masked_attention_is_found():
    """The masked attention's fill as a tensor made from a number (each
    one a copy from the host on the card, which waits for it) is a
    ``host-sync`` finding at its line; the Python scalar is clean."""
    scores = x8()
    mask = scores > 0

    def planted(s, m):
        return torch.where(m, s, s.new_tensor(-1e30))

    def fixed(s, m):
        return torch.where(m, s, -1e30)
    bad = irc.check_entry(irc.EntrySpec("t.planted", planted,
                                        args=(scores, mask)))[0]
    assert [f.rule for f in bad.findings] == ["host-sync"]
    assert "aten::lift_fresh" in bad.findings[0].message
    line = planted.__code__.co_firstlineno + 1
    assert f"tests/test_torch_ircheck.py:{line} " in bad.findings[0].message
    good = irc.check_entry(irc.EntrySpec("t.fixed", fixed,
                                         args=(scores, mask)))[0]
    assert good.findings == [] and good.metrics["host_to_device"] == 0


def test_allow_by_file_allows_that_file_only():
    step = lambda x: x * torch.tensor(2.0)          # noqa: E731
    here = "aten::lift_fresh@tests/test_torch_ircheck.py"
    other = "aten::lift_fresh@src/repro_torch/train/optimizer.py"
    ok = irc.check_entry(irc.EntrySpec("t.lift", step, args=(x8(),),
                                       allow_syncs={here: "test"}))[0]
    assert ok.findings == [] and len(ok.allowed) == 1
    bad = irc.check_entry(irc.EntrySpec("t.lift", step, args=(x8(),),
                                        allow_syncs={other: "test"}))[0]
    assert [f.rule for f in bad.findings] == ["host-sync"]
    assert bad.allowed == []


# ----------------------------------------------------- collective pass

def _calls(*groups, kind="all-reduce"):
    return [(kind, 64, g, ()) for g in groups]


def test_collective_matching_mesh_is_clean():
    assert irc.collective_findings(_calls(4), {"x": 4}) == []
    assert irc.collective_findings(_calls(4, 2), {"dp": 2, "tp": 2}) == []


def test_collective_mesh_mismatch_flagged():
    msgs = irc.collective_findings(_calls(4), {"x": 3})
    assert len(msgs) == 1 and "not a product" in msgs[0] and "x=3" in msgs[0]


def test_collective_without_registered_mesh_flagged():
    msgs = irc.collective_findings(_calls(4), None)
    assert len(msgs) == 1 and "registered no mesh" in msgs[0]


def test_degenerate_single_member_collective_flagged():
    msgs = irc.collective_findings(_calls(1), {"x": 4})
    assert len(msgs) == 1 and "degenerate" in msgs[0]


def test_permute_records_no_group_and_no_finding():
    assert irc.collective_findings(_calls(1, kind="collective-permute"),
                                   {"x": 4}) == []
    assert irc.collective_findings([], None) == []


def test_captured_collective_against_the_mesh():
    from repro_torch.parallel import transport

    def step(x):
        return transport.all_gather(x, dist.group.WORLD)
    with irc.ranks(4):
        bad = irc.check_entry(irc.EntrySpec("t.mesh", step, args=(x8(),),
                                            mesh_axes={"x": 3}))[0]
        good = irc.check_entry(irc.EntrySpec("t.mesh", step, args=(x8(),),
                                             mesh_axes={"dp": 2, "x": 2}))[0]
    assert [f.rule for f in bad.findings] == ["collective-mesh"]
    assert good.findings == []


# ----------------------------------------------------------- budgets

def test_busted_budget_is_a_finding():
    spec = irc.EntrySpec("t.budget", lambda x: x @ x, args=(x8(),))
    rep = irc.check_entry(spec, {"peak_live_bytes": 100,
                                 "copy_transpose_bytes": 0})[0]
    assert [f.rule for f in rep.findings] == ["peak-live-bytes"]


def test_in_budget_is_clean_and_slack_absorbs_drift():
    spec = irc.EntrySpec("t.budget", lambda x: x @ x, args=(x8(),))
    assert irc.check_entry(spec, {"peak_live_bytes": 256,
                                  "copy_transpose_bytes": 0})[0].findings \
        == []
    # 256 measured against 220: 16% over, inside the 25% slack
    assert irc.check_entry(spec, {"peak_live_bytes": 220,
                                  "copy_transpose_bytes": 0})[0].findings \
        == []
    assert irc.check_entry(spec, {"peak_live_bytes": 220,
                                  "copy_transpose_bytes": 0},
                           slack=0.1)[0].findings != []


def test_missing_budget_metric_is_a_finding():
    spec = irc.EntrySpec("t.budget", lambda x: x @ x, args=(x8(),))
    rep = irc.check_entry(spec, {"peak_live_bytes": 256})[0]
    assert [f.rule for f in rep.findings] == ["baseline-missing"]


def test_write_and_load_baseline_roundtrip_merges(tmp_path):
    path = tmp_path / "base.json"
    old = irc.EntryReport("a", "ok", metrics={"peak_live_bytes": 1,
                                              "copy_transpose_bytes": 2,
                                              "host_syncs": 0})
    irc.write_baseline(path, [old], 0.25)
    new = irc.EntryReport("b", "ok", metrics={"peak_live_bytes": 3,
                                              "copy_transpose_bytes": 4,
                                              "host_syncs": 1})
    out = irc.write_baseline(path, [new, irc.EntryReport("c", "error")],
                             0.3)
    assert irc.load_baseline(path) == out
    assert out == {"slack": 0.3, "entries": {
        "a": {"copy_transpose_bytes": 2, "peak_live_bytes": 1},
        "b": {"copy_transpose_bytes": 4, "peak_live_bytes": 3}}}


def test_committed_baseline_covers_all_builtins():
    base = irc.load_baseline(irc.BASELINE)
    assert base["slack"] == irc.DEFAULT_SLACK
    assert set(base["entries"]) == set(irc.known_entrypoints())


# ---------------------------------------------------------- the repo

def test_registered_entries_run_clean(repo_reports):
    assert {r.name for r in repo_reports} == set(irc.known_entrypoints())
    for r in repo_reports:
        assert r.status == "ok", (r.name, r.note,
                                  [str(f) for f in r.findings])
        assert r.metrics["peak_live_bytes"] >= 0


def test_only_the_streaming_chunk_syncs(repo_reports):
    syncs = {r.name: r.metrics["host_syncs"] for r in repo_reports}
    assert syncs.pop("sweep.price_topk_chunk") == 1       # its bincount
    assert set(syncs.values()) == {0}


def test_only_the_train_step_makes_tensors_from_host_data(repo_reports):
    """The pricing steps fill their numbers on the device (no copy from
    the host); the train step's schedule scalars stay on the host, allowed
    by file."""
    made = {r.name: r.metrics["host_to_device"] for r in repo_reports}
    assert made.pop("train.step") == 6
    assert set(made.values()) == {0}
    train = next(r for r in repo_reports if r.name == "train.step")
    assert {w.rpartition(":")[0] for _, w in train.allowed} == {
        "src/repro_torch/train/optimizer.py"}


def test_hist_edges_made_on_the_device_equal_the_constant():
    from repro_torch.core.sweep_kernel import SPEEDUP_HIST_EDGES, hist_edges
    for dtype in (torch.float64, torch.float32):
        assert torch.equal(hist_edges(dtype, "cpu"),
                           torch.as_tensor(SPEEDUP_HIST_EDGES, dtype=dtype))


def test_decode_reallocating_its_caches_would_be_found():
    spec = irc.build_entry("serve.decode")
    model = spec.args[0]
    fresh = [None if c is None else {k: v.clone() for k, v in c.items()}
             for c in model]
    spec.args = (fresh,) + spec.args[1:]
    base = spec.fn
    # the caches the step writes are not the ones the spec declares
    spec.fn = lambda c, t, p: base([None if x is None else
                                    {k: v.clone() for k, v in x.items()}
                                    for x in c], t, p)
    rep = irc.check_entry(spec)[0]
    assert [f.rule for f in rep.findings] == ["inplace-dead"]


# --------------------------------------------------------------- CLI

def test_cli_list_prints_entries(capsys):
    assert irc.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == list(irc.known_entrypoints())


def test_cli_unknown_entry_is_usage_error(capsys):
    assert irc.main(["--entry", "nope"]) == 2


def test_cli_seeded_bad_entry_exits_nonzero_with_contract(capsys):
    def promote(**_):
        return irc.EntrySpec("t.seeded", lambda x: x.double(), args=(x8(),))
    irc.register_entrypoint("t.seeded", promote)
    try:
        assert irc.main(["--entry", "t.seeded", "--baseline",
                         "/nonexistent.json"]) == 1
    finally:
        irc._ENTRYPOINTS.pop("t.seeded", None)
    line = capsys.readouterr().out.strip().splitlines()[0]
    path, rule, msg = line.split(" ", 2)
    assert path.endswith(".py:" + path.rsplit(":", 1)[1])
    assert rule == "f64-promotion" and msg.startswith("[t.seeded]")


def test_cli_json_runs_clean_on_the_repo(capsys):
    assert irc.main(["--format", "json", "--entry", "serve.write",
                     "--entry", "sweep.price_grid_torch"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert set(payload) == {"tool", "n_findings", "entries"}
    assert payload["tool"] == "repro_torch.analysis.ircheck"
    assert payload["n_findings"] == 0
    assert [e["name"] for e in payload["entries"]] == [
        "serve.write", "sweep.price_grid_torch"]
    assert set(payload["entries"][0]) == {"name", "status", "note",
                                          "metrics", "findings"}
