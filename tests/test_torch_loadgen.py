"""The port's load generator against the JAX package's: the same seeds give
bit-identical workloads (arrivals, prompts, budgets, meta), length specs
parse and sample alike, and ``run_workload`` over the port's engines gives
the reference engines' outputs and a coherent ``LoadReport``."""
import json

import numpy as np
import pytest

from _torch_serve_ref import pair, same_outputs
from repro.serve import ContinuousEngine as RefContinuous
from repro.serve import loadgen as ref_loadgen
from repro_torch.serve import (ContinuousEngine, LengthDist,
                               PagedContinuousEngine, poisson_workload,
                               replay_workload, run_workload)


def _identical(got, want):
    assert np.array_equal(got.arrivals, want.arrivals)
    assert got.arrivals.dtype == want.arrivals.dtype
    assert np.array_equal(got.max_new, want.max_new)
    assert got.max_new.dtype == want.max_new.dtype
    assert len(got.prompts) == len(want.prompts)
    for p, q in zip(got.prompts, want.prompts):
        assert p.dtype == q.dtype and np.array_equal(p, q)
    assert got.meta == want.meta
    assert got.total_tokens == want.total_tokens
    for a, b in zip(got.requests(), want.requests()):
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]


POISSON = [
    dict(n=32, rate=0.5, prompt_len="uniform:4:12",
         new_tokens="lognormal:1.5:0.4:16", vocab_size=512, seed=7),
    dict(n=64, rate=1.0, prompt_len="uniform:1:40", new_tokens="uniform:1:40",
         vocab_size=64, seed=3, max_len=24),
    dict(n=16, rate=0.5, prompt_len="uniform:256:2048",
         new_tokens="uniform:16:64", vocab_size=65536, seed=0, max_len=4096),
    dict(n=20, rate=2.0, prompt_len="choice:4,8,16", new_tokens=6,
         vocab_size=1000, seed=11),
]


@pytest.mark.parametrize("kw", POISSON)
def test_poisson_workload_bit_identical(kw):
    _identical(poisson_workload(**kw), ref_loadgen.poisson_workload(**kw))


def test_poisson_workload_deterministic():
    kw = POISSON[0]
    _identical(poisson_workload(**kw), poisson_workload(**kw))
    other = poisson_workload(**{**kw, "seed": 8})
    assert not np.array_equal(other.arrivals,
                              poisson_workload(**kw).arrivals)
    with pytest.raises(ValueError, match=">= 1 request"):
        poisson_workload(**{**kw, "n": 0})
    with pytest.raises(ValueError, match="rate"):
        poisson_workload(**{**kw, "rate": 0})


@pytest.mark.parametrize("spec", ["fixed:8", "uniform:4:12",
                                  "lognormal:2.3:0.6:48", "choice:4,8,16", 8])
def test_length_dist_same_as_reference(spec):
    got, want = LengthDist.parse(spec), ref_loadgen.LengthDist.parse(spec)
    assert got.spec() == want.spec()
    a = got.sample(np.random.default_rng(5), 200)
    b = want.sample(np.random.default_rng(5), 200)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_length_dist_errors():
    with pytest.raises(ValueError, match="unknown length distribution"):
        LengthDist.parse("zipf:1.1")
    with pytest.raises(ValueError, match="bad length spec"):
        LengthDist.parse("uniform:4")


def test_replay_workload_bit_identical(tmp_path):
    trace = [{"arrival": 0, "prompt_len": 5, "max_new": 3},
             {"arrival": 2, "tokens": [1, 2, 3], "max_new": 4},
             {"prompt_len": 9, "max_new": 1}]
    _identical(replay_workload(trace, vocab_size=32, seed=1),
               ref_loadgen.replay_workload(trace, vocab_size=32, seed=1))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    _identical(replay_workload(str(path), vocab_size=32, seed=1),
               ref_loadgen.replay_workload(str(path), vocab_size=32, seed=1))
    with pytest.raises(ValueError, match="empty trace"):
        replay_workload([], vocab_size=32)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "jamba-v0.1-52b"])
def test_run_workload_report(arch):
    """The port's paged engine driven by ``run_workload`` gives the
    reference's dense engine's outputs, and a coherent report."""
    ref_model, params, model = pair(arch)
    w = poisson_workload(n=4, rate=0.7, prompt_len="uniform:4:8",
                         new_tokens="fixed:4", vocab_size=256, seed=11,
                         max_len=24)
    paged = PagedContinuousEngine(model=model, n_slots=2, max_len=24,
                                  block_size=4)
    outs, rep = run_workload(paged, w, slo_ms=60_000.0)
    buckets = () if arch != "qwen2.5-3b" else (8,)
    ref = RefContinuous(model=ref_model, params=params, n_slots=2,
                        max_len=24, prefill_buckets=buckets).run(w.requests())
    same_outputs(outs, ref)
    dense = ContinuousEngine(model=model, n_slots=2, max_len=24,
                             prefill_buckets=buckets)
    same_outputs(run_workload(dense, w)[0], ref)
    d = rep.as_dict()
    assert d["n_requests"] == 4
    assert d["generated_tokens"] == sum(len(o) for o in outs)
    assert d["latency_p99_ms"] >= d["latency_p50_ms"] >= d["ttft_p50_ms"] > 0
    assert d["sustained_tok_s"] > 0 and d["makespan_s"] > 0
    assert d["slo_ms"] == 60_000.0 and 0.0 <= d["slo_attainment"] <= 1.0
    assert set(d) == set(ref_loadgen.LoadReport(
        **{k: v for k, v in d.items()}).as_dict())
