"""The port's ``PagedContinuousEngine`` against the JAX package's, on the
CPU (reduced f32 configs, the reference's parameters through
``params_from_jax``): every case of ``tests/test_paged.py``, with the
reference's engines run on the same requests; ``compiled_steps`` is held
by its keys and prices.  Greedy tokens equal token for token (and the dense engine's);
``ServeStats`` counters, ``step_weights`` and KV bytes equal.
"""
import numpy as np
import pytest

from _torch_serve_ref import pair, prompts, same_outputs, same_stats
from repro.serve import ContinuousEngine as RefContinuous
from repro.serve import PagedContinuousEngine as RefPaged
from repro.serve import ServeEngine as RefServe
from repro_torch.serve import (ContinuousEngine, PagedContinuousEngine,
                               PoolExhausted, ServeEngine)

ARCH = "qwen2.5-3b"
VOCAB = 256
MAX_LEN = 24
BS = 4                                        # block size


def _both(arch=ARCH, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("block_size", BS)
    ref_model, params, model = pair(arch)
    return (RefPaged(model=ref_model, params=params, **kw),
            PagedContinuousEngine(model=model, **kw))


def _run_both(requests, arch=ARCH, **kw):
    ref, eng = _both(arch, **kw)
    want = ref.run(requests)
    got = eng.run(requests)
    same_outputs(got, want)
    same_stats(eng, ref)
    for name in ("block_bytes", "kv_bytes_peak", "kv_bytes_dense",
                 "kv_bytes_in_use"):
        assert getattr(eng, name) == getattr(ref, name), name
    assert eng._pool.peak_in_use == ref._pool.peak_in_use
    return got, eng


def _static_tokens(prompts_, n_new, arch=ARCH, max_len=MAX_LEN):
    ref_model, params, model = pair(arch)
    got = ServeEngine(model=model, max_len=max_len).generate(prompts_, n_new)
    want = RefServe(model=ref_model, params=params,
                    max_len=max_len).generate(prompts_, n_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy()


def test_paged_matches_static_greedy():
    prompts_ = prompts(1, 2, 8, VOCAB)
    want = _static_tokens(prompts_, 6)
    outs, eng = _run_both([(prompts_[i], 6) for i in range(2)])
    np.testing.assert_array_equal(np.stack(outs), want)
    assert eng.stats.prefills_by_bucket == {f"prefill_chunk@{BS}": 4}


def test_paged_matches_dense_continuous_staggered():
    prompts_ = prompts(2, 4, 7, VOCAB)
    reqs = [(prompts_[i], 5, 2 * i) for i in range(4)]
    model = pair(ARCH)[2]
    dense = ContinuousEngine(model=model, n_slots=2, max_len=MAX_LEN,
                             prefill_buckets=(7,)).run(reqs)
    outs, eng = _run_both(reqs)
    same_outputs(outs, dense)
    assert eng.stats.completed == 4
    assert eng._pool.in_use == 0


def test_kv_bytes_scale_with_actual_lengths():
    prompts_ = prompts(3, 1, 9, VOCAB)
    _, eng = _run_both([(prompts_[0], 6)])
    assert eng.kv_bytes_peak == -(-(9 + 6 - 1) // BS) * eng.block_bytes
    assert eng.kv_bytes_dense == 2 * (MAX_LEN // BS) * eng.block_bytes
    assert eng.kv_bytes_peak < eng.kv_bytes_dense
    assert eng.stats.kv_bytes_peak == eng.kv_bytes_peak
    assert eng.stats.kv_bytes_dense == eng.kv_bytes_dense
    assert eng.kv_bytes_in_use == 0


def test_eos_retirement_frees_and_reuses_blocks():
    prompts_ = prompts(4, 4, 6, VOCAB)
    plain = _static_tokens(prompts_, 5)
    eos = int(plain[0, 2])
    need = -(-(6 + 5) // BS)
    outs, eng = _run_both([(prompts_[i], 5) for i in range(4)], eos_id=eos,
                          pool_blocks=2 * need)
    for i in range(4):
        exp = list(plain[i])
        exp = exp[:exp.index(eos) + 1] if eos in exp else exp
        assert list(outs[i]) == exp
    assert eng._pool.in_use == 0
    assert eng._pool.peak_in_use <= 2 * need
    assert not eng._tables.any()


def test_pool_exhaustion_raises_at_submit():
    eng = PagedContinuousEngine(model=pair(ARCH)[2], n_slots=2,
                                max_len=MAX_LEN, block_size=BS,
                                pool_blocks=2)
    with pytest.raises(PoolExhausted, match="needs 4 KV blocks.*holds 2"):
        eng.submit(prompts(5, 1, 9, VOCAB)[0], 6)
    assert not eng._queue and eng._pool.in_use == 0


def test_admission_backpressure():
    prompts_ = prompts(6, 3, 9, VOCAB)
    want = _static_tokens(prompts_, 6)
    outs, eng = _run_both([(prompts_[i], 6) for i in range(3)],
                          pool_blocks=4)
    np.testing.assert_array_equal(np.stack(outs), want)
    assert eng._pool.peak_in_use <= 4


def test_prefill_buckets_rejected():
    with pytest.raises(ValueError, match="prefill_buckets"):
        PagedContinuousEngine(model=pair(ARCH)[2], n_slots=2,
                              max_len=MAX_LEN, block_size=BS,
                              prefill_buckets=(8,))


def test_step_weights_reflect_observed_mix():
    _, eng = _run_both([(prompts(7, 1, 6, VOCAB)[0], 4)])
    w = eng.step_weights()
    assert w["decode"] == float(eng.stats.decode_steps) > 0
    assert w[f"prefill_chunk@{BS}"] == 2.0


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_ssm_archs_paged_parity(arch):
    """SSM / hybrid archs: recurrent states stay dense, admission is ONE
    exact-length prefill, attention KV (hybrid) is block-scattered; greedy
    outputs equal the static engine's and the reference's."""
    prompts_ = prompts(8, 3, 7, VOCAB)
    want = _static_tokens(prompts_, 5, arch=arch, max_len=16)
    outs, eng = _run_both([(prompts_[i], 5, i) for i in range(3)],
                          arch=arch, max_len=16)
    for i in range(3):
        np.testing.assert_array_equal(outs[i], want[i])
    assert eng._exact_prefill
    if arch == "falcon-mamba-7b":
        assert eng.block_bytes == 0
    else:
        assert eng.kv_bytes_peak > 0
    assert eng._pool.in_use == 0


def test_ssm_paged_matches_dense_continuous_with_slot_reuse():
    """jamba with more requests than slots and prompts of several
    lengths (none a multiple of the block): paged == dense continuous ==
    the reference's paged engine."""
    arch = "jamba-v0.1-52b"
    reqs = [(prompts(20 + i, 1, n, VOCAB)[0], 4 + i, i)
            for i, n in enumerate((5, 9, 3, 11))]
    dense = ContinuousEngine(model=pair(arch)[2], n_slots=2,
                             max_len=MAX_LEN).run(reqs)
    ref_model, params, _ = pair(arch)
    same_outputs(dense, RefContinuous(model=ref_model, params=params,
                                      n_slots=2, max_len=MAX_LEN).run(reqs))
    outs, _ = _run_both(reqs, arch=arch)
    same_outputs(outs, dense)


def test_compiled_steps_not_ported():
    """The paged engine's compiled_steps (ported: the name is kept) gives
    the reference's keys: the decode plus the chunk prefill (attention
    archs) or one exact prefill per seen length (SSM archs)."""
    ref, eng = _both()
    assert set(eng.compiled_steps()) == set(ref.compiled_steps()) \
        == {"decode", f"prefill_chunk@{BS}"}
    ref, eng = _both(arch="falcon-mamba-7b")
    assert set(eng.compiled_steps()) == set(ref.compiled_steps()) \
        == {"decode", f"prefill@{MAX_LEN}"}
    reqs = [(p, 2) for p in prompts(4, 2, 5, VOCAB)] \
        + [(prompts(5, 1, 7, VOCAB)[0], 2)]
    same_outputs(eng.run(reqs), ref.run(reqs))
    # one exact prefill per seen length, as the reference's docstring
    # says; the reference's paged admission never records a seen length,
    # so it keeps giving prefill@max_len (a reference caveat)
    assert set(eng.compiled_steps()) == {"decode", "prefill@5", "prefill@7"}
    assert set(ref.compiled_steps()) == {"decode", f"prefill@{MAX_LEN}"}
    assert set(eng.compiled_steps(buckets=(MAX_LEN,))) \
        == set(ref.compiled_steps())


def test_paged_compiled_steps_price_to_one():
    """The paged deployment's steps price as the reference's: one device,
    no collectives, speedup 1.0 in every scenario; the capture leaves the
    pool as it was."""
    from repro.core import CommAdvisor as RefAdvisor
    from repro_torch.core import CommAdvisor, price

    ref, eng = _both()
    reqs = [(p, 4) for p in prompts(6, 2, 6, VOCAB)]
    eng.run(reqs)
    ref.run(reqs)
    pools = [{k: v.clone() for k, v in pl.items()} if pl else None
             for pl in eng._pools]
    adv = CommAdvisor()
    got = price(eng, adv.default_grid(2, 2), plan="numpy")
    want = RefAdvisor().sweep_serve(ref, RefAdvisor().default_grid(2, 2))
    assert got.names == want.names
    np.testing.assert_allclose(got.predicted_speedup(), 1.0)
    np.testing.assert_allclose(got.predicted_speedup(),
                               want.predicted_speedup(), rtol=1e-9)
    for pl, before in zip(eng._pools, pools):
        if before:
            for k in before:
                assert pl[k].equal(before[k])
