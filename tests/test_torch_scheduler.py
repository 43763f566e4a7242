"""The port's ``ContinuousEngine`` against the JAX package's, on the CPU
(reduced f32 configs, the reference's parameters through
``params_from_jax``): every case of ``tests/test_scheduler.py``, with the
reference's engines run on the same requests.  Greedy tokens equal token
for token; ``ServeStats`` counters and ``step_weights`` equal;
``compiled_steps`` gives the reference's step names, and the advisor
prices them as the reference's (speedup 1.0: one device, no
collectives).  Plus the MoE capacity of a slot-batched
decode (per slot, as the reference's ``jax.vmap`` over slots) against the
static engine's (the whole batch).
"""
import numpy as np
import pytest

from _torch_serve_ref import pair, prompts, same_outputs, same_stats
from repro.serve import ContinuousEngine as RefContinuous
from repro.serve import ServeEngine as RefServe
from repro_torch import configs
from repro_torch.models import moe
from repro_torch.serve import ContinuousEngine, ServeEngine

ARCH = "qwen2.5-3b"
VOCAB = 256
MAX_LEN = 24


def _both(arch=ARCH, **kw):
    """(reference engine, port engine), built alike."""
    ref_model, params, model = pair(arch)
    return (RefContinuous(model=ref_model, params=params, **kw),
            ContinuousEngine(model=model, **kw))


def _static(arch=ARCH, max_len=MAX_LEN):
    ref_model, params, model = pair(arch)
    return (RefServe(model=ref_model, params=params, max_len=max_len),
            ServeEngine(model=model, max_len=max_len))


def _run_both(requests, arch=ARCH, **kw):
    ref, eng = _both(arch, **kw)
    want = ref.run(requests)
    got = eng.run(requests)
    same_outputs(got, want)
    same_stats(eng, ref)
    return got, eng


def test_continuous_matches_static_greedy():
    """All requests at t=0, fitting one batch, exact-length bucket ->
    token-for-token the static engine's (both packages') greedy outputs."""
    prompts_ = prompts(1, 2, 8, VOCAB)
    ref_static, static = _static()
    want = static.generate(prompts_, 6).numpy()
    np.testing.assert_array_equal(want, np.asarray(
        ref_static.generate(prompts_, 6)))
    outs, eng = _run_both([(prompts_[i], 6) for i in range(2)], n_slots=2,
                          max_len=MAX_LEN, prefill_buckets=(8,))
    np.testing.assert_array_equal(np.stack(outs), want)
    assert eng.stats.occupancy == 1.0
    assert eng.stats.decode_steps == 5


def test_bucketed_prefill_padding_matches_static():
    prompts_ = prompts(2, 2, 6, VOCAB)                # 6 < bucket 8
    want = _static()[1].generate(prompts_, 5).numpy()
    outs, eng = _run_both([(prompts_[i], 5) for i in range(2)], n_slots=2,
                          max_len=MAX_LEN, prefill_buckets=(8,))
    np.testing.assert_array_equal(np.stack(outs), want)
    assert eng.stats.prefills_by_bucket == {"prefill@8": 2}


def test_staggered_arrivals_and_slot_reuse():
    prompts_ = prompts(3, 4, 8, VOCAB)
    want = _static()[1].generate(prompts_, 6).numpy()
    outs, eng = _run_both([(prompts_[i], 6, 3 * i) for i in range(4)],
                          n_slots=2, max_len=MAX_LEN, prefill_buckets=(8,))
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, want[i])
    s = eng.stats
    assert s.completed == 4 and s.prefills == 4
    assert 0.0 < s.occupancy <= 1.0
    assert s.slot_steps == 4 * 5


def test_eos_retirement_frees_slot():
    prompts_ = prompts(4, 3, 8, VOCAB)
    plain = _static()[1].generate(prompts_, 6).numpy()
    eos = int(plain[0, 2])
    outs, _ = _run_both([(prompts_[i], 6) for i in range(3)], n_slots=1,
                        max_len=MAX_LEN, prefill_buckets=(8,), eos_id=eos)
    first = list(plain[0]).index(eos) + 1
    np.testing.assert_array_equal(outs[0], plain[0][:first])
    for i in (1, 2):
        exp = list(plain[i])
        exp = exp[:exp.index(eos) + 1] if eos in exp else exp
        np.testing.assert_array_equal(outs[i], np.asarray(exp))


def test_varied_lengths_and_budget_cap():
    prompts_ = prompts(5, 2, 8, VOCAB)
    outs, _ = _run_both([(prompts_[0], 3), (prompts_[1], 99)], n_slots=2,
                        max_len=12, prefill_buckets=(8,))
    assert len(outs[0]) == 3
    assert len(outs[1]) == 12 - 8             # capped by cache room


def test_default_power_of_two_buckets():
    """No buckets given: one power-of-two bucket per prompt-length class,
    as in the reference."""
    reqs = [(prompts(10, 1, n, VOCAB)[0], 4, i)
            for i, n in enumerate((3, 5, 9))]
    _, eng = _run_both(reqs, n_slots=2, max_len=MAX_LEN)
    assert eng.stats.prefills_by_bucket == {"prefill@4": 1, "prefill@8": 1,
                                            "prefill@16": 1}


def test_ssm_arch_exact_length_admission():
    arch = "falcon-mamba-7b"
    prompts_ = prompts(6, 2, 6, VOCAB)
    ref_static, static = _static(arch, max_len=16)
    want = static.generate(prompts_, 5).numpy()
    np.testing.assert_array_equal(want, np.asarray(
        ref_static.generate(prompts_, 5)))
    with pytest.raises(ValueError, match="SSM"):
        ContinuousEngine(model=pair(arch)[2], n_slots=2, max_len=16,
                         prefill_buckets=(8,))
    outs, eng = _run_both([(prompts_[i], 5) for i in range(2)], arch=arch,
                          n_slots=2, max_len=16)
    assert eng._bucket_for(6) == 6
    np.testing.assert_array_equal(np.stack(outs), want)


def test_submit_validation():
    eng = ContinuousEngine(model=pair(ARCH)[2], n_slots=2, max_len=12)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros(0, np.int32), 4)
    with pytest.raises(ValueError, match="no room"):
        eng.submit(np.zeros(12, np.int32), 4)
    assert eng.submit(np.zeros(4, np.int32), 0) == 0
    outs = eng.run()
    assert len(outs) == 1 and outs[0].shape == (0,)
    with pytest.raises(ValueError, match="multimodal"):
        ContinuousEngine(model=pair("musicgen-medium")[2], n_slots=1,
                         max_len=8)
    assert set(eng.compiled_steps()) == {"prefill@12", "decode"}


def test_temperature_reproducible_by_seed():
    """Temperature draws: one seed, one output; the streams are the
    port's own (``jax.random`` cannot be replayed)."""
    model = pair(ARCH)[2]
    reqs = [(prompts(11, 3, 8, VOCAB)[i], 6, i) for i in range(3)]
    runs = [ContinuousEngine(model=model, n_slots=2, max_len=MAX_LEN,
                             temperature=2.0, seed=s).run(reqs)
            for s in (7, 7, 8)]
    same_outputs(runs[0], runs[1])
    assert any(not np.array_equal(a, b) for a, b in zip(runs[0], runs[2]))


# ------------------------------------------------------------ MoE capacity
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
N_SLOTS = 32


def test_moe_capacity_of_32_slots_is_below_one_experts_rows():
    cfg = configs.get_arch(MOE_ARCH).reduced()
    assert (cfg.n_experts, cfg.experts_per_token) == (4, 2)
    assert moe.capacity(cfg, N_SLOTS) == 24 < N_SLOTS
    assert moe.capacity(cfg, 1) == 8


def test_moe_slot_batched_decode_keeps_what_a_batched_capacity_drops():
    """32 identical prompts: every decode step routes all 32 tokens to the
    same two experts.  The reference decodes each slot on its own
    (``jax.vmap``: capacity(cfg, 1) = 8, nothing dropped), so the
    continuous engines give 32 equal rows; the static engines prefill and
    decode the batch at once (capacity(cfg, 32) = 24 in decode), drop the
    later rows' assignments, and those rows come out otherwise.  Both
    ports match their references token for token."""
    prompt = prompts(12, 1, 8, VOCAB)[0]
    reqs = [(prompt, 6)] * N_SLOTS
    outs, _ = _run_both(reqs, arch=MOE_ARCH, n_slots=N_SLOTS, max_len=16)
    assert all(np.array_equal(o, outs[0]) for o in outs)

    ref_static, static = _static(MOE_ARCH, max_len=16)
    batch = np.stack([prompt] * N_SLOTS)
    got = static.generate(batch, 6).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        ref_static.generate(batch, 6)))
    # row 0 ranks first in every expert, so nothing of it is dropped
    np.testing.assert_array_equal(got[0], outs[0])
    assert not np.array_equal(got, np.stack(outs))


@pytest.mark.parametrize("impl", ["dense", "scatter"])
def test_per_row_routing_is_one_call_per_row(impl):
    """``moe_ffn(..., per_row=True)`` on a (B, S, d) batch equals B calls of
    one row each (each row's own capacity and ranks).  32 slots' equal
    tokens, as in a decode step: one call per row drops nothing; the whole
    batch at once (capacity(cfg, 32) = 24) drops the last 8 rows'
    assignments and reads zeros back for them."""
    import torch
    model = pair(MOE_ARCH)[2]
    layer = next(l for l in model.stack if l.spec.ffn == "moe")
    cfg = model.cfg
    rng = np.random.default_rng(13)
    x = torch.as_tensor(np.concatenate(
        [np.repeat(rng.normal(size=(1, 1, cfg.d_model)), N_SLOTS, axis=0),
         rng.normal(size=(3, 5, cfg.d_model))[:, :1]]), dtype=torch.float32)
    with torch.no_grad():
        got, _ = moe.moe_ffn(layer["moe"], x, cfg, impl=impl, per_row=True)
        want = torch.cat([moe.moe_ffn(layer["moe"], x[b:b + 1], cfg,
                                      impl=impl)[0] for b in range(len(x))])
        batched, _ = moe.moe_ffn(layer["moe"], x, cfg, impl=impl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)
    assert torch.equal(got[:N_SLOTS], got[:1].expand(N_SLOTS, -1, -1))
    assert torch.equal(batched[:24], got[:24])
    assert (batched[24:N_SLOTS] == 0).all() and got[24].abs().max() > 0


def test_compiled_steps_for_advisor():
    """compiled_steps gives one captured step per prefill bucket + the
    decode step, priced by the advisor in one batched call as the
    reference's compiled steps are (``test_scheduler.py``)."""
    from repro.core import CommAdvisor as RefAdvisor
    from repro_torch.core import CapturedStep, CommAdvisor, MultiSweepResult

    ref, eng = _both(n_slots=2, max_len=16, prefill_buckets=(8,))
    steps = eng.compiled_steps()
    assert set(steps) == set(ref.compiled_steps()) == {"prefill@8", "decode"}
    assert all(isinstance(c, CapturedStep) for c in steps.values())
    assert all(c.collectives() == [] for c in steps.values())

    adv = CommAdvisor()
    res = adv.sweep_serve(eng, adv.default_grid(2, 2), plan="numpy")
    want = RefAdvisor().sweep_serve(ref, RefAdvisor().default_grid(2, 2))
    assert isinstance(res, MultiSweepResult)
    assert res.names == want.names == ("prefill@8", "decode")
    assert res.predicted_speedup().shape == (4,)
    np.testing.assert_allclose(res.predicted_speedup(), 1.0)
    np.testing.assert_allclose(res.predicted_speedup(),
                               want.predicted_speedup(), rtol=1e-9)


def test_compiled_steps_follow_seen_buckets():
    """Without buckets= the steps follow the buckets admitted so far; the
    capture leaves the engine's caches as they were."""
    ref, eng = _both(n_slots=2, max_len=MAX_LEN)
    reqs = [(p, 3) for p in prompts(5, 2, 6, VOCAB)]
    same_outputs(eng.run(reqs), ref.run(reqs))
    before = [{k: v.clone() for k, v in c.items()} if isinstance(c, dict)
              else None for c in eng.caches]
    assert set(eng.compiled_steps()) == set(ref.compiled_steps()) \
        == {"prefill@8", "decode"}
    assert set(eng.compiled_steps(buckets=(4, 16))) \
        == {"prefill@4", "prefill@16", "decode"}
    for c, b in zip(eng.caches, before):
        if b is not None:
            for k in b:
                assert c[k].equal(b[k])


def test_static_engine_compiled_steps():
    """The static engine gives the same bridge (one prefill shape + the
    decode step), with the flops of the reference's compiled steps."""
    from repro.compat import normalize_cost_analysis
    from repro.core import hlo

    ref_static, static = _static()
    steps = static.compiled_steps(batch_size=2, prompt_len=8)
    want = ref_static.compiled_steps(batch_size=2, prompt_len=8)
    assert set(steps) == set(want) == {"prefill@8", "decode"}
    for k, c in want.items():
        flops, _ = hlo.loop_corrected_cost(normalize_cost_analysis(c),
                                           c.as_text())
        assert steps[k].cost()["flops"] == flops
