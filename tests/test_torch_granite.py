"""granite-4.0-h-small on the port (``models.mamba2``, the shared expert and
dropless routing of ``models.moe``, NoPE attention with its own scale, the
multipliers), held to its plain float32 reference
(``models.ref_granite``) on seeded random weights at a reduced size:

* the forward's logits;
* prefill into the continuous engine's slots, ragged prompts, then decode
  with a position per row, against the full forward at every step;
* the chunked Mamba-2 prefill against the one-step recurrence, across
  chunk boundaries and at lengths the chunk does not divide;
* no dropped assignment under a routing skewed onto a few experts (the
  same routing drops under a capacity);
* NoPE and the 1/128 scale;
* the spans and MoE counters, present when recording and absent when not.

The ``cuda`` cases run the forward, the engine's slots and the chunked
prefill on the card, TF32 off, against the same reference.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, spans
from repro_torch.models import (blocks, convert, layers, make_model, mamba2,
                                moe)
from repro_torch.models import ref_granite
from repro_torch.serve.scheduler import ContinuousEngine, Request

ARCH = configs.get_arch("granite-4.0-h-small")
#: 4 layers: Mamba-2 at 0-2, attention at 3; GQA 4 / 2.
CFG = ARCH.reduced(n_layers=4).replace(n_kv_heads=2, n_experts=6,
                                       experts_per_token=3)
SPANS = {"lm.decode_step", "lm.mamba2", "lm.mamba2.state", "lm.attn",
         "lm.moe"}
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture
def dev(request):
    """The device of a case: the CPU, or the card (skips without one;
    TF32 off, so that a float32 product is float32)."""
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        yield "cuda"
        torch.backends.cuda.matmul.allow_tf32 = before
    else:
        yield "cpu"


def _model(cfg=CFG, device="cpu", seed=0):
    """The model with every weight moved off its initial value (norms,
    biases and D included), so that no term is left at 1 or 0."""
    m = make_model(cfg, device=device,
                   generator=torch.Generator(device=device).manual_seed(seed))
    g = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for p in m.parameters():
            scale = 0.1 * p.abs().mean().clamp_min(0.05)
            p.add_(torch.randn(p.shape, generator=g, device=device,
                               dtype=p.dtype) * scale)
    return m


def _ref(model, tokens, last=None):
    return ref_granite.forward(tokens, convert.plain_weights(model),
                               convert.plain_cfg(model.cfg), last=last)


def _rel(a, b):
    return ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()


def test_registered_with_every_published_value():
    assert ARCH.name in configs.ARCHS and ARCH.name in configs.PORT_ONLY
    assert (ARCH.n_layers, ARCH.d_model, ARCH.n_heads, ARCH.n_kv_heads,
            ARCH.resolved_head_dim, ARCH.vocab_size) == (
                40, 4096, 32, 8, 128, 100352)
    assert (ARCH.n_experts, ARCH.experts_per_token, ARCH.d_ff,
            ARCH.shared_ff) == (72, 10, 768, 1536)
    assert (ARCH.ssm_heads, ARCH.ssm_head_dim, ARCH.ssm_state,
            ARCH.ssm_groups, ARCH.ssm_conv, ARCH.ssm_chunk,
            ARCH.d_inner) == (128, 64, 128, 1, 4, 256, 8192)
    assert (ARCH.attn_scale, ARCH.embedding_multiplier,
            ARCH.residual_multiplier, ARCH.logits_scaling) == (
                0.0078125, 12.0, 0.22, 16.0)
    assert not ARCH.rope and ARCH.tie_embeddings and ARCH.moe_dropless
    kinds = [s.mixer for s in blocks.layer_specs(ARCH)]
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [5, 15, 25, 35]
    assert set(kinds) == {"attn", "mamba2"}


def test_no_jax_counterpart_raises_clearly():
    with pytest.raises(ValueError, match="no JAX counterpart"):
        convert.reference_leaves(_model())


@pytest.mark.parametrize("dev", DEVICES, indirect=True)
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_the_reference(seed, dev):
    m = _model(device=dev, seed=seed)
    toks = torch.randint(0, CFG.vocab_size, (2, 21),
                         generator=torch.Generator().manual_seed(seed)).to(dev)
    with torch.no_grad():
        logits, _ = m({"tokens": toks, "targets": toks})
        for b in range(2):
            assert _rel(logits[b], _ref(m, toks[b])) < 1e-5


@pytest.mark.parametrize("dev", DEVICES, indirect=True)
def test_engine_slots_prefill_and_per_row_decode_match_the_reference(dev):
    """Three ragged prompts admitted one at a time into the continuous
    engine's slots, then six decode steps of all slots with a position per
    row (``release`` as the benchmark decodes), each step's logits against
    the full forward over the prompt and the tokens fed."""
    m = _model(device=dev)
    lengths, steps = [5, 17, 11], 6
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
               for n in lengths]
    with torch.inference_mode():
        eng = ContinuousEngine(m, n_slots=3, max_len=32)
        first = [eng._prefill_into_slot(Request(tokens=p, max_new_tokens=1,
                                                rid=i), i)[0, -1].argmax()
                 for i, p in enumerate(prompts)]
        tok = torch.stack(first)[:, None]
        pos = torch.tensor(lengths, device=dev)
        caches, fed, got = list(eng.caches), [], []
        for t in range(steps):
            logits, caches = m.decode_step(caches, {"tokens": tok}, pos + t,
                                           release=True)
            fed.append(tok[:, 0])
            got.append(logits[:, 0])
            tok = logits[:, 0].argmax(-1, keepdim=True)
        fed, got = torch.stack(fed, 1), torch.stack(got, 1)
        for b, p in enumerate(prompts):
            seq = torch.cat([torch.as_tensor(p, device=dev).long(), fed[b]])
            assert _rel(got[b], _ref(m, seq, last=steps)) < 1e-5
        assert all(isinstance(c, (dict, mamba2.Mamba2State)) for c in
                   eng.caches), "release must not touch the engine's list"


@pytest.mark.parametrize("dev", DEVICES, indirect=True)
@pytest.mark.parametrize("L", [7, 8, 9, 17, 24])
def test_chunked_prefill_is_the_recurrence(L, dev):
    """``mamba2_prefill`` (chunk 8) against L single steps of
    ``mamba2_decode`` from a zero state: outputs and final state."""
    m = _model(device=dev)
    p = m.stack[0]["mamba2"]
    x = torch.randn((2, L, CFG.d_model),
                    generator=torch.Generator().manual_seed(L)).to(dev)
    with torch.no_grad():
        out, state = mamba2.mamba2_prefill(p, x, CFG)
        s, steps = mamba2.init_mamba2_state(CFG, 2, dev), []
        for t in range(L):
            o, s = mamba2.mamba2_decode(p, x[:, t:t + 1], CFG, s)
            steps.append(o)
    torch.testing.assert_close(out, torch.cat(steps, 1), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(state.ssm, s.ssm, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(state.conv, s.conv, rtol=0, atol=0)


@pytest.mark.parametrize("dropless", [True, False])
def test_skewed_routing_drops_nothing_when_dropless(dropless):
    """Every token's router logits favour experts 0-2 by a wide margin
    (positive inputs, those columns raised), so they take 40 assignments
    each: the dropless MoE keeps them all and equals the reference; with
    a capacity (cf 1.25: 32 an expert) the same routing drops, and the
    counters see it."""
    cfg = CFG.replace(moe_dropless=dropless)
    m = _model(cfg)
    p = m.stack[0]["moe"]
    with torch.no_grad():
        p["router"][:, :3] += 5.0 * p["router"].abs().max()
    h = torch.randn((1, 40, cfg.d_model),
                    generator=torch.Generator().manual_seed(5)).abs() + 0.1
    before = moe.snapshot()
    with torch.no_grad():
        y, _ = moe.moe_ffn(p, h, cfg)
    n, lost = moe.since(before)
    assert n == 40 * cfg.experts_per_token
    if dropless:
        assert lost == 0
        w = {k: v.float() for k, v in convert.plain_weights(m)["layers"][0]
             .items()}
        ref = ref_granite._moe(h[0], w, convert.plain_cfg(cfg))
        assert _rel(y[0], ref) < 1e-5
    else:
        assert lost > 0


def test_nope_and_the_attention_scale():
    """No position enters q or k, and the scores are q . k / 128 (the
    softmax over a reduced head width of 16 would otherwise divide by 4)."""
    p = _model().stack[3]["attn"]
    x = torch.randn((1, 6, CFG.d_model),
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        q0, k0, _ = layers._project_qkv(p, x, CFG, torch.arange(6)[None])
        q1, k1, _ = layers._project_qkv(p, x, CFG, 100 + torch.arange(6)[None])
        assert torch.equal(q0, q1) and torch.equal(k0, k1)
        D = CFG.resolved_head_dim
        raw = (x @ p["wq"]).reshape(1, 6, CFG.n_heads, D)
        torch.testing.assert_close(q0 * D ** -0.5, raw * CFG.attn_scale,
                                   rtol=1e-6, atol=0)
        rope = CFG.replace(rope=True, attn_scale=0.0)
        q2, _, _ = layers._project_qkv(p, x, rope, 100 + torch.arange(6)[None])
        assert not torch.equal(q2, raw)


def _names(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return {e.name for e in prof.events()}


def test_spans_and_counters_when_recording_and_not():
    m = _model()
    with torch.inference_mode():
        _, caches = m.prefill({"tokens": torch.arange(9)[None] % 256}, 16)
        step = lambda: m.decode_step(caches, {"tokens": torch.zeros(
            (1, 1), dtype=torch.long)}, torch.tensor([9]))
        assert not _names(step) & SPANS
        with spans.recording():
            assert _names(step) >= SPANS
        before = moe.snapshot()
        step()
        assert moe.since(before) == (CFG.n_layers * CFG.experts_per_token, 0)
