"""The port's prefill, decode and static ``ServeEngine`` against the JAX
package's, on the CPU (reduced f32 configs, the reference's parameters
through ``params_from_jax``).

Greedy tokens equal token for token; ``prefill`` logits and caches (k, v,
conv, ssm) and ``decode_step`` logits (from the reference's caches through
``caches_from_jax``) at atol = rtol = 1e-4, the bound of
``tests/test_torch_models.py``.  Temperature draws cannot replay
``jax.random``: they are pinned to the port's own seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serve_ref import TOL, pair, prompts
from repro import configs as ref_configs
from repro.models.config import ShapeConfig as RefShape
from repro.models.factory import make_inputs as ref_inputs
from repro.serve import ContinuousEngine as RefContinuous
from repro.serve.engine import ServeEngine as RefServe
from repro_torch import configs
from repro_torch.models import make_inputs
from repro_torch.models.config import ShapeConfig
from repro_torch.models.convert import caches_from_jax
from repro_torch.models.mamba import MambaState
from repro_torch.serve import ContinuousEngine, ServeEngine, sample_logits
from repro_torch.serve.engine import DECODE_STREAM, stream_generator

ARCH = "qwen2.5-3b"
VOCAB = 256
#: The archs both packages register (a port-only arch has its own file).
ARCHS = sorted(set(configs.ARCHS) & set(ref_configs.ARCHS))


def _engines(max_len, arch=ARCH):
    ref_model, params, model = pair(arch)
    return (RefServe(model=ref_model, params=params, max_len=max_len),
            ServeEngine(model=model, max_len=max_len))


def test_greedy_generation_deterministic():
    ref, eng = _engines(48)
    prompt = prompts(1, 2, 16, VOCAB)
    out1, out2 = eng.generate(prompt, 8), eng.generate(prompt, 8)
    assert out1.shape == (2, 8) and out1.dtype == torch.int32
    assert torch.equal(out1, out2)
    np.testing.assert_array_equal(out1.numpy(),
                                  np.asarray(ref.generate(prompt, 8)))


def test_generation_matches_teacher_forcing():
    """Greedy decode through the cache == greedy argmax of the full
    forward pass fed its own outputs, and == the reference's tokens."""
    ref, eng = _engines(32)
    prompt = prompts(2, 1, 8, VOCAB)
    gen = eng.generate(prompt, 6).numpy()
    np.testing.assert_array_equal(gen, np.asarray(ref.generate(prompt, 6)))
    toks = prompt
    with torch.no_grad():
        for i in range(6):
            logits, _ = eng.model({"tokens": torch.as_tensor(toks)})
            nxt = int(logits[0, -1].argmax())
            assert nxt == int(gen[0, i]), (i, nxt, gen)
            toks = np.concatenate([toks, [[nxt]]], axis=1)


def test_generate_zero_new_tokens():
    _, eng = _engines(32)
    prompt = prompts(3, 2, 8, VOCAB)
    out = eng.generate(prompt, 0)
    assert out.shape == (2, 0) and out.dtype == torch.int32


def test_generate_eos_padding():
    """With eos_id=, a sequence that samples eos keeps it and pads the rest
    with eos, as the reference does."""
    ref, eng = _engines(32)
    prompt = prompts(4, 2, 8, VOCAB)
    plain = eng.generate(prompt, 6).numpy()
    eos = int(plain[0, 2])                     # row 0 finishes at index 2
    out = eng.generate(prompt, 6, eos_id=eos).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(ref.generate(prompt, 6, eos_id=eos)))
    for b in range(2):
        row = list(plain[b])
        if eos in row:
            j = row.index(eos)
            np.testing.assert_array_equal(out[b, :j + 1], plain[b, :j + 1])
            assert (out[b, j:] == eos).all()
        else:
            np.testing.assert_array_equal(out[b], plain[b])


def test_prefill_last_index_matches_exact_length():
    """Right-padding the prompt and reading the logits at last_index gives
    the exact-length prefill's logits, and the reference's."""
    ref_model, params, model = pair(ARCH)
    S, bucket = 6, 8
    prompt = prompts(5, 2, S, VOCAB)
    padded = np.pad(prompt, ((0, 0), (0, bucket - S)))
    with torch.no_grad():
        exact, _ = model.prefill({"tokens": torch.as_tensor(prompt)}, 16)
        bucketed, _ = model.prefill({"tokens": torch.as_tensor(padded)}, 16,
                                    last_index=[S - 1, S - 1])
    np.testing.assert_allclose(bucketed.numpy(), exact.numpy(), rtol=2e-5,
                               atol=2e-5)
    want, _ = ref_model.prefill(params, {"tokens": jnp.asarray(padded)}, 16,
                                last_index=jnp.full((2,), S - 1, jnp.int32))
    np.testing.assert_allclose(bucketed.numpy(), np.asarray(want), **TOL)


def _hold_caches(got: list, want: list) -> None:
    """The port's per-layer caches against the reference's (converted)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        names = w.keys() if isinstance(w, dict) else MambaState._fields
        for name in names:
            a = g[name] if isinstance(g, dict) else getattr(g, name)
            b = w[name] if isinstance(w, dict) else getattr(w, name)
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                       **TOL)


def _prefill_pair(name, use_kernel, B=2, S=12):
    """Both packages' prefill of the same batch: S text positions (after
    the image's, for the VLM), caches 8 positions longer."""
    ref_model, params, model = pair(name, use_kernel=use_kernel)
    ref_cfg, cfg = ref_model.cfg, model.cfg
    S += cfg.img_seq if cfg.frontend == "vision" else 0
    max_len = S + 8
    batch = make_inputs(cfg, ShapeConfig("p", "prefill", S, B), seed=1,
                        device="cpu")
    ref_batch = ref_inputs(ref_cfg, RefShape("p", "prefill", S, B),
                           abstract=False, seed=1)
    want_logits, want_caches = ref_model.prefill(params, ref_batch, max_len)
    with torch.no_grad():
        logits, caches = model.prefill(batch, max_len)
    return (S, ref_model, params, model, logits, caches,
            np.asarray(want_logits), want_caches)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_reference(name):
    *_, model, logits, caches, want_logits, want_caches = \
        _prefill_pair(name, use_kernel=False)
    assert logits.shape == want_logits.shape
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    _hold_caches(caches, caches_from_jax(model.cfg, want_caches))


@pytest.mark.parametrize("name", ["qwen2.5-3b", "falcon-mamba-7b",
                                  "jamba-v0.1-52b"])
def test_prefill_with_kernels_matches_reference(name):
    """``use_kernel`` puts prefill on the kernel wrappers (their plain
    versions on the CPU; the scan's h_final is the decode state)."""
    *_, model, logits, caches, want_logits, want_caches = \
        _prefill_pair(name, use_kernel=True, S=13)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    _hold_caches(caches, caches_from_jax(model.cfg, want_caches))


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_matches_reference(name):
    """One decode step from the reference's prefill caches (through
    ``caches_from_jax``): logits and the written caches at 1e-4."""
    pos, ref_model, params, model, _, _, _, want_caches = \
        _prefill_pair(name, use_kernel=False)
    cfg = model.cfg
    step = make_inputs(cfg, ShapeConfig("d", "decode", 1, 2), seed=2,
                       device="cpu")
    ref_step = ref_inputs(ref_model.cfg, RefShape("d", "decode", 1, 2),
                          abstract=False, seed=2)
    want, want_new = ref_model.decode_step(params, want_caches, ref_step,
                                           jnp.asarray(pos, jnp.int32))
    with torch.no_grad():
        got, new = model.decode_step(caches_from_jax(cfg, want_caches), step,
                                     pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _hold_caches(new, caches_from_jax(cfg, want_new))


@pytest.mark.parametrize("name", ["qwen2.5-3b", "jamba-v0.1-52b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_slot_batched_decode_matches_reference(name):
    """A position per row: the reference maps the single-sequence decode
    over the slots (``jax.vmap``); the port decodes them in one call with a
    (B,) position tensor.  Logits and caches at 1e-4."""
    _, ref_model, params, model, _, _, _, want_caches = \
        _prefill_pair(name, use_kernel=False, B=3)
    ref_eng = RefContinuous(model=ref_model, params=params, n_slots=3,
                            max_len=20)
    tokens = prompts(9, 3, 1, VOCAB)
    pos = np.asarray([12, 5, 0], np.int32)
    want, want_new = ref_eng._decode_slots(params, want_caches,
                                           jnp.asarray(tokens),
                                           jnp.asarray(pos))
    with torch.no_grad():
        got, new = model.decode_step(caches_from_jax(model.cfg, want_caches),
                                     {"tokens": torch.as_tensor(tokens)},
                                     torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _hold_caches(new, caches_from_jax(model.cfg, want_new))


def test_audio_decode_step():
    ref_model, params, model = pair("musicgen-medium", moe_impl="scatter")
    cfg = model.cfg
    batch = np.zeros((2, 1, cfg.frontend_dim), np.float32)
    want, _ = ref_model.decode_step(params, ref_model.init_caches(2, 16),
                                    {"frame_embeds": jnp.asarray(batch)},
                                    jnp.asarray(0, jnp.int32))
    with torch.no_grad():
        logits, _ = model.decode_step(
            model.init_caches(2, 16),
            {"frame_embeds": torch.as_tensor(batch)}, 0)
    assert logits.shape == (2, 1, cfg.n_codebooks, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


def test_sample_logits_temperature():
    logits = torch.tensor([[[0.0, 10.0, 0.0]]])
    assert int(sample_logits(logits, None, 0.0)[0, 0]) == 1
    draws = {int(sample_logits(logits, stream_generator("cpu", i, 0),
                               5.0)[0, 0]) for i in range(50)}
    assert len(draws) > 1          # high temperature actually samples


def test_temperature_same_seed_same_tokens():
    model = pair(ARCH)[2]
    eng = ServeEngine(model=model, max_len=32, temperature=1.5)
    prompt = prompts(6, 2, 8, VOCAB)
    a, b = eng.generate(prompt, 8, seed=3), eng.generate(prompt, 8, seed=3)
    assert torch.equal(a, b)
    assert not torch.equal(a, eng.generate(prompt, 8, seed=4))
    # one request on the continuous engine draws from the same streams
    cont = ContinuousEngine(model=model, n_slots=1, max_len=32,
                            temperature=1.5, seed=3)
    out, = cont.run([(prompt[0], 8)])
    np.testing.assert_array_equal(out, eng.generate(prompt[:1], 8,
                                                    seed=3)[0].numpy())


def test_temperature_to_zero_is_argmax():
    _, eng = _engines(32)
    prompt = prompts(7, 2, 8, VOCAB)
    greedy = eng.generate(prompt, 6)
    cold = ServeEngine(model=eng.model, max_len=32, temperature=1e-6)
    assert torch.equal(cold.generate(prompt, 6, seed=5), greedy)


def test_prefill_and_decode_streams_are_disjoint():
    """Prefill streams (request ids) lie below DECODE_STREAM, decode
    streams (DECODE_STREAM + step) above it; each (seed, stream) seeds its
    own generator."""
    seeds = {stream_generator("cpu", s, r).initial_seed()
             for s in range(3) for r in range(64)}
    decode = {stream_generator("cpu", s, DECODE_STREAM + i).initial_seed()
              for s in range(3) for i in range(64)}
    assert len(seeds) == len(decode) == 3 * 64 and not seeds & decode
    a = torch.rand(64, generator=stream_generator("cpu", 0, 0))
    b = torch.rand(64, generator=stream_generator("cpu", 0, DECODE_STREAM))
    assert not torch.equal(a, b)
    with pytest.raises(ValueError, match="2\\*\\*32"):
        stream_generator("cpu", 0, 1 << 32)


def test_compiled_steps_not_ported():
    """The static engine's compiled_steps (ported: the name is kept) gives
    the reference's step names, and a frontend config raises as there."""
    ref, eng = _engines(32)
    steps = eng.compiled_steps()
    assert set(steps) == set(ref.compiled_steps()) == {"prefill@32",
                                                       "decode"}
    _, audio = _engines(32, arch="musicgen-medium")
    with pytest.raises(ValueError, match="token LMs only"):
        audio.compiled_steps()


def test_prompt_beyond_max_len_raises():
    _, eng = _engines(16)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(prompts(8, 1, 12, VOCAB), 8)
