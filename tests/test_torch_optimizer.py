"""The port's optimizer (``repro_torch.train.optimizer``) against the JAX
package's, on the CPU, on the same parameters and gradients.

Parameters are the reference's initialised ones, carried across by
``params_from_jax``; gradients are drawn per leaf with numpy from a seed.
The configs are reduced ones whose stack leaves really stack: qwen2.5-3b
(2 blocks), falcon-mamba-7b at 4 layers (4 blocks) and jamba at 4 layers (1
block of 4 positions, MoE on two).  So a per-layer norm weight is a
``(n_blocks, d)`` leaf: it takes weight decay, Adafactor factors it across
blocks and int8 gives it one scale, as in the reference.

Bounds, in float32 over three steps: ``grad_norm`` and ``lr`` at rtol
1e-6; parameters and state at rtol 1e-6 with an atol of 1e-6 times the
leaf's largest magnitude (where ``p`` and ``lr * step`` nearly cancel, the
result keeps the absolute rounding of its operands: a last-bit difference
in where the two frameworks fuse a multiply-add shows there at up to 2e-5
relative).  With bfloat16 moments, one step: the moments within one
bfloat16 step (2**-7 relative), and the update ``p_after - p_before`` at
rtol 2**-6 with the same atol.  The global norm's summation order differs,
so the clipped gradients differ in their last bit, and a few moments
(about 1 in 10,000) round to the neighbouring bfloat16, which moves their
step by up to 2**-7.  (Over later steps such a moment's difference carries
on as an absolute one, and where the next gradient cancels the moment it
is no longer small relative to it.)  int8 ``q`` and scales exact;
``cosine_schedule`` at rtol 1e-6 on every step of two schedules.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models.factory import make_model as ref_model
from repro.train import optimizer as ref_opt
from repro_torch import configs
from repro_torch.models import make_model
from repro_torch.models.convert import (flatten, params_from_jax,
                                        reference_leaves)
from repro_torch.train import optimizer as opt

CASES = {"qwen2.5-3b": {}, "falcon-mamba-7b": {"n_layers": 4},
         "jamba-v0.1-52b": {"n_layers": 4}}
RTOL = 1e-6
N_STEPS = 3
CFG = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8)


@functools.lru_cache(maxsize=None)
def _reference_params(name):
    cfg = ref_arch(name).reduced(**CASES[name])
    params = ref_model(cfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _port(name):
    """(model, its reference leaves) holding the reference's parameters."""
    cfg = configs.get_arch(name).reduced(**CASES[name])
    model = make_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, _reference_params(name)))
    return model, reference_leaves(model)


def _grads(name, step, scale=1.0):
    """numpy gradients, one per reference leaf, from a seed."""
    rng = np.random.default_rng(100 + step)
    return [(scale * rng.standard_normal(np.shape(x))).astype(np.float32)
            for x in jax.tree.leaves(_reference_params(name))]


def _tree(name, leaves):
    return jax.tree.unflatten(jax.tree.structure(_reference_params(name)),
                              [jnp.asarray(x) for x in leaves])


def _values(leaves):
    return [leaf.value().float().numpy().copy() for leaf in leaves]


def _hold(got, want, rtol=RTOL, scales=None):
    """Each leaf at ``rtol``, with an atol of 1e-6 times the leaf's largest
    magnitude (or the matching entry of ``scales``)."""
    assert len(got) == len(want)
    scales = scales or [np.asarray(w, np.float32) for w in want]
    for g, w, sc in zip(got, want, scales):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        atol = RTOL * float(np.max(np.abs(sc))) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_leaves_follow_the_reference_tree(name):
    """One leaf per reference leaf, in ``jax.tree`` order, with its shape:
    a stack leaf has a leading ``n_blocks`` axis."""
    _, leaves = _port(name)
    want = jax.tree_util.tree_flatten_with_path(_reference_params(name))[0]
    assert len(leaves) == len(want)
    for leaf, (path, x) in zip(leaves, want):
        keys = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        assert leaf.path == keys and leaf.shape == x.shape
        np.testing.assert_array_equal(leaf.value().numpy(), x)
    stacked = [leaf for leaf in leaves if leaf.stacked]
    assert stacked and all(leaf.ndim >= 2 for leaf in stacked)


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_adamw_matches_reference(name, opt_dtype):
    _, leaves = _port(name)
    state = opt.adamw_init(leaves, getattr(torch, opt_dtype))
    params = _tree(name, jax.tree.leaves(_reference_params(name)))
    ref_state = ref_opt.adamw_init(params, getattr(jnp, opt_dtype))
    cfg = ref_opt.AdamWConfig(**vars(CFG))
    bf16 = opt_dtype == "bfloat16"
    for step in range(1 if bf16 else N_STEPS):
        grads = _grads(name, step, scale=10.0 ** (step - 1))
        before, ref_before = _values(leaves), jax.tree.leaves(params)
        params, ref_state, m = ref_opt.adamw_update(
            cfg, _tree(name, grads), ref_state, params)
        _, state, got = opt.adamw_update(
            CFG, [torch.from_numpy(g) for g in grads], state, leaves)
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(got["lr"]), float(m["lr"]),
                                   rtol=1e-6)
        assert int(state["count"]) == int(ref_state["count"]) == step + 1
        after = _values(leaves)
        if bf16:
            _hold([a - b for a, b in zip(after, before)],
                  [np.asarray(a) - np.asarray(b) for a, b in
                   zip(jax.tree.leaves(params), ref_before)],
                  rtol=2.0 ** -6, scales=ref_before)
        else:
            _hold(after, jax.tree.leaves(params))
        for key in ("mu", "nu"):
            assert all(str(t.dtype) == f"torch.{opt_dtype}"
                       for t in state[key])
            _hold([t.float().numpy() for t in state[key]],
                  jax.tree.leaves(ref_state[key]),
                  2.0 ** -7 if bf16 else RTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_adafactor_matches_reference(name):
    _, leaves = _port(name)
    state = opt.adafactor_init(leaves)
    params = _tree(name, jax.tree.leaves(_reference_params(name)))
    ref_state = ref_opt.adafactor_init(params)
    cfg = ref_opt.AdamWConfig(**vars(CFG))
    for step in range(N_STEPS):
        grads = _grads(name, step)
        params, ref_state, m = ref_opt.adafactor_update(
            cfg, _tree(name, grads), ref_state, params)
        _, state, got = opt.adafactor_update(
            CFG, [torch.from_numpy(g) for g in grads], state, leaves)
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(got["lr"]), float(m["lr"]),
                                   rtol=1e-6)
        _hold(_values(leaves), jax.tree.leaves(params))
        # the factored state: (vr, vc) or (v) per leaf, in the reference's
        # flatten order (``vc`` before ``vr``)
        _hold([v.numpy() for _, v in flatten(state["v"])],
              jax.tree.leaves(ref_state["v"]))
    # a stacked per-layer vector is factored across the blocks
    vec = [i for i, leaf in enumerate(leaves) if leaf.stacked
           and leaf.ndim == 2 and "norm" in leaf.path[-1]]
    assert vec
    for i in vec:
        assert state["v"][i]["vc"].shape == leaves[i].shape[1:]


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_compression_matches_reference(name):
    """One scale per reference leaf (a stacked leaf's over all its
    blocks); ``q`` and the scales exact, the residual at rtol 1e-6."""
    grads = _grads(name, 0)
    residual = _grads(name, 1, scale=1e-3)
    q, s = opt.quantize_int8([torch.from_numpy(g) for g in grads])
    rq, rs = ref_opt.quantize_int8(_tree(name, grads))
    for a, b in zip(q, jax.tree.leaves(rq)):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(np.array([float(x) for x in s]),
                                  np.array([float(x) for x in
                                            jax.tree.leaves(rs)]))
    _hold([d.numpy() for d in opt.dequantize_int8(q, s)],
          jax.tree.leaves(ref_opt.dequantize_int8(rq, rs)))
    q, s, res = opt.compress_error_feedback(
        [torch.from_numpy(g) for g in grads],
        [torch.from_numpy(r) for r in residual])
    rq, rs, rres = ref_opt.compress_error_feedback(_tree(name, grads),
                                                   _tree(name, residual))
    for a, b in zip(q, jax.tree.leaves(rq)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(np.array([float(x) for x in s]),
                                  np.array([float(x) for x in
                                            jax.tree.leaves(rs)]))
    _hold([r.numpy() for r in res], jax.tree.leaves(rres))


@pytest.mark.parametrize("cfg", [
    opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100),
    opt.AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=37,
                    min_lr_frac=0.05)])
def test_cosine_schedule_matches_reference(cfg):
    ref_cfg = ref_opt.AdamWConfig(**vars(cfg))
    got = np.array([float(opt.cosine_schedule(cfg, s))
                    for s in range(cfg.total_steps + 3)])
    want = np.array([float(ref_opt.cosine_schedule(ref_cfg, s))
                     for s in range(cfg.total_steps + 3)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert opt.cosine_schedule(cfg, 0).dtype == torch.float32


def test_global_norm_and_clip():
    """``grad_norm`` is the global norm before clipping; a norm above
    ``clip_norm`` scales every gradient by clip / norm."""
    leaves = [torch.full((4, 4), 1.0), torch.full((9,), 2.0)]
    assert float(opt.global_norm(leaves)) == pytest.approx(
        float(np.sqrt(16 + 36)), rel=1e-7)
    from repro_torch.models.convert import Leaf
    p = Leaf(("w",), (torch.ones((4, 4)),))
    state = opt.adamw_init([p])
    cfg = opt.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0)
    _, state, m = opt.adamw_update(cfg, [torch.full((4, 4), 3.0)], state,
                                   [p])
    assert float(m["grad_norm"]) == pytest.approx(12.0)
    assert float(state["mu"][0][0, 0]) == pytest.approx(0.1 * 3.0 / 12.0)
    assert float(p.tensors[0].mean()) < 1.0
