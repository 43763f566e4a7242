"""The port's loss and gradients against ``jax.value_and_grad`` of the JAX
package's ``model.loss``, on the CPU, for every reduced arch.

Parameters are the reference's, carried across by ``params_from_jax``;
the batch is ``make_inputs`` (bit-identical on both sides), B = 4, S = 32.
The port's gradients come from ``train.loop.loss_and_grads`` over the
reference's leaves, so a stack gradient is one ``(n_blocks, ...)`` leaf as
in ``jax.grad``.  Cases: ``moe_impl`` dense and scatter (MoE archs), the
port's ``remat`` on and off against the reference's (the same function;
``remat`` on both sides for three archs), one microbatch and two
(``n_micro = 2``: the reference's strided split, each microbatch's
gradients added in float32, then divided by 2).

Bounds (float32): loss at rtol 1e-5; each gradient leaf at rtol 1e-4 with
an atol of 1e-4 times the leaf's largest magnitude (entries near zero are
sums of terms that cancel, rounded in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import get_arch as ref_arch
from repro.models.config import ShapeConfig as RefShape
from repro.models.factory import make_inputs as ref_inputs
from repro.models.factory import make_model as ref_model
from repro.train.loop import _split_microbatches
from repro_torch import configs
from repro_torch.models import make_inputs, make_model
from repro_torch.models.config import ShapeConfig
from repro_torch.models.convert import params_from_jax, reference_leaves
from repro_torch.train.loop import loss_and_grads

#: The archs both packages register (a port-only arch has its own file).
ARCHS = sorted(set(configs.ARCHS) & set(ref_configs.ARCHS))
MOE = [a for a in ARCHS if configs.get_arch(a).n_experts]
REMAT_BOTH = ["qwen2.5-3b", "falcon-mamba-7b", "jamba-v0.1-52b"]
MICRO = [("qwen2.5-3b", "dense"), ("jamba-v0.1-52b", "scatter"),
         ("phi3.5-moe-42b-a6.6b", "scatter"), ("internvl2-2b", "dense")]
B, S = 4, 32
RTOL_LOSS, RTOL_GRAD = 1e-5, 1e-4


def _cfg(name, remat=False):
    return ref_arch(name).reduced().replace(remat=remat)


@functools.lru_cache(maxsize=None)
def _reference(name, moe_impl, remat=False, n_micro=1):
    """(numpy params, numpy batch, loss, [grad leaves]) of the reference."""
    cfg = _cfg(name, remat)
    model = ref_model(cfg, moe_impl=moe_impl)
    params = _params(name)
    batch = ref_inputs(cfg, RefShape("t", "train", S, B), abstract=False)
    vg = jax.jit(jax.value_and_grad(model.loss))
    if n_micro == 1:
        loss, grads = vg(params, batch)
    else:
        micro = _split_microbatches(batch, n_micro)
        loss = jnp.zeros((), jnp.float32)
        grads = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                             params)
        for j in range(n_micro):
            mb = jax.tree.map(lambda x: x[j], micro)
            lj, gj = vg(params, mb)
            loss = loss + lj
            grads = jax.tree.map(lambda a, g: a + g.astype(jnp.float32),
                                 grads, gj)
        loss = loss / n_micro
        grads = jax.tree.map(lambda g: g / n_micro, grads)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@functools.lru_cache(maxsize=None)
def _params(name):
    params = ref_model(_cfg(name)).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _port(name, moe_impl, remat, n_micro=1):
    cfg = configs.get_arch(name).reduced().replace(remat=remat)
    model = make_model(cfg, moe_impl=moe_impl, device="cpu")
    model.load_state_dict(params_from_jax(cfg, _params(name)))
    batch = make_inputs(cfg, ShapeConfig("t", "train", S, B), device="cpu")
    leaves = reference_leaves(model)
    loss, grads = loss_and_grads(model.loss, leaves, batch, n_micro)
    return float(loss), [g.float().numpy() for g in grads]


def _hold(got, want):
    loss, grads = got
    ref_loss, ref_grads = want
    np.testing.assert_allclose(loss, ref_loss, rtol=RTOL_LOSS)
    assert len(grads) == len(ref_grads)
    for g, w in zip(grads, ref_grads):
        assert g.shape == w.shape
        scale = float(np.max(np.abs(w))) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=RTOL_GRAD,
                                   atol=RTOL_GRAD * scale)
    assert any(np.any(w) for w in ref_grads)


@pytest.mark.parametrize("name,moe_impl", [(a, "dense") for a in ARCHS]
                         + [(a, "scatter") for a in MOE])
def test_loss_and_grads_match_reference(name, moe_impl):
    want = _reference(name, moe_impl)
    for remat in (False, True):
        _hold(_port(name, moe_impl, remat), want)


@pytest.mark.parametrize("name", REMAT_BOTH)
def test_remat_on_both_sides(name):
    moe_impl = "scatter" if name in MOE else "dense"
    _hold(_port(name, moe_impl, True),
          _reference(name, moe_impl, remat=True))


@pytest.mark.parametrize("name,moe_impl", MICRO)
def test_microbatch_grads_match_reference(name, moe_impl):
    """Two microbatches, strided: rows 0, 2 and rows 1, 3."""
    _hold(_port(name, moe_impl, True, n_micro=2),
          _reference(name, moe_impl, n_micro=2))


def test_remat_keeps_less_for_backward():
    """Under grad, ``remat`` keeps only each pattern period's input for the
    backward pass, and the scan keeps its state at chunk boundaries only
    (128 steps): fewer saved bytes, the same gradients (up to the order in
    which the backward pass adds a tensor's gradient contributions)."""
    from torch.autograd.graph import saved_tensors_hooks

    def saved_bytes(remat, seq):
        cfg = configs.get_arch("falcon-mamba-7b").reduced(n_layers=4) \
            .replace(remat=remat)
        model = make_model(cfg, device="cpu")
        batch = make_inputs(cfg, ShapeConfig("t", "train", seq, 2),
                            device="cpu")
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t
        with saved_tensors_hooks(pack, lambda t: t):
            loss = model.loss(batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return total[0], grads

    plain, g_plain = saved_bytes(False, 256)
    remat, g_remat = saved_bytes(True, 256)
    assert remat < plain / 4, (remat, plain)
    for a, b in zip(g_plain, g_remat):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(a.abs().max()))


def test_selective_scan_is_the_plain_scan_checkpointed():
    """Under grad the plain path runs ``selective_scan``: the values of
    ``mamba_scan_ref`` bit for bit (a length of 2 chunks and a ragged one),
    with less kept for the backward pass than the unchunked recurrence."""
    from torch.autograd.graph import saved_tensors_hooks

    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    from repro_torch.models.mamba import SCAN_CHUNK, selective_scan

    rng = np.random.default_rng(0)
    for L in (2 * SCAN_CHUNK, 77):
        x, dt = (torch.from_numpy(rng.standard_normal((2, L, 8),
                                                      dtype=np.float32))
                 for _ in range(2))
        dt = torch.nn.functional.softplus(dt)
        Bt, Ct = (torch.from_numpy(rng.standard_normal((2, L, 4),
                                                       dtype=np.float32))
                  for _ in range(2))
        A = -torch.rand(8, 4) - 0.5
        D = torch.ones(8)
        inputs = [t.requires_grad_() for t in (x, dt, Bt, Ct)]
        sizes = {}
        outs = {}
        for fn in (mamba_scan_ref, selective_scan):
            total = [0]

            def pack(t, total=total):
                total[0] += t.numel() * t.element_size()
                return t
            with saved_tensors_hooks(pack, lambda t: t):
                y, h = fn(*inputs, A, D)
            sizes[fn.__name__] = total[0]
            outs[fn.__name__] = (y, h, torch.autograd.grad(
                (y.sum() + h.sum()), inputs))
        for a, b in zip(outs["mamba_scan_ref"][:2],
                        outs["selective_scan"][:2]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for a, b in zip(outs["mamba_scan_ref"][2],
                        outs["selective_scan"][2]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        if L == 2 * SCAN_CHUNK:
            assert sizes["selective_scan"] < sizes["mamba_scan_ref"] / 4, \
                sizes
