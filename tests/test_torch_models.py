"""The port's LM stack against the JAX package, on the CPU.

Every arch's ``reduced()`` config (float32, B = 2, S = 64): ``make_inputs``
bit-identical to the reference's, the reference's initialised parameters
loaded through ``params_from_jax``, and ``forward`` (logits, aux) and
``loss`` held against the reference's at atol = rtol = 1e-4 on logits and
rtol 1e-5 on loss and aux, with ``moe_impl`` dense and scatter, and with the
kernels on (the plain versions on the CPU; Pallas in interpret mode in the
reference) for three archs.  One bfloat16 case at 3e-2 (see
``test_bf16_forward_with_kernels``).
"""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import get_arch as ref_arch
from repro.models import moe as ref_moe
from repro.models.config import ShapeConfig as RefShape
from repro.models.factory import make_inputs as ref_inputs
from repro.models.factory import make_model as ref_model
from repro_torch import configs
from repro_torch.models import factory, layers, make_inputs, make_model, moe
from repro_torch.models.config import ShapeConfig
from repro_torch.models.convert import params_from_jax

#: The archs both packages register (a port-only arch has its own file).
ARCHS = sorted(set(configs.ARCHS) & set(ref_configs.ARCHS))
KERNEL_ARCHS = ["qwen2.5-3b", "falcon-mamba-7b", "jamba-v0.1-52b"]
LOGITS = dict(atol=1e-4, rtol=1e-4)
SCALAR = dict(rtol=1e-5, atol=0)
BF16 = 3e-2
B, S = 2, 64


def _cfgs(name, **replace):
    """(reference config, port config) of one arch, reduced."""
    return (ref_arch(name).reduced().replace(**replace),
            configs.get_arch(name).reduced().replace(**replace))


def _key(cfg, moe_impl):
    # moe_impl changes nothing without MoE layers: share the reference run
    return cfg, moe_impl if cfg.n_experts else None


@functools.lru_cache(maxsize=None)
def _reference(cfg, moe_impl, use_kernel):
    """(numpy params, logits, aux, loss, param count, active param count)
    of the reference's model."""
    model = ref_model(cfg, use_kernel=use_kernel, moe_impl=moe_impl or
                      "scatter")
    params = model.init(jax.random.PRNGKey(0))
    batch = ref_inputs(cfg, RefShape("t", "train", S, B), abstract=False)
    logits, aux = model.forward(params, batch)
    loss = model.loss(params, batch)
    return (jax.tree.map(np.asarray, params), np.asarray(logits, np.float32),
            float(aux), float(loss), model.param_count(params),
            model.active_param_count(params))


def _port(cfg, params, use_kernel=False, moe_impl="scatter"):
    model = make_model(cfg, use_kernel=use_kernel, moe_impl=moe_impl,
                       device="cpu")
    model.load_state_dict(params_from_jax(cfg, params))
    batch = make_inputs(cfg, ShapeConfig("t", "train", S, B), device="cpu")
    with torch.no_grad():
        logits, aux = model(batch)
        loss = model.loss(batch)
    return model, logits.float().numpy(), float(aux), float(loss)


def _hold(ref_cfg, cfg, moe_impl, use_kernel):
    params, logits, aux, loss, _, _ = _reference(*_key(ref_cfg, moe_impl),
                                                 use_kernel)
    _, got, got_aux, got_loss = _port(cfg, params, use_kernel, moe_impl)
    assert got.shape == logits.shape
    np.testing.assert_allclose(got, logits, **LOGITS)
    np.testing.assert_allclose(got_aux, aux, **SCALAR)
    np.testing.assert_allclose(got_loss, loss, **SCALAR)


@pytest.mark.parametrize("name", ARCHS)
def test_make_inputs_bit_identical(name):
    ref_cfg, cfg = _cfgs(name)
    want = ref_inputs(ref_cfg, RefShape("t", "train", S, B), abstract=False,
                      seed=3)
    got = make_inputs(cfg, ShapeConfig("t", "train", S, B), seed=3,
                      device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16), w.view(np.uint16))
        else:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", ARCHS)
def test_params_from_jax_loads_every_leaf(name):
    ref_cfg, cfg = _cfgs(name)
    params, *_, count, active = _reference(*_key(ref_cfg, "scatter"), False)
    model = make_model(cfg, device="cpu")
    state = params_from_jax(cfg, params)
    own = model.state_dict()
    assert sorted(state) == sorted(own)
    for k, t in state.items():
        assert t.dtype == own[k].dtype and t.shape == own[k].shape, k
    model.load_state_dict(state)
    assert model.param_count() == count
    assert model.active_param_count() == active


@pytest.mark.parametrize("moe_impl", ["dense", "scatter"])
@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name, moe_impl):
    _hold(*_cfgs(name), moe_impl, use_kernel=False)


@pytest.mark.parametrize("name", KERNEL_ARCHS)
def test_forward_with_kernels_matches_reference(name):
    _hold(*_cfgs(name), "scatter", use_kernel=True)


@pytest.mark.parametrize("name,replace", [
    ("llama4-maverick-400b-a17b", dict(n_layers=4)),      # 2 blocks x 2
    ("jamba-v0.1-52b", dict(n_layers=4, attn_period=2, attn_offset=1)),
])
def test_deeper_stacks_map_blocks_in_depth_order(name, replace):
    """Stacks of several blocks of several layers: layer i * P + pos of the
    port is the reference's block i, position pos."""
    ref_cfg = ref_arch(name).reduced(n_layers=replace.pop("n_layers"))
    ref_cfg = ref_cfg.replace(**replace)
    cfg = configs.get_arch(name).reduced(n_layers=ref_cfg.n_layers) \
        .replace(**replace)
    _hold(ref_cfg, cfg, "scatter", use_kernel=False)


def test_bf16_forward_with_kernels():
    """jamba in bfloat16 with the kernels on, as the card runs it.

    bf16 rounds at other places in the two frameworks: XLA's fused
    elementwise ops keep float32 intermediates, PyTorch rounds after each op,
    so single logits differ by a few bf16 ulps (the reference's own kernel
    and plain paths differ by up to 3.5e-2 here).  The bound is 3e-2 on the
    loss and aux (relative) and on the logits as a whole (relative norm).
    """
    ref_cfg, cfg = _cfgs("jamba-v0.1-52b", dtype="bfloat16")
    params, logits, aux, loss, _, _ = _reference(ref_cfg, "scatter", True)
    model, got, got_aux, got_loss = _port(cfg, params, use_kernel=True)
    assert model.embed["table"].dtype == torch.bfloat16
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - logits) <= BF16 * np.linalg.norm(logits)
    np.testing.assert_allclose(got_aux, aux, rtol=BF16)
    np.testing.assert_allclose(got_loss, loss, rtol=BF16)


# ------------------------------------------------------------- MoE details
def _moe_case(router: np.ndarray, x: np.ndarray):
    """The reference's and the port's MoE params (phi3.5 reduced: 4 experts,
    top-2) with the given router, and x as both sides' tokens."""
    ref_cfg, cfg = _cfgs("phi3.5-moe-42b-a6.6b")
    jp = ref_moe.init_moe(ref_cfg, jax.random.PRNGKey(1))
    jp = {k: np.asarray(v) for k, v in jp.items()}
    jp["router"] = router.astype(np.float32)
    p = layers.Params(**{k: torch.tensor(v) for k, v in jp.items()})
    xt = x.astype(np.float32)
    return ref_cfg, cfg, {k: jnp.asarray(v) for k, v in jp.items()}, p, xt


@pytest.mark.parametrize("impl", ["dense", "scatter"])
def test_moe_ties_go_to_the_lower_expert(impl):
    """A zero router ties every expert: top-2 must pick experts 0 and 1, as
    ``lax.top_k`` does."""
    x = np.random.default_rng(0).normal(size=(32, 64))
    ref_cfg, cfg, jp, p, xt = _moe_case(np.zeros((64, 4)), x)
    _, topi, _ = moe._route(p, torch.as_tensor(xt), cfg)
    assert (topi == torch.tensor([0, 1])).all()
    ref = getattr(ref_moe, f"moe_ffn_{impl}")(jp, jnp.asarray(xt), ref_cfg)
    with torch.no_grad():
        got = getattr(moe, f"moe_ffn_{impl}")(p, torch.as_tensor(xt), cfg)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **LOGITS)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), **SCALAR)


@pytest.mark.parametrize("impl", ["dense", "scatter"])
def test_moe_capacity_drops_in_flat_order(impl):
    """Every token picks experts 0 then 1; with 64 tokens the capacity is 40
    per expert, so the assignments of tokens 40.. are dropped (ranks follow
    the flat (token, k) order) and those tokens read back zeros."""
    rng = np.random.default_rng(1)
    x = np.abs(rng.normal(size=(64, 64)))
    router = np.tile(np.array([1.0, 0.5, -1.0, -1.0]), (64, 1))
    ref_cfg, cfg, jp, p, xt = _moe_case(router, x)
    assert moe.capacity(cfg, 64) == ref_moe.capacity(ref_cfg, 64) == 40
    ref = getattr(ref_moe, f"moe_ffn_{impl}")(jp, jnp.asarray(xt), ref_cfg)
    with torch.no_grad():
        y, aux = getattr(moe, f"moe_ffn_{impl}")(p, torch.as_tensor(xt), cfg)
    assert (y[40:] == 0).all() and (y[:40] != 0).any(dim=1).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(ref[0]), **LOGITS)
    np.testing.assert_allclose(float(aux), float(ref[1]), **SCALAR)


def test_moe_ep_local_without_a_mesh_is_scatter():
    """``ep_local`` without a mesh is the scatter path, as the reference's
    ``ep_local`` without an ambient mesh (its mesh paths:
    tests/test_torch_distributed.py); per-row routing, which neither
    package has for it, raises."""
    rng = np.random.default_rng(3)
    ref_cfg, cfg, jp, p, xt = _moe_case(rng.normal(size=(64, 4)),
                                        rng.normal(size=(2, 16, 64)))
    ref = ref_moe.moe_ffn(jp, jnp.asarray(xt), ref_cfg, impl="ep_local")
    with torch.no_grad():
        y, aux = moe.moe_ffn(p, torch.as_tensor(xt), cfg, impl="ep_local")
        ys, auxs = moe.moe_ffn(p, torch.as_tensor(xt), cfg, impl="scatter")
    assert torch.equal(y, ys) and torch.equal(aux, auxs)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref[0]), **LOGITS)
    np.testing.assert_allclose(float(aux), float(ref[1]), **SCALAR)
    model = make_model(cfg, moe_impl="ep_local", device="cpu")
    batch = make_inputs(cfg, ShapeConfig("t", "train", 8, 1), device="cpu")
    with torch.no_grad():
        logits, _ = model(batch)
    assert logits.shape == (1, 8, cfg.vocab_size)
    with pytest.raises(NotImplementedError, match="ep_local"):
        moe.moe_ffn(p, torch.as_tensor(xt), cfg, impl="ep_local",
                    per_row=True)


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    for fn in (make_model, make_inputs):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_inputs(cfg, ShapeConfig("t", "train", S, B))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory.torch_device("cuda:0")
