"""The port's train step, data pipeline and restart against the JAX
package's, on the CPU.

* ``make_train_step`` against the reference's jitted one: 1 and 3 steps,
  ``n_micro`` 1 and 2 (the strided split), AdamW and Adafactor, on the
  reduced qwen2.5-3b (dense) and jamba at 4 layers (scatter MoE), from the
  reference's parameters and on the reference's own batches
  (``SyntheticTask.batch`` carried across as numpy).  Bounds: loss at rtol
  1e-5, ``grad_norm`` at rtol 1e-4 (the gradients' bound,
  ``test_torch_grads.py``), ``lr`` at rtol 1e-6; parameters: every entry
  within 2 x the summed learning rates of the reference's (the first
  update of either optimizer is ``lr * g / |g|``, so a gradient near zero
  whose sign differs between the frameworks moves its entry by 2 lr), and
  at least 99% of all entries within rtol 1e-3 of the reference's update
  (with an atol of 1e-6 of the leaf's magnitude).  Whole leaves can sit at
  the 2 lr bound: the key bias's gradient is zero in exact arithmetic (the
  softmax ignores a shift common to all keys of a query), so its first
  update is the sign of rounding noise on either side.
* ``SyntheticTask``: deterministic and stateless, tokens in the
  vocabulary, the reference's keys, shapes and dtypes for each frontend
  (its tokens are drawn with numpy, so they differ from the reference's).
* ``launch.train.train``: the restart resumes the exact stream (bit for
  bit on the CPU), the loss falls, one microbatch against four.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models.config import ShapeConfig as RefShape
from repro.models.factory import make_model as ref_model
from repro.train import data as ref_data
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt
from repro_torch import configs
from repro_torch.launch.train import train
from repro_torch.models import make_inputs, make_model
from repro_torch.models.config import ShapeConfig
from repro_torch.models.convert import params_from_jax, reference_leaves
from repro_torch.train import optimizer as opt
from repro_torch.train.data import make_data
from repro_torch.train.loop import make_train_step

CASES = {"qwen2.5-3b": ({}, "dense"),
         "jamba-v0.1-52b": ({"n_layers": 4}, "scatter")}
SHAPE = (32, 4)                         # seq, batch
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _cfg(pkg_arch, name):
    return pkg_arch(name).reduced(**CASES[name][0])


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    params = ref_model(_cfg(ref_arch, name)).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _reference(name, optimizer, n_micro, n_steps=3):
    """([(params after, loss, gnorm, lr) per step], batches) of the
    reference's jitted train step, all numpy (three steps, shared by the
    one-step case)."""
    cfg = _cfg(ref_arch, name)
    model = ref_model(cfg, moe_impl=CASES[name][1])
    data = ref_data.make_data(cfg, RefShape("t", "train", *SHAPE), seed=5)
    params = jax.tree.map(jnp.asarray, _ref_params(name))
    state = (ref_opt.adamw_init if optimizer == "adamw"
             else ref_opt.adafactor_init)(params)
    step = jax.jit(ref_loop.make_train_step(
        model.loss, ref_opt.AdamWConfig(**OPT), n_micro=n_micro,
        optimizer=optimizer))
    out, batches = [], []
    for i in range(n_steps):
        batch = data.batch(i)
        batches.append(jax.tree.map(np.asarray, batch))
        params, state, m = step(params, state, batch)
        out.append(([np.asarray(x) for x in jax.tree.leaves(params)],
                    float(m.loss), float(m.grad_norm), float(m.lr)))
    return out, batches


def _hold_params(got, before, want, lr_sum):
    n_close = n_all = 0
    for g, b, w in zip(got, before, want):
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        diff = np.abs(g - w)
        assert float(diff.max(initial=0.0)) <= 2 * lr_sum + 1e-6 * scale
        n_close += int((diff <= 1e-3 * np.abs(w - b) + 1e-6 * scale).sum())
        n_all += diff.size
    assert n_close >= 0.99 * n_all, n_close / n_all


STEP_CASES = [("qwen2.5-3b", o, m, n) for o in ("adamw", "adafactor")
              for m in (1, 2) for n in (1, 3)] \
    + [("jamba-v0.1-52b", "adamw", 2, n) for n in (1, 3)]


@pytest.mark.parametrize("name,optimizer,n_micro,n_steps", STEP_CASES)
def test_train_step_matches_reference(name, optimizer, n_micro, n_steps):
    want, batches = _reference(name, optimizer, n_micro)
    want, batches = want[:n_steps], batches[:n_steps]
    cfg = _cfg(configs.get_arch, name)
    model = make_model(cfg, moe_impl=CASES[name][1], device="cpu")
    model.load_state_dict(params_from_jax(cfg, _ref_params(name)))
    leaves = reference_leaves(model)
    state = (opt.adamw_init if optimizer == "adamw"
             else opt.adafactor_init)(leaves)
    step = make_train_step(model.loss, opt.AdamWConfig(**OPT),
                           n_micro=n_micro, optimizer=optimizer)
    before = [np.asarray(x) for x in jax.tree.leaves(_ref_params(name))]
    lr_sum = 0.0
    for batch, (ref_params, loss, gnorm, lr) in zip(batches, want):
        batch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        leaves, state, m = step(leaves, state, batch)
        np.testing.assert_allclose(float(m.loss), loss, rtol=1e-5)
        np.testing.assert_allclose(float(m.grad_norm), gnorm, rtol=1e-4)
        np.testing.assert_allclose(float(m.lr), lr, rtol=1e-6)
        lr_sum += lr
    _hold_params([leaf.value().numpy() for leaf in leaves], before,
                 want[-1][0], lr_sum)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("name", ["qwen2.5-3b", "internvl2-2b",
                                  "musicgen-medium"])
def test_data_matches_reference_contract(name):
    """The keys, shapes and dtypes of each frontend's batch are the
    reference's; tokens and targets stay in the vocabulary."""
    shape = (RefShape("t", "train", 48, 4), ShapeConfig("t", "train", 48, 4))
    want = ref_data.make_data(ref_arch(name).reduced(), shape[0],
                              seed=1).batch(3)
    cfg = configs.get_arch(name).reduced()
    got = make_data(cfg, shape[1], seed=1, device="cpu").batch(3)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype)
    for k in ("tokens", "targets"):
        if k in got:
            assert int(got[k].min()) >= 0
            assert int(got[k].max()) < cfg.vocab_size


def test_data_deterministic_and_stateless():
    cfg = configs.get_arch("qwen2.5-3b").reduced()
    shape = ShapeConfig("t", "train", 64, 8)
    d1 = make_data(cfg, shape, seed=3, device="cpu")
    d2 = make_data(cfg, shape, seed=3, device="cpu")
    b7 = d1.batch(7)
    d1.batch(8)                                  # no iterator state
    for k, v in b7.items():
        assert torch.equal(v, d2.batch(7)[k])
    assert not torch.equal(b7["tokens"], d1.batch(8)["tokens"])
    assert not torch.equal(
        b7["tokens"], make_data(cfg, shape, seed=4, device="cpu")
        .batch(7)["tokens"])
    # next-token pairs of templates: targets are the tokens shifted by one
    assert torch.equal(b7["tokens"][:, 1:], b7["targets"][:, :-1])


def test_data_is_on_the_card_unless_asked():
    cfg = configs.get_arch("qwen2.5-3b").reduced()
    data = make_data(cfg, ShapeConfig("t", "train", 8, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            data.batch(0)


# ------------------------------------------------------------- the driver
def test_restart_resumes_exact_stream(tmp_path, capsys):
    """Fault-tolerance contract: restore + deterministic data reproduce
    the uninterrupted run exactly."""
    cfg = configs.get_arch("qwen2.5-3b").reduced()
    shape = ShapeConfig("t", "train", 32, 4)
    ref, hist_ref = train(cfg, shape, 9, ckpt_dir=None, log_every=1,
                          device="cpu")
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        train(cfg, shape, 9, ckpt_dir=tmp_path, ckpt_every=3, log_every=1,
              fail_at_step=5, device="cpu")
    resumed, hist = train(cfg, shape, 9, ckpt_dir=tmp_path, ckpt_every=3,
                          log_every=1, device="cpu")
    assert "[train] restored step 3, resuming at 4" in capsys.readouterr().out
    assert [h["step"] for h in hist] == list(range(4, 9))
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist_ref[4:]]
    want = ref.state_dict()
    for k, v in resumed.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_loss_decreases():
    cfg = configs.get_arch("qwen2.5-3b").reduced()
    _, hist = train(cfg, ShapeConfig("t", "train", 64, 8), 40,
                    opt_cfg=opt.AdamWConfig(lr=3e-3, warmup_steps=5,
                                            total_steps=40),
                    log_every=39, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.1


def test_microbatch_equivalence():
    """n_micro=1 vs n_micro=4 give (nearly) the same update (the
    reference's bounds)."""
    cfg = configs.get_arch("qwen2.5-3b").reduced()
    shape = ShapeConfig("t", "train", 64, 8)
    batch = make_inputs(cfg, shape, device="cpu")
    out = []
    for n_micro in (1, 4):
        model = make_model(cfg, moe_impl="dense", device="cpu")
        leaves = reference_leaves(model)
        step = make_train_step(model.loss,
                               opt.AdamWConfig(lr=1e-3, warmup_steps=0),
                               n_micro=n_micro)
        _, _, m = step(leaves, opt.adamw_init(leaves), batch)
        out.append((float(m.loss), [leaf.value() for leaf in leaves]))
    assert out[0][0] == pytest.approx(out[1][0], rel=2e-2)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=5e-3, rtol=5e-2)
