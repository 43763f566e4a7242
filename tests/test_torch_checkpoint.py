"""The port's checkpoints against the JAX package's, both ways, on the CPU.

The layout is the reference's: ``step_XXXXXXXX/manifest.json`` plus one
``.npy`` per leaf named by its path joined with ``__``.  Cases:

* a train state (parameters, AdamW moments, the int32 count) of the
  reduced qwen2.5-3b and of jamba at 4 layers saved by the port restores in
  the JAX package bit for bit, and one saved by the JAX package restores in
  the port (and into the port's trainer) bit for bit;
* bfloat16 leaves: the port writes the same bytes as the JAX package (the
  ``'<V2'`` descr numpy gives ``ml_dtypes.bfloat16``), manifest included,
  and restores the JAX package's bfloat16 files bit for bit.  The JAX
  package's own ``restore`` cannot cast a ``'<V2'`` array to bfloat16
  ("No cast function available"), whoever wrote it: pinned as a
  reference caveat;
* ``cleanup``, ``latest_step``, ``steps`` and the async writer.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models.factory import make_model as ref_model
from repro.train import checkpoint as ref_ckpt
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro_torch import configs
from repro_torch.launch import train as launch_train
from repro_torch.models import make_model
from repro_torch.models.convert import flatten, reference_leaves, to_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import adamw_init

CASES = {"qwen2.5-3b": {}, "jamba-v0.1-52b": {"n_layers": 4}}


def _port_state(name, seed=0):
    """A port train state whose moments and count are not zero."""
    cfg = configs.get_arch(name).reduced(**CASES[name])
    gen = torch.Generator().manual_seed(seed)
    model = make_model(cfg, device="cpu", generator=gen)
    leaves = reference_leaves(model)
    state = adamw_init(leaves)
    for key in ("mu", "nu"):
        for t in state[key]:
            t.normal_(generator=gen)
    state["count"].fill_(7)
    return model, leaves, state


def _ref_state(name):
    cfg = ref_arch(name).reduced(**CASES[name])
    params = ref_model(cfg).init(jax.random.PRNGKey(3))
    opt = ref_adamw_init(params)
    opt = {"mu": jax.tree.map(lambda p: p * 0.5 + 1, params),
           "nu": jax.tree.map(lambda p: p * p, params),
           "count": opt["count"] + 9}
    return {"params": params, "opt": opt}


def _bits(x):
    x = to_numpy(x) if torch.is_tensor(x) else np.asarray(x)
    return np.atleast_1d(np.ascontiguousarray(x)).view(np.uint8)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_save_restores_in_the_jax_package(tmp_path, name):
    _, leaves, state = _port_state(name)
    tree = launch_train._tree(leaves, state)
    ckpt.save(tmp_path, 4, tree, {"step": 4})
    like = jax.eval_shape(lambda: _ref_state(name))
    restored, extra = ref_ckpt.restore(tmp_path, 4, like)
    assert extra == {"step": 4}
    got = jax.tree_util.tree_flatten_with_path(restored)[0]
    want = flatten(tree)
    assert len(got) == len(want)
    for (path, a), (port_path, b) in zip(got, want):
        keys = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        assert keys == port_path
        a = np.asarray(a)
        assert a.dtype == np.dtype(str(b.dtype).removeprefix("torch."))
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_save_restores_in_the_port(tmp_path, name):
    ref = _ref_state(name)
    ref_ckpt.save(tmp_path, 6, ref, {"step": 6})
    model, leaves, state = _port_state(name, seed=1)
    like = launch_train._tree(leaves, state)
    restored, extra = ckpt.restore(tmp_path, 6, like)
    assert extra == {"step": 6}
    want = jax.tree.leaves(ref)
    got = [v for _, v in flatten(restored)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # into the trainer's own leaves and state, as a restart loads it
    launch_train._load(leaves, state, restored)
    for leaf, b in zip(leaves, jax.tree.leaves(ref["params"])):
        np.testing.assert_array_equal(_bits(leaf.value()), _bits(b))
    for key in ("mu", "nu"):
        for t, b in zip(state[key], jax.tree.leaves(ref["opt"][key])):
            np.testing.assert_array_equal(_bits(t), _bits(b))
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 9


def _bf16_trees():
    rng = np.random.default_rng(0)
    vals = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": [rng.standard_normal((7,)).astype(np.float32),
                  np.arange(4, dtype=np.int32)]}
    ref = {"a": jnp.asarray(vals["a"], jnp.bfloat16),
           "b": [jnp.asarray(vals["b"][0]), jnp.asarray(vals["b"][1])]}
    port = {"a": torch.from_numpy(vals["a"]).to(torch.bfloat16),
            "b": [torch.from_numpy(vals["b"][0]),
                  torch.from_numpy(vals["b"][1])]}
    return ref, port


def test_bf16_leaves_cross_bit_for_bit(tmp_path):
    ref, port = _bf16_trees()
    ref_ckpt.save(tmp_path / "jax", 1, ref, {"step": 1})
    ckpt.save(tmp_path / "port", 1, port, {"step": 1})
    jax_dir = tmp_path / "jax" / "step_00000001"
    port_dir = tmp_path / "port" / "step_00000001"
    names = sorted(p.name for p in jax_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    assert names == ["a.npy", "b__0.npy", "b__1.npy", "manifest.json"]
    for n in names:
        assert (jax_dir / n).read_bytes() == (port_dir / n).read_bytes(), n
    manifest = json.loads((port_dir / "manifest.json").read_text())
    assert manifest["leaves"]["a"] == {"shape": [3, 5], "dtype": "bfloat16"}
    # the port restores the JAX package's bf16 files bit for bit
    restored, _ = ckpt.restore(tmp_path / "jax", 1, port)
    assert restored["a"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_reference_cannot_restore_bf16(tmp_path):
    """Reference caveat: ``repro.train.checkpoint.restore`` casts with
    ``astype``, which numpy refuses from the ``'<V2'`` array that
    ``np.load`` gives for a bfloat16 leaf: it fails on its own files and on
    the port's alike."""
    ref, port = _bf16_trees()
    ref_ckpt.save(tmp_path / "jax", 1, ref)
    ckpt.save(tmp_path / "port", 1, port)
    like = jax.eval_shape(lambda: ref)
    for d in ("jax", "port"):
        with pytest.raises(ValueError, match="No cast function"):
            ref_ckpt.restore(tmp_path / d, 1, like)


def test_checkpoint_cleanup_and_latest(tmp_path):
    tree = {"x": torch.zeros(4)}
    assert ckpt.latest_step(tmp_path / "none") is None
    for s in (1, 2, 3, 4):
        ckpt.save(tmp_path, s, tree)
    (tmp_path / ".tmp_step_00000009_1").mkdir()      # an unfinished save
    (tmp_path / "step_00000010").mkdir()            # no manifest
    assert ckpt.steps(tmp_path) == [1, 2, 3, 4]
    ckpt.cleanup(tmp_path, keep_last=2)
    assert ckpt.steps(tmp_path) == [3, 4]
    assert ckpt.latest_step(tmp_path) == 4
    # the JAX package reads the same directory the same way
    assert ref_ckpt.steps(tmp_path) == [3, 4]


def test_async_checkpointer(tmp_path):
    tree = {"x": torch.arange(8.0), "count": torch.zeros((), dtype=torch.int32)}
    saver = ckpt.AsyncCheckpointer(tmp_path, keep_last=2)
    for step in (5, 6, 7):
        saver.save(step, tree, {"step": step})
        tree["x"].add_(1.0)          # the snapshot was taken at save()
    saver.wait()
    assert ckpt.steps(tmp_path) == [6, 7]
    restored, extra = ckpt.restore(tmp_path, 7, tree)
    assert extra == {"step": 7}
    assert torch.equal(restored["x"], torch.arange(8.0) + 2)
    assert restored["count"].dtype == torch.int32


def test_restore_rejects_a_shape_mismatch(tmp_path):
    ckpt.save(tmp_path, 1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="checkpoint shape"):
        ckpt.restore(tmp_path, 1, {"x": torch.zeros(5)})
