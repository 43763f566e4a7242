"""Shared set-up of the port's serving parity tests (``test_torch_serve``,
``_scheduler``, ``_paged``, ``_loadgen``): the JAX package's model and
initialised parameters for a reduced arch, the port's model with those
parameters loaded, and the reference tests' prompts as numpy arrays."""
import functools

import jax
import numpy as np

from repro.configs import ARCHS as REF_ARCHS
from repro.models.factory import make_model as ref_make_model
from repro_torch import configs
from repro_torch.models import make_model
from repro_torch.models.convert import params_from_jax

KEY = jax.random.PRNGKey(0)
#: The bound of ``tests/test_torch_models.py`` on logits and caches.
TOL = dict(atol=1e-4, rtol=1e-4)
#: ``ServeStats`` fields that are host wall times (not compared).
WALL = ("wall_s", "tok_s")


@functools.lru_cache(maxsize=None)
def pair(arch: str, moe_impl: str = "dense", use_kernel: bool = False):
    """(reference model, its parameters, the port's model on the CPU with
    those parameters) of ``arch``'s reduced config."""
    ref_model = ref_make_model(REF_ARCHS[arch].reduced(), moe_impl=moe_impl)
    params = ref_model.init(KEY)
    cfg = configs.get_arch(arch).reduced()
    model = make_model(cfg, use_kernel=use_kernel, moe_impl=moe_impl,
                       device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray,
                                                            params)))
    return ref_model, params, model


def prompts(key: int, b: int, s: int, vocab: int) -> np.ndarray:
    """The reference tests' prompts: ``jax.random.randint`` of ``(b, s)``
    under ``PRNGKey(key)``, as int32 numpy."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(key), (b, s), 0,
                                         vocab), dtype=np.int32)


def same_outputs(got, want) -> None:
    """Two engines' outputs, request for request, token for token."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def same_stats(port_engine, ref_engine) -> None:
    """Equal ``ServeStats`` counters and ``step_weights``."""
    got, want = port_engine.stats.as_dict(), ref_engine.stats.as_dict()
    for k in WALL:
        got.pop(k), want.pop(k)
    assert got == want
    assert port_engine.step_weights() == ref_engine.step_weights()
