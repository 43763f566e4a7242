"""The port's analytic roofline inputs (``repro_torch.core.analytic``)
against the JAX package's, for all ten archs at every shape: parameter
counts exact, every byte and flop figure within rtol 1e-12 (both sides do
the same float arithmetic on the same integers).  ``abstract_params``
builds the full-size model under a fake mode, so no weight is drawn."""
import functools

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.core import analytic as ref
from repro_torch import configs
from repro_torch.core import analytic as pt
from repro_torch.models import abstract_params

RTOL = 1e-12
#: The archs both packages register (a port-only arch has its own file).
ARCHS = sorted(set(configs.ARCHS) & set(ref_configs.ARCHS))
SHAPES = sorted(configs.SHAPES)
#: (dp, tp, n_micro): one chip, a 4x8 mesh with microbatches, and 2x2.
MESHES = [(1, 1, 1), (4, 8, 4), (2, 2, 2)]


@pytest.fixture(autouse=True, scope="module")
def _count_once():
    """The JAX package traces the whole model's init for every count; its
    counts depend on the config alone, so take each once."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref, "param_counts", functools.lru_cache(ref.param_counts))
    yield
    mp.undo()


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_exact(arch):
    assert pt.param_counts(configs.get_arch(arch)) \
        == ref.param_counts(ref_configs.get_arch(arch))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_figures_agree(arch, shape):
    cfg, rcfg = configs.get_arch(arch), ref_configs.get_arch(arch)
    s, rs = configs.get_shape(shape), ref_configs.get_shape(shape)
    _close(pt.model_flops(cfg, s), ref.model_flops(rcfg, rs))
    for dp, tp, n_micro in MESHES:
        _close(pt.analytic_memory(cfg, s, dp, tp, n_micro).as_dict(),
               ref.analytic_memory(rcfg, rs, dp, tp, n_micro).as_dict())
        _close(pt._cache_bytes(cfg, s, dp, tp),
               ref._cache_bytes(rcfg, rs, dp, tp))
        for fsdp in (False, True):
            for opt in ("adamw", "adafactor"):
                _close(pt.analytic_live_bytes(cfg, s, dp, tp, n_micro, fsdp,
                                              opt),
                       ref.analytic_live_bytes(rcfg, rs, dp, tp, n_micro,
                                               fsdp, opt))
        _close(pt.cell_summary(cfg, s, dp, tp, n_micro),
               ref.cell_summary(rcfg, rs, dp, tp, n_micro))


def test_abstract_params_are_meta_and_named():
    """Names, shapes and dtypes only: meta tensors, in model order, for a
    52B-parameter config."""
    params = abstract_params(configs.get_arch("jamba-v0.1-52b"))
    assert all(p.device.type == "meta" for p in params.values())
    assert sum(p.numel() for p in params.values()) == 51_570_315_264
    assert list(params)[:2] == ["final_norm", "embed.table"]
