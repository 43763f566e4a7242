"""The paper's two apps in the port against the JAX package: the 2D stencil
and HPCG over stacked ranks with both communication backends, the HPCG
spec's bundles, and both apps' validation rows.

The JAX programs need a mesh of 4 host devices, so they run once per module
in a subprocess with ``XLA_FLAGS`` set before jax starts (as
``test_distributed.py`` does) and hand their arrays back in an ``.npz``.

Bounds, with their reasons:
  * stencil: atol 1e-6 / rtol 1e-6, the JAX test's own bound; the port's
    two backends agree bit for bit (they move the same values);
  * HPCG ``apply_a``: rtol 1e-6 against the JAX oracle
    ``reference_apply_a``.  Against the JAX ``shard_map`` program, rtol 1e-6
    with atol 4e-6: XLA reorders that program's f32 sum, which puts it one
    ulp at |y| of about 35 (3.8e-6) away from its own oracle;
  * one ``v_cycle``: rtol 1e-5 with atol 1e-8 (three ulps of its largest
    value, 0.044): the restriction's mean and the fused sums reduce in
    another order;
  * ``make_cg(n_iter=30)``: x within atol 1e-4 of JAX, and max |x - 1| below
    1e-2 as in ``test_hpcg_cg_converges_distributed``;
  * validation rows: equal, except ``overhead_breakdown``'s sums at rtol
    1e-12, the port's physics bound (``test_torch_physics.py``): its float64
    torch terms differ from NumPy's in the last bit.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.apps.hpcg import validation as ref_hpcg_val
from repro.apps.hpcg.spec import HpcgConfig as RefHpcgConfig
from repro.apps.hpcg.spec import build_spec as ref_hpcg_spec
from repro.apps.stencil import validation as ref_stencil_val
from repro.memsim import collect as ref_collect
from repro_torch.apps.hpcg import torch_impl as hpcg
from repro_torch.apps.hpcg import validation as hpcg_val
from repro_torch.apps.hpcg.spec import HpcgConfig, build_spec, halo_calls
from repro_torch.apps.stencil import torch_impl as stencil
from repro_torch.apps.stencil import validation as stencil_val
from repro_torch.comm import grid_mesh
from repro_torch.memsim import collect

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ("message_based", "message_free")

_JAX = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.comm.topology import grid_mesh
from repro.apps.stencil import jax_impl as st
from repro.apps.hpcg import jax_impl as hp
x = np.load(sys.argv[1])["x"]
out = {}
plane = st.init_plane(32, 32)
ref = plane
for _ in range(5):
    ref = st.reference_step(ref)
out["stencil_ref"] = np.asarray(ref)
mesh = grid_mesh(2, 2)
zmesh = jax.make_mesh((4,), ("z",))
b = hp.make_problem((16, 16, 16))
for k in ("message_based", "message_free"):
    out["stencil_" + k] = np.asarray(st.make_runner(mesh, k)(plane, 5))
    for name, fn in (("apply_a", hp.apply_a), ("v_cycle", hp.v_cycle)):
        f = jax.jit(shard_map(lambda blk, fn=fn, k=k: fn(blk, "z", k),
                              mesh=zmesh, in_specs=P("z"), out_specs=P("z")))
        out[f"{name}_{k}"] = np.asarray(f(x))
    xx, res = hp.make_cg(zmesh, k, n_iter=30)(b, jnp.zeros_like(b))
    out["cg_" + k] = np.asarray(xx)
    out["res_" + k] = np.asarray(res)
out["reference_apply_a"] = np.asarray(hp.reference_apply_a(x))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The HPCG input and the JAX package's outputs, from one subprocess."""
    tmp = tmp_path_factory.mktemp("apps")
    x = np.random.default_rng(0).uniform(-1, 1, (16, 16, 16)) \
        .astype(np.float32)
    np.savez(tmp / "in.npz", x=x)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX),
                           str(tmp / "in.npz"), str(tmp / "out.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return x, dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def stencil_runs():
    grid = grid_mesh(2, 2, device="cpu")
    plane = stencil.init_plane(32, 32, device="cpu")
    return {k: stencil.make_runner(grid, k)(plane, 5) for k in BACKENDS}


@pytest.fixture(scope="module")
def cg_runs():
    grid = grid_mesh(4, device="cpu")
    b = hpcg.make_problem((16, 16, 16), device="cpu")
    return {k: hpcg.make_cg(grid, k, n_iter=30)(b, torch.zeros_like(b))
            for k in BACKENDS}


# ------------------------------------------------------------ stencil

@pytest.mark.parametrize("backend", BACKENDS)
def test_stencil_matches_reference(ref, stencil_runs, backend):
    out = stencil_runs[backend].numpy()
    for key in ("stencil_" + backend, "stencil_ref"):
        np.testing.assert_allclose(out, ref[1][key], atol=1e-6, rtol=1e-6,
                                   err_msg=key)


def test_stencil_backends_bit_identical(stencil_runs):
    assert torch.equal(stencil_runs["message_based"],
                       stencil_runs["message_free"])


def test_stencil_reference_step_matches_reference(ref):
    plane = stencil.init_plane(32, 32, device="cpu")
    for _ in range(5):
        plane = stencil.reference_step(plane)
    np.testing.assert_allclose(plane.numpy(), ref[1]["stencil_ref"],
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("px,py", [(4, 2), (2, 4), (4, 4), (1, 1)])
def test_stencil_other_grids_match_reference_step(px, py, backend):
    """On a 2 x 2 grid rank i-1 and i+1 coincide; wider grids tell the
    halo directions apart (bound as above)."""
    plane = stencil.init_plane(32, 32, device="cpu")
    out = stencil.make_runner(grid_mesh(px, py, device="cpu"), backend)(
        plane, 5)
    for _ in range(5):
        plane = stencil.reference_step(plane)
    np.testing.assert_allclose(out.numpy(), plane.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_stencil_step_checks_its_grid():
    step = stencil.make_step(grid_mesh(2, 2, device="cpu"))
    with pytest.raises(ValueError, match="not on a 2x2 grid"):
        step(torch.zeros(4, 1, 3, 3))
    with pytest.raises(ValueError, match="unknown backend"):
        stencil.make_step(grid_mesh(2, 2, device="cpu"), "mpi")


# --------------------------------------------------------------- HPCG

def _slabs(x):
    return hpcg.to_slabs(x, 4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_hpcg_apply_a_matches_reference(ref, backend):
    x, out = ref
    y = hpcg.from_slabs(hpcg.apply_a(_slabs(x), backend)).numpy()
    np.testing.assert_allclose(y, out["reference_apply_a"], rtol=1e-6)
    np.testing.assert_allclose(y, out["apply_a_" + backend], rtol=1e-6,
                               atol=4e-6)
    np.testing.assert_array_equal(
        y, hpcg.reference_apply_a(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_hpcg_v_cycle_matches_reference(ref, backend):
    x, out = ref
    v = hpcg.from_slabs(hpcg.v_cycle(_slabs(x), backend)).numpy()
    np.testing.assert_allclose(v, out["v_cycle_" + backend], rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("backend", BACKENDS)
def test_hpcg_cg_matches_reference(ref, cg_runs, backend):
    x, res = cg_runs[backend]
    assert x.shape == (16, 16, 16) and res.ndim == 0
    np.testing.assert_allclose(x.numpy(), ref[1]["cg_" + backend], atol=1e-4)
    assert float((x - 1.0).abs().max()) < 1e-2
    assert np.isfinite(float(res))


def test_hpcg_backends_bit_identical(cg_runs):
    (xa, ra), (xb, rb) = cg_runs["message_based"], cg_runs["message_free"]
    assert torch.equal(xa, xb) and torch.equal(ra, rb)


def test_hpcg_multigrid_acts_on_the_local_shape(monkeypatch):
    """restrict/prolong keep the rank axis; v_cycle's depth test reads the
    per-rank shape, so 8 ranks of 8^3 recurse as one rank of 8^3 does."""
    rng = np.random.default_rng(3)
    blocks = torch.from_numpy(rng.normal(size=(8, 5, 6, 7)))
    coarse = hpcg.restrict(blocks)
    assert coarse.shape == (8, 2, 3, 3)
    torch.testing.assert_close(coarse[3], blocks[3, :4, :6, :6].reshape(
        2, 2, 3, 2, 3, 2).mean(dim=(1, 3, 5)), rtol=0, atol=0)
    fine = hpcg.prolong(coarse, (4, 5, 6))
    assert fine.shape == (8, 4, 5, 6)
    assert torch.equal(fine[3, 3, 4], coarse[3, 1, 2].repeat_interleave(2))
    calls = []
    orig = hpcg.restrict
    monkeypatch.setattr(hpcg, "restrict",
                        lambda b: calls.append(b.shape) or orig(b))
    hpcg.v_cycle(torch.zeros(8, 8, 8, 8), "message_based")
    assert calls == [(8, 8, 8, 8), (8, 4, 4, 4)]


def test_hpcg_dirichlet_ends():
    """Rank 0 receives no plane from below and rank n-1 none from above."""
    blocks = torch.arange(1.0, 1 + 3 * 2 * 2 * 2).reshape(3, 2, 2, 2)
    for backend in BACKENDS:
        below, above = hpcg._exchange(blocks, backend)
        assert torch.equal(below[0], torch.zeros(1, 2, 2))
        assert torch.equal(above[-1], torch.zeros(1, 2, 2))
        assert torch.equal(below[1, 0], blocks[0, -1])
        assert torch.equal(above[1, 0], blocks[2, 0])


# --------------------------------------------------------- validation

def _rows(rows):
    return [dataclasses.asdict(r) if dataclasses.is_dataclass(r) else r
            for r in rows]


@pytest.mark.parametrize("name,port,jax_fn", [
    ("stencil.run_validation", stencil_val.run_validation,
     ref_stencil_val.run_validation),
    ("stencil.multinode_prediction", stencil_val.multinode_prediction,
     ref_stencil_val.multinode_prediction),
    ("hpcg.run_validation", hpcg_val.run_validation,
     ref_hpcg_val.run_validation)])
def test_validation_rows_equal_reference(name, port, jax_fn):
    assert _rows(port()) == _rows(jax_fn())


def test_multinode_prediction_optimistic_equals_reference():
    assert stencil_val.multinode_prediction(optimistic=True) == \
        ref_stencil_val.multinode_prediction(optimistic=True)


@pytest.mark.parametrize("port,jax_fn", [
    (stencil_val.overhead_breakdown, ref_stencil_val.overhead_breakdown),
    (hpcg_val.overhead_breakdown, ref_hpcg_val.overhead_breakdown)])
def test_overhead_breakdown_matches_reference(port, jax_fn):
    got, want = port(), jax_fn()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, float):
                assert g[k] == pytest.approx(v, rel=1e-12, abs=0), k
            else:
                assert g[k] == v, k


@pytest.mark.parametrize("nx", [16, 64, 128, 256])
def test_hpcg_collect_matches_reference(nx):
    """HPCG bundles (with the ``unpack=True`` halo buffers) are
    byte-identical to the reference's for the same spec and seed."""
    cfg, rcfg = HpcgConfig(nx=nx), RefHpcgConfig(nx=nx)
    kw = dict(network=hpcg_val.NETWORK, seed=0, bw_share=cfg.bw_share,
              ranks_per_socket=cfg.ranks_per_socket)
    port = collect(build_spec(cfg), **kw)
    rkw = dict(kw, network=ref_hpcg_val.NETWORK)
    ref = ref_collect(ref_hpcg_spec(rcfg), **rkw)
    for a, b in ((port.samples_csv(), ref.samples_csv()),
                 (port.comms_csv(), ref.comms_csv()),
                 (port.counters_json(), ref.counters_json())):
        assert a == b
    assert set(port.call_sites) == set(halo_calls())
    assert all(site.unpack for site in port.call_sites.values())
