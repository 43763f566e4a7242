"""The port's halo exchanges on stacked ranks against the JAX package's
under ``shard_map``: message-based, message-free, the halo-exchange
dispatcher on the CPU and its ppermute oracle.  The exchanges only move
values, so every comparison is exact.

The JAX side needs a mesh of 4 host devices, so it runs once per module in
a subprocess with ``XLA_FLAGS`` set before jax starts (as
``test_distributed.py`` does) and hands its arrays back in an ``.npz``.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.apps.stencil.torch_impl import from_tiles, to_tiles
from repro_torch.comm import (RankGrid, grid_mesh, message_based,
                              message_free, shift_perm)
from repro_torch.kernels.halo_exchange import (exchange_planes_1d,
                                               exchange_planes_1d_oracle)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (name, global shape, px, py): the (24, 5) arange over 4 ranks of
#: test_distributed.py, and random planes on 2 x 2 and 4 x 1 grids.
PLANES = [("arange", (24, 5), 4, 1), ("rand22", (10, 14), 2, 2),
          ("rand41", (12, 6), 4, 1)]
#: (name, global lattice shape) split into 4 z-slabs.
SLABS = [("arange", (24, 5)), ("rand3d", (12, 3, 5))]

_JAX = """
import sys
import numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.sharding import PartitionSpec as P
from repro.comm import message_based, message_free
from repro.compat import shard_map
from repro.kernels.halo_exchange import (exchange_planes_1d,
                                         exchange_planes_1d_oracle)
inputs = dict(np.load(sys.argv[1]))
out = {}
zmesh = jax.make_mesh((4,), ("z",))
fns = {"message_based": message_based.exchange_planes_1d,
       "message_free": message_free.exchange_planes_1d,
       "ops": exchange_planes_1d, "oracle": exchange_planes_1d_oracle}
for name in ("arange", "rand3d"):
    x = inputs["slab_" + name]
    for key, fn in fns.items():
        f = jax.jit(shard_map(lambda b, fn=fn: fn(b, "z"), mesh=zmesh,
                              in_specs=P("z"), out_specs=(P("z"), P("z"))))
        lo, hi = f(x)
        out[f"slab_{name}_{key}_below"] = np.asarray(lo)
        out[f"slab_{name}_{key}_above"] = np.asarray(hi)
for name, px, py in (("arange", 4, 1), ("rand22", 2, 2), ("rand41", 4, 1)):
    x = inputs["plane_" + name]
    mesh = jax.make_mesh((px, py), ("px", "py"))
    for key, comm in (("message_based", message_based),
                      ("message_free", message_free)):
        f = jax.jit(shard_map(lambda t, comm=comm: comm.exchange_halos_2d(
            t, "px", "py"), mesh=mesh, in_specs=P("px", "py"),
            out_specs=(P("px", "py"),) * 4))
        for side, h in zip("NSWE", f(x)):
            out[f"plane_{name}_{key}_{side}"] = np.asarray(h)
np.savez(sys.argv[2], **out)
"""


def _inputs():
    rng = np.random.default_rng(12)
    inputs = {"slab_arange": np.arange(4 * 6 * 5.0).reshape(24, 5),
              "slab_rand3d": rng.normal(size=(12, 3, 5)).astype(np.float32),
              "plane_arange": np.arange(4 * 6 * 5.0).reshape(24, 5)}
    for name, shape, _, _ in PLANES[1:]:
        inputs["plane_" + name] = rng.normal(size=shape).astype(np.float32)
    return inputs


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Inputs and the JAX package's outputs, from one subprocess."""
    tmp = tmp_path_factory.mktemp("comm")
    inputs = _inputs()
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX),
                           str(tmp / "in.npz"), str(tmp / "out.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return inputs, dict(np.load(tmp / "out.npz"))


CPU = torch.device("cpu")


def _slabs(x):
    return torch.from_numpy(x).reshape(4, x.shape[0] // 4, *x.shape[1:])


def _global(planes):
    """(n, 1, ...) exchanged planes -> JAX's global (n, ...) layout."""
    return planes.reshape(-1, *planes.shape[2:]).numpy()


@pytest.mark.parametrize("name", [n for n, _ in SLABS])
@pytest.mark.parametrize("key,fn", [
    ("message_based", message_based.exchange_planes_1d),
    ("message_free", message_free.exchange_planes_1d),
    ("ops", exchange_planes_1d),
    ("oracle", exchange_planes_1d_oracle)])
def test_exchange_planes_1d_matches_reference(ref, name, key, fn):
    inputs, out = ref
    below, above = fn(_slabs(inputs["slab_" + name]))
    np.testing.assert_array_equal(_global(below),
                                  out[f"slab_{name}_{key}_below"])
    np.testing.assert_array_equal(_global(above),
                                  out[f"slab_{name}_{key}_above"])


@pytest.mark.parametrize("name,shape,px,py", PLANES)
@pytest.mark.parametrize("key,comm", [("message_based", message_based),
                                      ("message_free", message_free)])
def test_exchange_halos_2d_matches_reference(ref, name, shape, px, py, key,
                                             comm):
    inputs, out = ref
    tiles = to_tiles(inputs["plane_" + name], RankGrid(px, py, CPU))
    for side, h in zip("NSWE", comm.exchange_halos_2d(tiles)):
        np.testing.assert_array_equal(from_tiles(h).numpy(),
                                      out[f"plane_{name}_{key}_{side}"],
                                      err_msg=side)


@pytest.mark.parametrize("name", [n for n, _ in SLABS])
def test_message_free_window_matches_ppermute(ref, name):
    """The shared-window emulation equals the message-based copies."""
    blocks = _slabs(ref[0]["slab_" + name])
    for a, b in zip(message_free.exchange_planes_1d(blocks),
                    message_based.exchange_planes_1d(blocks)):
        assert torch.equal(a, b)


def test_tiles_round_trip_and_layout():
    plane = torch.arange(12 * 10.0).reshape(12, 10)
    tiles = to_tiles(plane, RankGrid(3, 2, CPU))
    assert tiles.shape == (3, 2, 4, 5)
    assert torch.equal(tiles[1, 1], plane[4:8, 5:10])
    assert torch.equal(from_tiles(tiles), plane)
    with pytest.raises(ValueError, match="does not split"):
        to_tiles(plane, RankGrid(5, 2, CPU))


def test_grid_mesh_defaults_to_the_card():
    assert shift_perm(3, -1) == [(0, 2), (1, 0), (2, 1)]
    grid = grid_mesh(2, 3, device="cpu")
    assert (grid.px, grid.py, grid.size) == (2, 3, 6)
    if torch.cuda.is_available():
        assert grid_mesh(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            grid_mesh(2)
