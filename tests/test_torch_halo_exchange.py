"""The port's message-free ring exchange: the plain versions (``ref.py``)
against the JAX package's oracle, the CPU dispatch of the wrapper and of
HPCG's dispatcher, and — on a CUDA device only — the CUDA kernel against
its plain version.  The exchange moves values, so every bound is exact
equality.

The machine with the card has no jax, so the JAX package is imported only
inside a fixture; the card-only tests need none of it.
"""
import numpy as np
import pytest
import torch

from repro_torch.comm import message_based, message_free
from repro_torch.kernels.halo_exchange import ops
from repro_torch.kernels.halo_exchange import (exchange_planes_1d,
                                               exchange_planes_1d_oracle,
                                               ring_exchange_collective,
                                               ring_exchange_ref,
                                               ring_halo_exchange,
                                               ring_halo_exchange_ref)

#: Rank counts of the kernel's cases: one rank (left = right = self), two
#: (left = right), odd, HPCG's 8, and many.
RANKS = [1, 2, 3, 8, 64]
#: Per-rank block shapes (nz, ny, nx) with odd plane sizes P = ny * nx: one
#: chunk per rank, and several.
BLOCKS = [(3, 33, 31), (2, 129, 127)]


@pytest.fixture
def jax_ring_exchange_ref():
    """The JAX package's oracle — imported here so the card-only tests
    below run where jax is absent."""
    from repro.kernels.halo_exchange import ring_exchange_ref as ref
    return ref


@pytest.fixture
def cuda():
    """The CUDA device; decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _strips(n, shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, *shape)).astype(dtype)


@pytest.mark.parametrize("shape", [(7,), (4, 5)])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_ring_exchange_ref_matches_reference(jax_ring_exchange_ref, n,
                                             shape):
    strips = _strips(n, shape, seed=n)
    want = jax_ring_exchange_ref(strips)
    got = ring_exchange_ref(torch.from_numpy(strips))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [1, 2, 3, 6])
def test_plain_versions_agree(n):
    """The kernel's plain version is the oracle on (hi, lo), and the
    ppermute-style collective on a tuple gives the same planes."""
    lo = torch.from_numpy(_strips(n, (3, 4), seed=1))
    hi = torch.from_numpy(_strips(n, (3, 4), seed=2))
    from_prev, from_next = ring_halo_exchange_ref(lo, hi)
    for r in range(n):
        assert torch.equal(from_prev[r], hi[(r - 1) % n])
        assert torch.equal(from_next[r], lo[(r + 1) % n])
    (prev_hi, _), (_, next_lo) = ring_exchange_collective((hi, lo))
    assert torch.equal(prev_hi, from_prev) and torch.equal(next_lo,
                                                           from_next)


def test_cpu_wrapper_runs_the_plain_version():
    blocks = torch.from_numpy(_strips(4, (3, 5, 7), seed=3))
    before = ring_halo_exchange.launches
    got = ring_halo_exchange(blocks[:, 0], blocks[:, -1])
    want = ring_halo_exchange_ref(blocks[:, 0], blocks[:, -1])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ring_halo_exchange.launches == before


def test_cpu_dispatcher_is_the_shared_window():
    blocks = torch.from_numpy(_strips(4, (3, 5, 7), seed=4))
    before = ring_halo_exchange.launches
    for got, window, oracle in zip(exchange_planes_1d(blocks),
                                   message_free.exchange_planes_1d(blocks),
                                   exchange_planes_1d_oracle(blocks)):
        assert torch.equal(got, window) and torch.equal(got, oracle)
    assert ring_halo_exchange.launches == before


def test_no_plain_version_off_the_cpu():
    """A tensor on neither the CPU nor a CUDA device gets no kernel and no
    plain version: the wrapper and the dispatcher raise."""
    meta = torch.empty(4, 3, 5, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ring_halo_exchange(meta[:, 0], meta[:, -1])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        exchange_planes_1d(meta)
    with pytest.raises(ValueError, match="share shape"):
        ring_halo_exchange(torch.zeros(3, 4), torch.zeros(3, 5))


@pytest.mark.parametrize("n,units,want", [
    (8, 16384, 16),     # HPCG level 0 (8 x 256^2 f32 in 16-byte units)
    (8, 4096, 16),      # level 1
    (8, 1024, 4),       # level 2
    (8, 256, 1),        # level 3
    (1, 10**6, 132), (2, 10**6, 66), (3, 10**6, 44), (3, 300, 2),
    (64, 10**6, 2), (200, 10**6, 1), (8, 1, 1),
])
def test_chunk_count_is_one_wave(n, units, want):
    chunks = ops.chunk_count(n, units, 132)
    assert chunks == want
    assert n * chunks <= max(132, n)
    assert chunks <= max(1, -(-units // ops.THREADS))


def test_chunk_count_flags_route_stays_co_resident():
    assert ops.chunk_count(64, 10**6, 132, max_ctas=1056) == 2
    assert ops.chunk_count(64, 10**6, 132, max_ctas=100) == 1
    with pytest.raises(RuntimeError, match="resident at once"):
        ops.chunk_count(64, 10**6, 132, max_ctas=63)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 9, 64])
def test_route_follows_the_ring(n):
    assert ops.route_for(n) == ("cluster" if n <= ops.CLUSTER_MAX
                                else "flags")


@pytest.mark.parametrize("p,itemsize,strides,addresses,want", [
    (65536, 4, (65536 * 256, 65536 * 256), (0, 65536 * 255 * 4), True),
    (1023, 4, (1023 * 3,) * 2, (0, 4096), False),     # odd plane size
    (4096, 4, (4097, 4097), (0, 4096), False),        # rank stride
    (4096, 4, (4096, 4096), (0, 8), False),           # base address
    (4096, 8, (4097, 4097), (0, 4096), False),
    (2, 8, (2, 2), (16, 32), True),                   # f64: 16 B a strip
    (1, 8, (1, 1), (16, 32), False),
])
def test_vector_units_need_16_byte_multiples(p, itemsize, strides,
                                             addresses, want):
    assert ops.vector_ok(p, itemsize, strides, addresses) is want


def test_route_is_checked_before_the_dispatch():
    blocks = torch.from_numpy(_strips(9, (3, 5, 7), seed=6))
    with pytest.raises(ValueError, match="no route 'cluster' for 9 ranks"):
        ring_halo_exchange(blocks[:, 0], blocks[:, -1], route="cluster")
    with pytest.raises(ValueError, match="no route 'ring'"):
        ring_halo_exchange(blocks[:, 0], blocks[:, -1], route="ring")
    got = ring_halo_exchange(blocks[:, 0], blocks[:, -1], route="flags")
    want = ring_halo_exchange_ref(blocks[:, 0], blocks[:, -1])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------- on the card only

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", BLOCKS)
@pytest.mark.parametrize("n", RANKS)
def test_kernel_matches_plain(cuda, n, shape, dtype):
    """Strips read in place from ``(n, nz, ny, nx)`` blocks."""
    blocks = torch.as_tensor(_strips(n, shape, seed=n), dtype=dtype,
                             device=cuda)
    lo, hi = blocks[:, 0], blocks[:, -1]
    before = ring_halo_exchange.launches
    got = ring_halo_exchange(lo, hi)
    torch.cuda.synchronize()
    assert ring_halo_exchange.launches == before + 1
    for g, w in zip(got, ring_halo_exchange_ref(lo, hi)):
        assert g.shape == w.shape and g.dtype == dtype
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 8])
def test_kernel_many_calls_in_a_row(cuda, n):
    """50 calls on one stream reuse the flags under rising epochs."""
    blocks = torch.as_tensor(_strips(n, BLOCKS[1], seed=9), device=cuda)
    for i in range(50):
        blocks = blocks + 1.0
        got = ring_halo_exchange(blocks[:, 0], blocks[:, -1])
        want = ring_halo_exchange_ref(blocks[:, 0], blocks[:, -1])
        assert all(torch.equal(g, w) for g, w in zip(got, want)), i


def _layout(n, layout, dtype, device, seed):
    """Strips ``(n, ...)`` read in place: from blocks with an odd plane
    size, from blocks whose planes are 16-byte multiples (the vector path),
    or rows of a wider array whose rank stride is no 16-byte multiple."""
    if layout == "odd plane":
        t = torch.as_tensor(_strips(n, (3, 33, 31), seed=seed), dtype=dtype,
                            device=device)
        return t[:, 0], t[:, -1]
    if layout == "aligned":
        t = torch.as_tensor(_strips(n, (2, 64, 48), seed=seed), dtype=dtype,
                            device=device)
        return t[:, 0], t[:, -1]
    t = torch.as_tensor(_strips(n, (3, 4097), seed=seed), dtype=dtype,
                        device=device)     # rank stride 12,291 elements
    return t[:, 0, :4096], t[:, 1, 1:]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["odd plane", "aligned", "odd stride"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("route", ops.ROUTES)
def test_kernel_each_route_matches_plain(cuda, route, n, dtype, layout):
    lo, hi = _layout(n, layout, dtype, cuda, seed=n)
    if route == "cluster" and n > ops.CLUSTER_MAX:
        with pytest.raises(ValueError, match="no route"):
            ring_halo_exchange(lo, hi, route=route)
        return
    before = dict(ring_halo_exchange.route_launches)
    got = ring_halo_exchange(lo, hi, route=route)
    torch.cuda.synchronize()
    assert ring_halo_exchange.route_launches[route] == before[route] + 1
    for g, w in zip(got, ring_halo_exchange_ref(lo, hi)):
        assert g.shape == w.shape and g.dtype == dtype
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["odd plane", "aligned"])
@pytest.mark.parametrize("route", ops.ROUTES)
def test_kernel_many_calls_in_a_row_per_route(cuda, route, layout):
    """50 calls on one stream per route (the flags route reuses its flags
    under rising epochs)."""
    lo, hi = _layout(8, layout, torch.float32, cuda, seed=11)
    for i in range(50):
        lo, hi = lo + 1.0, hi - 1.0
        got = ring_halo_exchange(lo, hi, route=route)
        want = ring_halo_exchange_ref(lo, hi)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), i
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_dispatcher_matches_the_window(cuda):
    blocks = torch.as_tensor(_strips(8, (4, 17, 9), seed=5), device=cuda)
    before = ring_halo_exchange.launches
    got = exchange_planes_1d(blocks)
    assert ring_halo_exchange.launches == before + 1
    for g, w, m in zip(got, message_free.exchange_planes_1d(blocks),
                       message_based.exchange_planes_1d(blocks)):
        assert g.shape == w.shape == (8, 1, 17, 9)
        assert torch.equal(g, w) and torch.equal(g, m)


@pytest.mark.cuda
def test_hpcg_message_free_runs_the_kernel(cuda):
    from repro_torch.apps.hpcg import torch_impl as hpcg
    from repro_torch.comm import grid_mesh
    grid = grid_mesh(4, device=cuda)
    b = hpcg.make_problem((32, 16, 16), device=cuda)
    before = ring_halo_exchange.launches
    xf, rf = hpcg.make_cg(grid, "message_free", n_iter=10)(
        b, torch.zeros_like(b))
    torch.cuda.synchronize()
    assert ring_halo_exchange.launches > before
    xb, rb = hpcg.make_cg(grid, "message_based", n_iter=10)(
        b, torch.zeros_like(b))
    assert torch.equal(xf, xb) and torch.equal(rf, rb)
