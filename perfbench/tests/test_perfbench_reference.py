"""The plain reference against the port at tiny sizes on the CPU, and the
frozen counts against hand-worked values."""
import pytest
import torch

from perfbench import counts
from perfbench.reference import heat2d, hpcg
from repro_torch.apps.hpcg import torch_impl as port_hpcg
from repro_torch.apps.stencil import torch_impl as port_heat
from repro_torch.comm.topology import grid_mesh

F64 = torch.float64


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
def test_hpcg_reference_agrees_with_the_port(dtype, tol):
    """4 ranks x 16^3, 10 PCG iterations from x0 = 0, message-free."""
    g = torch.Generator().manual_seed(7)
    b = torch.randn((64, 16, 16), generator=g, dtype=dtype)
    x, res = port_hpcg.make_cg(grid_mesh(4, device="cpu"), "message_free",
                               n_iter=10)(b, torch.zeros_like(b))
    x_ref, res_ref = hpcg.pcg(b.to(F64), 4, 4, 10)
    assert float((x.to(F64) - x_ref).abs().max()
                 / x_ref.abs().max()) < tol
    assert abs(float(res) - float(res_ref)) / float(res_ref) < tol * 10


def test_hpcg_operator_agrees_with_the_ports():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4 * 8, 8, 8), generator=g, dtype=F64)
    got = port_hpcg.from_slabs(port_hpcg.apply_a(
        port_hpcg.to_slabs(x, 4), "message_based"))
    assert torch.allclose(hpcg.apply_a(x), got, rtol=1e-13, atol=1e-12)


def test_hpcg_reference_coarsens_by_the_slab():
    """The V-cycle's depth reads a rank's slab: 2 ranks x 8^3 go down to
    4^3 (two levels below), not as deep as the whole 16 x 8 x 8 lattice."""
    assert counts.hpcg_slabs((8, 8, 8), 4) == [(8, 8, 8), (4, 4, 4),
                                               (2, 2, 2)]
    b = torch.ones((16, 8, 8), dtype=F64)
    port, _ = port_hpcg.make_cg(grid_mesh(2, device="cpu"), "message_free",
                                n_iter=3)(b, torch.zeros_like(b))
    ref, _ = hpcg.pcg(b, 2, 4, 3)
    assert torch.allclose(port, ref, rtol=1e-12, atol=1e-13)


def _heat_tiles(px, py, t, seed, dtype=F64):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((px, py, t, t), generator=g, dtype=dtype)


def test_heat_reference_agrees_with_the_port():
    """2 x 2 ranks x 16^2, 12 steps, message-free, on the whole plane."""
    tiles = _heat_tiles(2, 2, 16, 5)
    step = port_heat.make_step(grid_mesh(2, 2, device="cpu"),
                               "message_free")
    plane = port_heat.from_tiles(tiles)
    for _ in range(12):
        tiles = step(tiles)
        plane = heat2d.step(plane)
    assert torch.allclose(port_heat.from_tiles(tiles), plane, rtol=0,
                          atol=1e-14)


@pytest.mark.parametrize("corner", [(0, 0), (0, 11), (13, 0), (24, 24),
                                    (9, 7), (24, 3)])
def test_heat_patches_equal_the_whole_plane(corner):
    """A patch worked out from its reflected neighbourhood equals the same
    patch of the whole plane's steps, at the edges and corners too, and
    for more steps than the plane is wide."""
    plane0 = port_heat.from_tiles(_heat_tiles(2, 2, 16, 9))
    for steps in (1, 5, 40):
        plane = plane0
        for _ in range(steps):
            plane = heat2d.step(plane)
        at = torch.tensor([corner])
        rows, cols = heat2d.region_indices(at, 8, steps, plane0.shape)
        got = heat2d.patches(plane0[rows[:, :, None], cols[:, None, :]],
                             steps)[0]
        r, c = corner
        assert torch.allclose(got, plane[r:r + 8, c:c + 8], rtol=0,
                              atol=1e-14)


def test_hpcg_counts_by_hand():
    assert counts.hpcg_slabs((256, 256, 256), 4) == [
        (256,) * 3, (128,) * 3, (64,) * 3, (32,) * 3]
    assert counts.hpcg_applies_per_set(50, 4) == [204, 153, 153, 51]
    assert sum(counts.hpcg_applies_per_set(25, 4)) == 286  # a 25-iteration solve
    points = 8 * 256 ** 3
    assert counts.hpcg_step_bytes(points, 4) == 3_221_225_472
    assert counts.apply_a_bytes(8, (256,) * 3, 4) == 1_077_936_128
    assert counts.apply_a_ops(8, (256,) * 3) == 27 * points
    # 4 applications at level 0, 3 at levels 1 and 2, 1 at level 3
    assert counts.hpcg_step_ops((256,) * 3, 8, 4) == 27 * points * (
        4 + 3 / 8 + 3 / 64 + 1 / 512)
    assert counts.halo_bytes(8, 256 * 256, 4) == 8_388_608
    assert counts.least_s(3_221_225_472, 0) == pytest.approx(9.6156e-4,
                                                             rel=1e-4)


def test_heat_counts_by_hand():
    points = 64 * 4096 ** 2
    assert counts.heat_step_bytes(points, 4) == 8_589_934_592
    assert counts.heat_step_ops(points) == 4 * 2 ** 30
    assert counts.least_s(8_589_934_592, 4 * 2 ** 30) == pytest.approx(
        2.5642e-3, rel=1e-4)
