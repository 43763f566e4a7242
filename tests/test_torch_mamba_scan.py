"""The port's selective-scan kernel: the plain version (``ref.py``), the
CPU dispatch of the wrapper and the model's plain path against the JAX
package's Pallas kernel (interpret mode) and oracles, and — on a CUDA
device only — the CUDA kernel against the plain version.

Tolerance is the reference's own (``test_kernels.py``): atol = rtol = 1e-4.

``h0`` (a later block of a sequence scanned from the state the earlier
blocks leave, as a sequence-sharded rank scans) is held against the JAX
kernel's whole-sequence scan on the CPU, with the two-pass combine of four
blocks (each block scanned from zero, the states folded by the blocks'
decays, each rescanned from its carry) beside it; on the card, the kernel
from a state against the plain version, and ``h0=None`` against zeros bit
for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref

TOL = dict(atol=1e-4, rtol=1e-4)

#: (B, L, d, N, d_block, chunk): the reference's four shapes.
CASES = [
    (1, 64, 32, 8, 32, 64),
    (2, 128, 64, 16, 16, 32),
    (1, 96, 48, 4, 48, 96),      # single chunk, full width
    (3, 256, 16, 8, 16, 64),
]


@pytest.fixture
def jax_ref():
    """The JAX package's kernel wrapper (interpret mode) and its oracles —
    imported here so the card-only tests below run where jax is absent."""
    import jax.numpy as jnp
    from repro.kernels.mamba_scan import mamba_scan as jax_scan
    from repro.kernels.mamba_scan import mamba_scan_ref as jax_scan_ref
    from repro.models.mamba import selective_scan as jax_selective
    return jnp, jax_scan, jax_scan_ref, jax_selective


@pytest.fixture
def cuda():
    """The CUDA device; decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(B, L, d, N, seed=0, a_unit=False):
    """x, dt, Bt, Ct, A, D as the reference's tests draw them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, d))
    dt = np.abs(rng.normal(0.05, 0.02, size=(B, L, d)))
    Bt = rng.normal(size=(B, L, N))
    Ct = rng.normal(size=(B, L, N))
    if a_unit:
        A, D = -np.ones((d, N)), np.zeros((d,))
    else:
        A = -np.abs(rng.normal(1, 0.3, size=(d, N)))
        D = rng.normal(size=(d,))
    return x, dt, Bt, Ct, A, D


def _torch(arrays, device="cpu"):
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("B,L,d,N,dblk,chunk", CASES)
def test_ref_matches_reference_kernel(jax_ref, B, L, d, N, dblk, chunk):
    jnp, jax_scan, _, _ = jax_ref
    arrays = _inputs(B, L, d, N, seed=L + d)
    want = jax_scan(*(jnp.asarray(a, jnp.float32) for a in arrays),
                    d_block=dblk, chunk=chunk)
    _check(mamba_scan_ref(*_torch(arrays)), want)


@pytest.mark.parametrize("B,L,d,N,dblk,chunk", CASES)
def test_cpu_dispatch_is_the_plain_version(jax_ref, B, L, d, N, dblk, chunk):
    jnp, _, jax_scan_ref, _ = jax_ref
    arrays = _inputs(B, L, d, N, seed=L + d)
    before = mamba_scan.launches
    y, h = mamba_scan(*_torch(arrays), d_block=dblk, chunk=chunk)
    assert mamba_scan.launches == before           # no kernel on the CPU
    yr, hr = mamba_scan_ref(*_torch(arrays))
    assert torch.equal(y, yr) and torch.equal(h, hr)
    _check((y, h), jax_scan_ref(*(jnp.asarray(a, jnp.float32)
                                  for a in arrays)))


def test_ref_matches_reference_selective_scan(jax_ref):
    """mamba_scan_ref, the model's plain path, == the reference model's
    chunked selective_scan and its oracle (the reference test's inputs:
    A = -1, D = 0)."""
    jnp, _, jax_scan_ref, jax_selective = jax_ref
    arrays = _inputs(2, 64, 32, 8, seed=3, a_unit=True)
    jarrays = [jnp.asarray(a, jnp.float32) for a in arrays]
    got = mamba_scan_ref(*_torch(arrays))
    _check(got, jax_selective(*jarrays, chunk=16))
    _check(got, jax_scan_ref(*jarrays))


def test_ref_carries_an_initial_state(jax_ref):
    jnp, _, jax_scan_ref, _ = jax_ref
    arrays = _inputs(2, 40, 24, 8, seed=4)
    h0 = np.random.default_rng(5).normal(size=(2, 24, 8))
    got = mamba_scan_ref(*_torch(arrays), h0=torch.as_tensor(h0).float())
    _check(got, jax_scan_ref(*(jnp.asarray(a, jnp.float32) for a in arrays),
                             h0=jnp.asarray(h0, jnp.float32)))


@pytest.mark.parametrize("dblk,chunk", [(24, 64), (32, 48)])
def test_blocks_that_do_not_divide_fail_as_in_the_reference(jax_ref, dblk,
                                                            chunk):
    jnp, jax_scan, _, _ = jax_ref
    arrays = _inputs(1, 64, 32, 4, seed=6)
    with pytest.raises(AssertionError):
        jax_scan(*(jnp.asarray(a, jnp.float32) for a in arrays),
                 d_block=dblk, chunk=chunk)
    with pytest.raises(ValueError, match="divide"):
        mamba_scan(*_torch(arrays), d_block=dblk, chunk=chunk)


def test_bad_shapes_and_grad_raise():
    x, dt, Bt, Ct, A, D = _torch(_inputs(1, 16, 8, 4))
    with pytest.raises(ValueError, match="Bt and Ct"):
        mamba_scan(x, dt, Bt[:, :, :3], Ct, A, D)
    dt.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        mamba_scan(x, dt, Bt, Ct, A, D)
    with torch.inference_mode():
        y, h = mamba_scan(x, dt, Bt, Ct, A, D)
    assert y.shape == (1, 16, 8) and h.shape == (1, 8, 4)


# ----------------------------------------------------------------- on a card
@pytest.mark.cuda
@pytest.mark.parametrize("B,L,d,N,dblk,chunk", CASES + [
    (2, 1000, 200, 16, 200, 1000),     # ragged chunks and channel blocks
    (1, 130, 96, 1, 96, 130),          # one state
    (1, 50, 30, 5, 30, 50),            # d and N padded by the wrapper
])
def test_kernel_matches_plain(cuda, B, L, d, N, dblk, chunk):
    ins = _torch(_inputs(B, L, d, N, seed=L + d), device=cuda)
    before = mamba_scan.launches
    y, h = mamba_scan(*ins, d_block=dblk, chunk=chunk)
    torch.cuda.synchronize()
    assert mamba_scan.launches == before + 1
    _check((y, h), [t.cpu().numpy() for t in mamba_scan_ref(*ins)])


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, Bt, Ct, A, D = _torch(_inputs(1, 16, 8, 17), device=cuda)
    with pytest.raises(ValueError, match="at most 16"):
        mamba_scan(x, dt, Bt, Ct, A, D)
    x, dt, Bt, Ct, A, D = _torch(_inputs(1, 16, 8, 4), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        mamba_scan(x, dt.double(), Bt, Ct, A, D)


@pytest.mark.cuda
def test_kernel_does_not_drift_over_a_long_sequence(cuda):
    """4,096 steps at N = 16: the kernel's decays (ex2.approx of dt * A *
    log2 e) stay within the bound of a float64 recurrence.  (The float32
    plain version is no oracle over such a run: its own rounding reaches the
    size of the bound.)"""
    ins = _torch(_inputs(1, 4096, 64, 16, seed=9), device=cuda)
    got = mamba_scan(*ins, d_block=64, chunk=4096)
    torch.cuda.synchronize()
    exact = mamba_scan_ref(*(t.double() for t in ins))
    _check(got, [t.cpu().numpy() for t in exact])


#: Prompt lengths of serving's prefill (batch 1, ragged).
RAGGED = (1, 17, 517, 2047)


@pytest.mark.cuda
@pytest.mark.parametrize("d,N", [(8192, 16), (128, 8)])
@pytest.mark.parametrize("L", RAGGED)
def test_kernel_at_ragged_lengths(cuda, L, d, N):
    """Serving's prefill shape: batch 1, a prompt of any length, jamba's
    width (d = 8192, N = 16) and the reduced configs' (d = 128, N = 8,
    padded to 16 by the wrapper), with the chunk the model passes (the
    whole sequence); y and h_final, the decode state, against the plain
    version."""
    ins = _torch(_inputs(1, L, d, N, seed=L + d), device=cuda)
    before = mamba_scan.launches
    y, h = mamba_scan(*ins, chunk=L)
    torch.cuda.synchronize()
    assert mamba_scan.launches == before + 1
    assert y.shape == (1, L, d) and h.shape == (1, d, N)
    _check((y, h), [t.cpu().numpy() for t in mamba_scan_ref(*ins)])


# ----------------------------------------------------------------------- h0
def _two_pass(x, dt, Bt, Ct, A, D, blocks: int, scan=mamba_scan_ref):
    """The sequence-sharded scan of ``models.mamba`` over ``blocks`` equal
    blocks: pass 1 from zero (h_end, and the decay P = exp(A sum dt)), the
    carry h_in of block r folded from the blocks before it, pass 2 from
    h_in.  Returns the concatenated y and the last block's h."""
    n = x.shape[1] // blocks
    parts = [slice(r * n, (r + 1) * n) for r in range(blocks)]
    ends = []
    for s in parts:
        _, h = scan(x[:, s], dt[:, s], Bt[:, s], Ct[:, s], A, D)
        ends.append((h, torch.exp(A * dt[:, s].sum(1)[..., None])))
    ys, h_in = [], torch.zeros_like(ends[0][0])
    for r, s in enumerate(parts):
        y, h = scan(x[:, s], dt[:, s], Bt[:, s], Ct[:, s], A, D, h0=h_in)
        ys.append(y)
        h_in = ends[r][1] * h_in + ends[r][0]
    return torch.cat(ys, 1), h


def test_second_half_from_the_first_halfs_state_is_the_whole_scan(jax_ref):
    """``mamba_scan_ref`` of the second half from the first half's final
    state (and the wrapper's CPU call with ``h0``) equals the JAX kernel's
    scan of the whole sequence."""
    jnp, jax_scan, _, _ = jax_ref
    arrays = _inputs(2, 128, 32, 8, seed=12)
    y_all, h_all = jax_scan(*(jnp.asarray(a, jnp.float32) for a in arrays),
                            d_block=32, chunk=64)
    x, dt, Bt, Ct, A, D = _torch(arrays)
    y1, h1 = mamba_scan_ref(x[:, :64], dt[:, :64], Bt[:, :64], Ct[:, :64],
                            A, D)
    y2, h2 = mamba_scan_ref(x[:, 64:], dt[:, 64:], Bt[:, 64:], Ct[:, 64:],
                            A, D, h0=h1)
    _check((torch.cat([y1, y2], 1), h2), (y_all, h_all))
    y3, h3 = mamba_scan(x[:, 64:], dt[:, 64:], Bt[:, 64:], Ct[:, 64:], A, D,
                        chunk=64, h0=h1)
    assert torch.equal(y3, y2) and torch.equal(h3, h2)


def test_two_pass_combine_over_four_blocks_is_the_whole_scan(jax_ref):
    """Four blocks, each scanned from zero, their final states folded by
    the blocks' decays into each block's carry and rescanned from it: the
    JAX kernel's whole-sequence scan."""
    jnp, jax_scan, _, _ = jax_ref
    arrays = _inputs(2, 128, 32, 8, seed=13)
    want = jax_scan(*(jnp.asarray(a, jnp.float32) for a in arrays),
                    d_block=32, chunk=32)
    _check(_two_pass(*_torch(arrays), blocks=4), want)


def test_h0_of_the_wrong_shape_raises():
    x, dt, Bt, Ct, A, D = _torch(_inputs(1, 16, 8, 4))
    with pytest.raises(ValueError, match="h0"):
        mamba_scan(x, dt, Bt, Ct, A, D, h0=torch.zeros(1, 8, 5))


#: (B, L, d, N): a rank's block at the LM's width (the fourth of 4,096
#: positions, scaled down to fit the test), and padded d and N.
H0_CASES = [(2, 256, 1024, 16), (1, 100, 30, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,d,N", H0_CASES)
def test_kernel_from_a_state_matches_plain(cuda, B, L, d, N):
    """The kernel from a nonzero ``h0`` against the plain version; the
    four-block two-pass combine on the kernel against the whole-sequence
    scan in float64; ``h0=None`` and ``h0`` of zeros bit for bit."""
    ins = _torch(_inputs(B, 4 * L, d, N, seed=L + d), device=cuda)
    h0 = torch.as_tensor(np.random.default_rng(d).normal(size=(B, d, N)),
                         dtype=torch.float32, device=cuda)
    x, dt, Bt, Ct, A, D = ins
    blk = [t[:, :L] for t in (x, dt, Bt, Ct)]
    before = mamba_scan.launches
    y, h = mamba_scan(*blk, A, D, chunk=L, h0=h0)
    torch.cuda.synchronize()
    assert mamba_scan.launches == before + 1
    _check((y, h), [t.cpu().numpy()
                    for t in mamba_scan_ref(*blk, A, D, h0=h0)])
    got = _two_pass(*ins, blocks=4,
                    scan=lambda *a, h0=None: mamba_scan(*a, chunk=L, h0=h0))
    # a float64 recurrence: the float32 plain version is no oracle over so
    # many steps (test_kernel_does_not_drift_over_a_long_sequence)
    _check(got, [t.cpu().numpy()
                 for t in mamba_scan_ref(*(t.double() for t in ins))])
    zero = mamba_scan(*blk, A, D, chunk=L, h0=torch.zeros_like(h0))
    none = mamba_scan(*blk, A, D, chunk=L)
    assert torch.equal(zero[0], none[0]) and torch.equal(zero[1], none[1])
