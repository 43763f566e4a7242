"""The port's flash-attention kernel: the plain version (``ref.py``) and the
CPU dispatch of the wrapper against the JAX package's Pallas kernel
(interpret mode), and — on a CUDA device only — the CUDA kernel against the
plain version.

Tolerances are the reference's own (``test_kernels.py``): float32 atol =
rtol = 2e-5, bfloat16 3e-2.

``q_offset`` (a block of queries of a longer sequence, against the keys up
to its end: a sequence-sharded rank's attention) is held against the rows
of the whole sequence's call: the plain version against the JAX kernel's
rows on the CPU, the kernels against the plain version and against their
own whole call's rows (bit for bit where the block starts on a q tile) on
the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention.ops import route
from repro_torch.models.layers import chunked_attention

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)

#: (B, S, T, Hq, Hkv, D, causal): the reference's five shapes.
CASES = [
    (1, 128, 128, 4, 4, 64, True),
    (2, 256, 256, 8, 2, 64, True),      # GQA 4:1
    (1, 256, 256, 16, 16, 128, True),   # MHA, wide head
    (2, 128, 128, 8, 8, 64, False),     # bidirectional
    (1, 384, 384, 6, 2, 64, True),      # non-pow2 heads, GQA 3:1
]
BLOCKS = [(64, 64), (128, 64), (64, 128)]


@pytest.fixture
def jax_ref():
    """The JAX package's kernel wrapper (interpret mode) and its oracles —
    imported here so the card-only tests below run where jax is absent."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention import attention_ref as jax_attention
    from repro.kernels.flash_attention import flash_attention as jax_flash
    from repro.models.layers import chunked_attention as jax_chunked
    return jnp, jax_flash, jax_attention, jax_chunked


@pytest.fixture
def cuda():
    """The CUDA device; decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(B, S, T, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, Hq, D)), rng.normal(size=(B, T, Hkv, D)),
            rng.normal(size=(B, T, Hkv, D)))


def _torch(arrays, dtype=torch.float32, device="cpu"):
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]


def _jax(jnp, arrays, dtype=None):
    return [jnp.asarray(a, dtype or jnp.float32) for a in arrays]


@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,causal", CASES)
def test_ref_matches_reference_kernel(jax_ref, B, S, T, Hq, Hkv, D, causal):
    jnp, jax_flash, _, _ = jax_ref
    arrays = _qkv(B, S, T, Hq, Hkv, D, seed=S + Hq)
    want = np.asarray(jax_flash(*_jax(jnp, arrays), causal=causal))
    got = attention_ref(*_torch(arrays), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,causal", CASES)
def test_cpu_dispatch_is_the_plain_version(jax_ref, B, S, T, Hq, Hkv, D,
                                           causal):
    jnp, jax_flash, jax_attention, _ = jax_ref
    arrays = _qkv(B, S, T, Hq, Hkv, D, seed=S + Hq)
    before = flash_attention.launches
    got = flash_attention(*_torch(arrays), causal=causal)
    assert flash_attention.launches == before      # no kernel on the CPU
    assert torch.equal(got, attention_ref(*_torch(arrays), causal=causal))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_attention(*_jax(jnp, arrays),
                                              causal=causal)), **F32)


@pytest.mark.parametrize("bq,bk", BLOCKS)
def test_block_shapes(jax_ref, bq, bk):
    jnp, jax_flash, _, _ = jax_ref
    arrays = _qkv(1, 256, 256, 4, 4, 64, seed=bq + 3 * bk)
    want = np.asarray(jax_flash(*_jax(jnp, arrays), causal=True, block_q=bq,
                                block_k=bk))
    got = flash_attention(*_torch(arrays), causal=True, block_q=bq,
                          block_k=bk)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_bf16(jax_ref):
    jnp, jax_flash, _, _ = jax_ref
    arrays = _qkv(1, 128, 128, 4, 4, 64, seed=7)
    want = jax_flash(*_jax(jnp, arrays, jnp.bfloat16), causal=True)
    got = flash_attention(*_torch(arrays, torch.bfloat16), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def test_chunked_attention_matches_reference(jax_ref):
    """The model's blockwise plain path (above 2048 positions) agrees with
    the reference's and with the quadratic oracle."""
    jnp, _, jax_attention, jax_chunked = jax_ref
    arrays = _qkv(2, 256, 256, 8, 2, 32, seed=11)
    got = chunked_attention(*_torch(arrays), causal=True, q_block=64,
                            kv_block=128)
    want = jax_chunked(*_jax(jnp, arrays), causal=True, q_block=64,
                       kv_block=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    oracle = np.asarray(jax_attention(*_jax(jnp, arrays), causal=True))
    np.testing.assert_allclose(got.numpy(), oracle.reshape(2, 256, -1), **F32)


@pytest.mark.parametrize("S,bq", [(256, 96), (100, 64)])
def test_block_sizes_that_do_not_divide_fail_as_in_the_reference(jax_ref, S,
                                                                 bq):
    jnp, jax_flash, _, _ = jax_ref
    arrays = _qkv(1, S, S, 2, 2, 16, seed=1)
    with pytest.raises(AssertionError):
        jax_flash(*_jax(jnp, arrays), causal=True, block_q=bq)
    with pytest.raises(ValueError, match="divide"):
        flash_attention(*_torch(arrays), causal=True, block_q=bq)


def test_bad_shapes_and_grad_raise():
    q, k, v = _torch(_qkv(1, 64, 64, 6, 4, 16))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q, k, v)
    q, k, v = _torch(_qkv(1, 64, 64, 4, 2, 16))
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k.double(), v)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 256, "sm90"), (torch.bfloat16, 16, "simt"),
    (torch.bfloat16, 32, "simt"), (torch.float32, 16, "simt"),
    (torch.float32, 32, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 256, "simt")])
def test_route_table(dtype, D, want):
    """bf16 at D in {64, 128, 256} goes to the tensor-core kernel, the rest
    to the f32 kernel; decided from (dtype, D) alone."""
    assert route(dtype, D) == want


@pytest.mark.parametrize("dtype,D,match", [
    (torch.float16, 64, "float32/bfloat16"),
    (torch.float64, 128, "float32/bfloat16"),
    (torch.float32, 48, "head widths"), (torch.bfloat16, 96, "head widths"),
    (torch.bfloat16, 512, "head widths")])
def test_route_refuses_what_no_kernel_takes(dtype, D, match):
    with pytest.raises(ValueError, match=match):
        route(dtype, D)


# ----------------------------------------------------------------- on a card
#: (B, S, T, Hq, Hkv, D, causal, dtype) beyond the reference's shapes:
#: ragged sequence lengths, S != T, every head width the kernel takes.
CUDA_EXTRA = [
    (2, 100, 100, 4, 2, 64, True, torch.float32),
    (1, 64, 192, 4, 1, 32, True, torch.float32),
    (1, 192, 64, 2, 2, 16, False, torch.float32),
    (1, 130, 130, 2, 1, 256, True, torch.float32),
    (2, 320, 320, 8, 2, 128, True, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,causal", CASES)
def test_kernel_matches_plain(cuda, B, S, T, Hq, Hkv, D, causal):
    q, k, v = _torch(_qkv(B, S, T, Hq, Hkv, D, seed=S + Hq), device=cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               attention_ref(q, k, v, causal).cpu().numpy(),
                               **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("bq,bk", BLOCKS)
def test_kernel_block_shapes(cuda, bq, bk):
    q, k, v = _torch(_qkv(1, 256, 256, 4, 4, 64, seed=bq + 3 * bk),
                     device=cuda)
    got = flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.cpu().numpy(),
                               attention_ref(q, k, v).cpu().numpy(), **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,causal,dtype", CUDA_EXTRA + [
    (1, 128, 128, 4, 4, 64, True, torch.bfloat16)])
def test_kernel_other_shapes(cuda, B, S, T, Hq, Hkv, D, causal, dtype):
    q, k, v = _torch(_qkv(B, S, T, Hq, Hkv, D, seed=S + D), dtype, cuda)
    got = flash_attention(q, k, v, causal=causal, block_q=S, block_k=T)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = F32 if dtype == torch.float32 else BF16
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        attention_ref(q, k, v, causal).float().cpu().numpy(), **tol)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _torch(_qkv(1, 64, 64, 2, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head widths"):
        flash_attention(q, k, v)
    q, k, v = _torch(_qkv(1, 64, 64, 2, 2, 64), torch.float16, cuda)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        flash_attention(q, k, v)


#: The tensor-core route: every head width it takes, causal and not, GQA
#: 4:1 and 3:1, B = 2 with S = 192 (a ragged second 128-row q tile, where a
#: map over a flattened B x S axis would read the next batch row), and
#: T = 320 != S when not causal.
SM90_CASES = [(D, causal, Hq, Hkv) for D in (64, 128, 256)
              for causal in (True, False) for Hq, Hkv in ((8, 2), (6, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("D,causal,Hq,Hkv", SM90_CASES)
def test_sm90_kernel_matches_plain(cuda, D, causal, Hq, Hkv):
    B, S = 2, 192
    T = S if causal else 320
    q, k, v = _torch(_qkv(B, S, T, Hq, Hkv, D, seed=D + Hq + causal),
                     torch.bfloat16, cuda)
    assert route(q.dtype, D) == "sm90"
    before = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, causal=causal, block_q=S, block_k=T)
    torch.cuda.synchronize()
    assert flash_attention.route_launches["sm90"] == before["sm90"] + 1
    assert flash_attention.route_launches["simt"] == before["simt"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        attention_ref(q, k, v, causal).float().cpu().numpy(), **BF16)


#: Prompt lengths of serving's prefill (batch 1, ragged): one token, a few,
#: a ragged last q tile, and one short of the chunked-attention threshold.
RAGGED = (1, 17, 517, 2047)
#: Relative-norm bound of a bf16 output as a whole: bf16's machine epsilon
#: (at these lengths most outputs are far below the elementwise atol).
RTOL_NORM_BF16 = 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("S", RAGGED)
def test_sm90_kernel_at_ragged_lengths(cuda, S):
    """Serving's prefill shape on the tensor-core route: batch 1, jamba's
    heads (32 query, 8 kv, D = 128), a prompt of any length, with the block
    sizes the model passes (the whole sequence)."""
    q, k, v = _torch(_qkv(1, S, S, 32, 8, 128, seed=S), torch.bfloat16, cuda)
    before = flash_attention.route_launches["sm90"]
    got = flash_attention(q, k, v, causal=True, block_q=S, block_k=S)
    torch.cuda.synchronize()
    assert flash_attention.route_launches["sm90"] == before + 1
    want = attention_ref(q, k, v, causal=True).float()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.cpu().numpy(), **BF16)
    rel = torch.linalg.vector_norm(got.float() - want) \
        / torch.linalg.vector_norm(want)
    assert float(rel) <= RTOL_NORM_BF16, float(rel)


@pytest.mark.cuda
@pytest.mark.parametrize("S", RAGGED)
def test_simt_kernel_at_ragged_lengths(cuda, S):
    """The float32 route at the reduced configs' head width (16) and GQA
    2:1, batch 1, ragged prompt lengths."""
    q, k, v = _torch(_qkv(1, S, S, 4, 2, 16, seed=S + 1), device=cuda)
    before = flash_attention.route_launches["simt"]
    got = flash_attention(q, k, v, causal=True, block_q=S, block_k=S)
    torch.cuda.synchronize()
    assert flash_attention.route_launches["simt"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               attention_ref(q, k, v).cpu().numpy(), **F32)


# ------------------------------------------------------------------ q_offset
#: (S, o): a block of S queries at key position o of a 256-position
#: sequence (tile-aligned, ragged, and the last positions).
OFFSETS = [(64, 128), (96, 100), (64, 192), (256, 0)]


@pytest.mark.parametrize("S,o", OFFSETS)
def test_ref_with_q_offset_is_rows_of_the_reference_kernel(jax_ref, S, o):
    """``attention_ref(q[:, o:o+S], k[:, :o+S], v[:, :o+S], q_offset=o)``
    is rows ``o:o+S`` of the JAX kernel (interpret mode) on the whole
    sequence; the wrapper's CPU call and the chunked plain path give the
    same rows."""
    jnp, jax_flash, _, _ = jax_ref
    q, k, v = _qkv(2, 256, 256, 8, 2, 64, seed=S + o)
    want = np.asarray(jax_flash(*_jax(jnp, (q, k, v)), causal=True))
    qs, ks, vs = _torch((q[:, o:o + S], k[:, :o + S], v[:, :o + S]))
    got = attention_ref(qs, ks, vs, causal=True, q_offset=o)
    np.testing.assert_allclose(got.numpy(), want[:, o:o + S], **F32)
    assert torch.equal(flash_attention(qs, ks, vs, block_q=S, block_k=o + S,
                                       q_offset=o), got)
    chunked = chunked_attention(qs, ks, vs, q_block=32, kv_block=32,
                                q_offset=o)
    np.testing.assert_allclose(chunked.numpy(),
                               want[:, o:o + S].reshape(2, S, -1), **F32)


def test_q_offset_must_not_be_negative():
    q, k, v = _torch(_qkv(1, 8, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, q_offset=-1)


#: (route, dtype, D, Hq, Hkv, S, o, T): a rank's block at the offsets a
#: sequence-sharded model gives it (the last of four blocks, and a middle
#: one), and a ragged block.
Q_OFFSET_CASES = [("sm90", torch.bfloat16, 128, 8, 2, 256, 768, 1024),
                  ("sm90", torch.bfloat16, 128, 8, 2, 256, 256, 512),
                  ("sm90", torch.bfloat16, 64, 6, 2, 100, 300, 400),
                  ("simt", torch.float32, 64, 4, 2, 128, 384, 512),
                  ("simt", torch.float32, 16, 4, 2, 100, 300, 400)]


@pytest.mark.cuda
@pytest.mark.parametrize("path,dtype,D,Hq,Hkv,S,o,T", Q_OFFSET_CASES)
def test_kernel_with_q_offset_matches_plain(cuda, path, dtype, D, Hq, Hkv,
                                            S, o, T):
    """The kernel at ``q_offset`` against the plain version; where the
    block starts on a q tile (128 rows sm90, 64 simt), its output is the
    whole sequence's call's rows bit for bit (the same tiles, masks and
    order), and ``q_offset=0`` is the call without it, bit for bit."""
    q, k, v = _torch(_qkv(2, T, T, Hq, Hkv, D, seed=o + S), dtype, cuda)
    qs = q[:, o:o + S].contiguous()
    assert route(dtype, D) == path
    before = dict(flash_attention.route_launches)
    got = flash_attention(qs, k, v, block_q=S, block_k=T, q_offset=o)
    torch.cuda.synchronize()
    assert flash_attention.route_launches[path] == before[path] + 1
    tol = F32 if dtype == torch.float32 else BF16
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        attention_ref(qs, k, v, q_offset=o).float().cpu().numpy(), **tol)
    whole = flash_attention(q, k, v, block_q=T, block_k=T)
    if o % (128 if path == "sm90" else 64) == 0 and o + S == T:
        assert torch.equal(got, whole[:, o:o + S])
    assert torch.equal(flash_attention(q, k, v, block_q=T, block_k=T,
                                       q_offset=0), whole)
