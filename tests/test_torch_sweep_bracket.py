"""The port's sweep-bracket kernels: the plain versions (``ref.py``) against
the JAX package's Pallas kernels (interpret mode, x64), the CPU dispatch of
the wrappers, and — on a CUDA device only — the CUDA kernels against the
plain versions.

Tolerances are the reference's own (``test_kernels.py``): f64 rtol 1e-12 /
atol 1e-9, f32 rtol 2e-5 / atol 1e-2, the segment sum rtol 1e-12 /
atol 1e-12.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.sweep_bracket import ops
from repro_torch.kernels.sweep_bracket import (BRACKET_NAMES, CsrGroup,
                                               bracket_segsum_ref, csr_group,
                                               fused_bracket_segsum,
                                               segment_sum, segment_sum_ref)

F64 = dict(rtol=1e-12, atol=1e-9)
F32 = dict(rtol=2e-5, atol=1e-2)
SEGSUM = dict(rtol=1e-12, atol=1e-12)

#: (S, n_seg, n_hit, n_lfb, n_miss): the reference's six shapes.
CASES = [
    (1, 1, 4, 0, 3),          # single scenario, empty LFB group
    (3, 5, 40, 17, 29),       # ragged group lengths, empty segments likely
    (16, 3, 128, 128, 128),   # exact tile multiples
    (7, 130, 200, 150, 90),   # n_seg past one 128-wide tile
    (2, 4, 0, 0, 0),          # no samples at all
    (2, 3, 640, 10, 5),       # a group of 640 samples
]


@pytest.fixture
def jax_ref():
    """The JAX package's kernels (interpret mode) and its x64 scope —
    imported here so the card-only tests below run where jax is absent."""
    from repro.compat import enable_x64
    from repro.kernels.sweep_bracket import (fused_bracket_segsum,
                                             segment_sum_pallas)
    return enable_x64, fused_bracket_segsum, segment_sum_pallas


@pytest.fixture
def cuda():
    """The CUDA device; decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _packed_group(rng, n, n_seg):
    """Packed (lat, w, seg) with site-major sorted ids, like
    ``compile_bundle`` emits."""
    lat = rng.uniform(1.0, 500.0, size=n)
    w = rng.uniform(0.1, 3.0, size=n)
    seg = np.sort(rng.integers(0, n_seg, size=n)).astype(np.int32)
    return lat, w, seg


def _case(S, n_seg, nh, nl, nm):
    rng = np.random.default_rng(S * 100 + nh + nl + nm)
    groups = [_packed_group(rng, n, n_seg) for n in (nh, nl, nm)]
    delta = rng.uniform(-150.0, 400.0, size=(S, 1))
    cxl = rng.uniform(150.0, 700.0, size=(S, 1))
    return groups, delta, cxl


def _torch_groups(groups, dtype=torch.float64, device="cpu"):
    return [(torch.as_tensor(lat, dtype=dtype, device=device),
             torch.as_tensor(w, dtype=dtype, device=device),
             torch.as_tensor(seg, device=device)) for lat, w, seg in groups]


@pytest.mark.parametrize("S,n_seg,nh,nl,nm", CASES)
def test_bracket_ref_matches_reference_kernel(jax_ref, S, n_seg, nh, nl, nm):
    enable_x64, jax_fused, _ = jax_ref
    groups, delta, cxl = _case(S, n_seg, nh, nl, nm)
    with enable_x64():
        ref = {k: np.asarray(v) for k, v in
               jax_fused(*groups, delta, cxl, n_seg).items()}
    out = bracket_segsum_ref(*_torch_groups(groups), torch.from_numpy(delta),
                             torch.from_numpy(cxl), n_seg)
    assert set(out) == set(ref) == set(BRACKET_NAMES)
    for k in ref:
        assert out[k].shape == (S, n_seg) and out[k].dtype == torch.float64
        np.testing.assert_allclose(out[k].numpy(), ref[k], **F64)


def test_bracket_ref_matches_reference_kernel_f32(jax_ref):
    jax_fused = jax_ref[1]
    rng = np.random.default_rng(11)
    groups = [_packed_group(rng, n, 4) for n in (30, 20, 10)]
    g32 = [(lat.astype(np.float32), w.astype(np.float32), seg)
           for lat, w, seg in groups]
    delta = rng.uniform(-100.0, 300.0, size=(5, 1)).astype(np.float32)
    cxl = rng.uniform(200.0, 600.0, size=(5, 1)).astype(np.float32)
    ref = jax_fused(*g32, delta, cxl, 4)
    out = bracket_segsum_ref(*_torch_groups(g32, torch.float32),
                             torch.from_numpy(delta), torch.from_numpy(cxl), 4)
    for k in ref:
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **F32)


def _unsorted_case():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 70))
    ids = rng.integers(0, 6, size=70).astype(np.int32)
    return x, ids


def test_segment_sum_ref_matches_reference_kernel_unsorted_ids(jax_ref):
    enable_x64, _, segment_sum_pallas = jax_ref
    x, ids = _unsorted_case()
    with enable_x64():
        ref = np.asarray(segment_sum_pallas(x, ids, 6))
    out = segment_sum_ref(torch.from_numpy(x), torch.from_numpy(ids), 6)
    np.testing.assert_allclose(out.numpy(), ref, **SEGSUM)
    expected = np.stack([np.bincount(ids, weights=x[r], minlength=6)
                         for r in range(3)])
    np.testing.assert_allclose(out.numpy(), expected, **SEGSUM)


def test_cpu_wrappers_run_the_plain_versions():
    groups, delta, cxl = _case(3, 5, 40, 17, 29)
    tg = _torch_groups(groups)
    d, x = torch.from_numpy(delta), torch.from_numpy(cxl)
    before = (fused_bracket_segsum.launches, segment_sum.launches)
    out = fused_bracket_segsum(*tg, d, x, 5)
    ref = bracket_segsum_ref(*tg, d, x, 5)
    for k in ref:
        assert torch.equal(out[k], ref[k])
    xs, ids = _unsorted_case()
    assert torch.equal(segment_sum(torch.from_numpy(xs), ids, 6),
                       segment_sum_ref(torch.from_numpy(xs),
                                       torch.from_numpy(ids), 6))
    assert (fused_bracket_segsum.launches, segment_sum.launches) == before


def test_csr_group_permutes_only_unsorted_ids():
    lat = torch.arange(6, dtype=torch.float64)
    w = torch.ones(6, dtype=torch.float64)
    g = csr_group(lat, w, torch.tensor([0, 0, 2, 2, 2, 3]), 5)
    assert g.perm is None
    assert g.offsets.tolist() == [0, 2, 2, 5, 6, 6]
    g = csr_group(lat, w, torch.tensor([1, 0, 1, 0, 0, 1]), 2)
    assert g.perm.tolist() == [1, 3, 4, 0, 2, 5]       # stable
    assert g.offsets.tolist() == [0, 3, 6]
    with pytest.raises(ValueError, match="segment ids"):
        csr_group(lat, w, torch.tensor([0, 0, 5, 1, 1, 1]), 5)


@pytest.mark.parametrize("ids", [[0, 0, 2, 2, 2, 3], [1, 0, 1, 0, 0, 1],
                                 [3, 1, 2, 0, 2], [2, 2, 2], []])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_csr_group_packs_site_order_pairs(ids, dtype):
    """``pairs`` holds ``(lat[perm], w[perm])`` row by row (the identity
    order for sorted ids) in ``lat``'s dtype, padded to an even count."""
    n = len(ids)
    rng = np.random.default_rng(n)
    lat = torch.as_tensor(rng.uniform(1, 500, n), dtype=dtype)
    w = torch.as_tensor(rng.uniform(0.1, 3, n), dtype=dtype)
    g = csr_group(lat, w, torch.tensor(ids, dtype=torch.int64), 4)
    perm = torch.arange(n) if g.perm is None else g.perm.long()
    assert g.pairs.dtype == dtype and g.pairs.shape == (n + n % 2, 2)
    assert torch.equal(g.pairs[:n, 0], lat[perm])
    assert torch.equal(g.pairs[:n, 1], w[perm])
    assert not g.pairs[n:].any()
    sites = torch.as_tensor(ids, dtype=torch.int64)[perm]
    assert bool((sites[1:] >= sites[:-1]).all())
    for c in range(4):
        at = lat[torch.as_tensor(ids, dtype=torch.int64) == c]
        want = (at.min(), at.max()) if at.numel() else (np.inf, -np.inf)
        assert g.bounds[c].tolist() == [float(want[0]), float(want[1])]


def test_bracket_resident_follows_the_budget():
    def groups(*ns, dtype=torch.float64):
        return [csr_group(torch.ones(n, dtype=dtype),
                          torch.ones(n, dtype=dtype),
                          torch.zeros(n, dtype=torch.int64), 1) for n in ns]
    budget = ops.RESIDENT_BYTES // 16      # float64 pairs that fit
    assert ops.bracket_resident(groups(192, 64, 0))
    assert ops.bracket_resident(groups(budget - 2, 2, 0))
    assert not ops.bracket_resident(groups(budget - 2, 2, 1))
    assert ops.bracket_resident(groups(budget, budget, dtype=torch.float32))
    assert not ops.bracket_resident(groups(4000, 2500, 1000))


def test_prepared_groups_and_padding_match_triples():
    """Zero-``w``, id-0 padding (the padded layout) and prepared CsrGroups
    give the triples' sums."""
    groups, delta, cxl = _case(7, 130, 200, 150, 90)
    tg = _torch_groups(groups)
    d, x = torch.from_numpy(delta), torch.from_numpy(cxl)
    ref = fused_bracket_segsum(*tg, d, x, 130)
    padded = [(torch.cat([lat, torch.zeros(56, dtype=lat.dtype)]),
               torch.cat([w, torch.zeros(56, dtype=w.dtype)]),
               torch.cat([seg, torch.zeros(56, dtype=seg.dtype)]))
              for lat, w, seg in tg]
    prepared = [csr_group(*g, 130) for g in padded]
    assert all(isinstance(g, CsrGroup) and g.perm is not None
               for g in prepared)
    out = fused_bracket_segsum(*prepared, d, x, 130)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), **F64)


# ------------------------------------------------- on the card only

def _on(cuda, groups, dtype):
    return _torch_groups(groups, dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("S,n_seg,nh,nl,nm",
                         CASES + [(0, 3, 10, 5, 2), (4, 0, 0, 0, 0)])
def test_bracket_kernel_matches_plain(cuda, dtype, S, n_seg, nh, nl, nm):
    groups, delta, cxl = _case(S, n_seg, nh, nl, nm)
    tg = _on(cuda, groups, dtype)
    d = torch.as_tensor(delta, dtype=dtype, device=cuda)
    x = torch.as_tensor(cxl, dtype=dtype, device=cuda)
    before = fused_bracket_segsum.launches
    out = fused_bracket_segsum(*tg, d, x, n_seg)
    torch.cuda.synchronize()
    assert fused_bracket_segsum.launches - before == (1 if S and n_seg else 0)
    ref = bracket_segsum_ref(*tg, d, x, n_seg)
    tol = F64 if dtype == torch.float64 else F32
    for k in ref:
        assert out[k].shape == (S, n_seg) and out[k].dtype == dtype
        np.testing.assert_allclose(out[k].cpu().numpy(), ref[k].cpu().numpy(),
                                   **tol)


@pytest.mark.cuda
def test_segment_sum_kernel_matches_plain_unsorted_ids(cuda):
    x, ids = _unsorted_case()
    xt = torch.as_tensor(x, device=cuda)
    before = segment_sum.launches
    out = segment_sum(xt, torch.as_tensor(ids, device=cuda), 6)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    ref = segment_sum_ref(xt.cpu(), torch.from_numpy(ids), 6)
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), **SEGSUM)


def _groups_on(cuda, dtype, ns, n_seg, seed, unsorted=False):
    rng = np.random.default_rng(seed)
    out = []
    for n in ns:
        lat, w, seg = _packed_group(rng, n, n_seg)
        if unsorted:
            seg = rng.permutation(seg)
        out.append((torch.as_tensor(lat, dtype=dtype, device=cuda),
                    torch.as_tensor(w, dtype=dtype, device=cuda),
                    torch.as_tensor(seg, device=cuda)))
    return out


def _scenarios(cuda, dtype, S, seed):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.uniform(-150.0, 400.0, (S, 1)), dtype=dtype,
                            device=cuda),
            torch.as_tensor(rng.uniform(150.0, 700.0, (S, 1)), dtype=dtype,
                            device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("S,n_seg,ns,unsorted", [
    (1000, 7, (4000, 2500, 1000), False),   # above the budget: tiled path
    (777, 300, (900, 400, 300), False),     # n_seg = 300
    (513, 4, (192, 64, 0), False),          # S one past the 512-row tile
    (2049, 5, (300, 120, 60), True),        # unsorted ids
    (600, 9, (5000, 0, 2100), True),        # tiled and unsorted
])
def test_bracket_kernel_paths_match_plain(cuda, dtype, S, n_seg, ns,
                                          unsorted):
    groups = _groups_on(cuda, dtype, ns, n_seg, seed=S + n_seg,
                        unsorted=unsorted)
    prepared = [csr_group(*g, n_seg) for g in groups]
    assert ops.bracket_resident(prepared) == (sum(ns) < 3000)
    d, x = _scenarios(cuda, dtype, S, seed=S)
    before = fused_bracket_segsum.launches
    out = fused_bracket_segsum(*prepared, d, x, n_seg)
    torch.cuda.synchronize()
    assert fused_bracket_segsum.launches == before + 1
    ref = bracket_segsum_ref(*groups, d, x, n_seg)
    tol = F64 if dtype == torch.float64 else F32
    for k in ref:
        assert out[k].shape == (S, n_seg) and out[k].dtype == dtype
        np.testing.assert_allclose(out[k].cpu().numpy(), ref[k].cpu().numpy(),
                                   **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ns", [(192, 64, 0), (4000, 2500, 1000)])
def test_bracket_kernel_rows_are_chunk_invariant(cuda, dtype, ns):
    """A scenario's row is the same bits whether it is priced with all
    others at once or in chunks of any size."""
    groups = _groups_on(cuda, dtype, ns, 4, seed=3)
    prepared = [csr_group(*g, 4) for g in groups]
    d, x = _scenarios(cuda, dtype, 5000, seed=4)
    whole = fused_bracket_segsum(*prepared, d, x, 4)
    for chunk in (1024, 700, 1):
        parts = [fused_bracket_segsum(*prepared, d[i:i + chunk],
                                      x[i:i + chunk], 4)
                 for i in range(0, 5000, chunk)] if chunk > 1 else [
            fused_bracket_segsum(*prepared, d[i:i + 1], x[i:i + 1], 4)
            for i in (0, 511, 512, 4999)]
        for k in BRACKET_NAMES:
            got = torch.cat([p[k] for p in parts])
            want = whole[k] if chunk > 1 else whole[k][[0, 511, 512, 4999]]
            assert torch.equal(got, want), (k, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [(400, 160, 40), (4000, 2500, 1000)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lo,hi", [(-1500.0, -600.0), (50.0, 900.0),
                                   (-1500.0, 900.0)])
def test_bracket_kernel_terms_all_kept_or_all_dropped(cuda, dtype, lo, hi,
                                                      ns):
    """Scenarios whose every term of a site is kept (the walk without the
    per-term test), dropped (no walk), or mixed, side by side; with the
    pairs resident and on the tiled path, where warps of one CTA that
    take different walks still meet at the window's barriers."""
    groups = _groups_on(cuda, dtype, ns, 6, seed=8)
    prepared = [csr_group(*g, 6) for g in groups]
    rng = np.random.default_rng(9)
    d = torch.as_tensor(rng.uniform(lo, hi, (1500, 1)), dtype=dtype,
                        device=cuda)
    x = torch.as_tensor(rng.uniform(150.0, 700.0, (1500, 1)), dtype=dtype,
                        device=cuda)
    out = fused_bracket_segsum(*prepared, d, x, 6)
    ref = bracket_segsum_ref(*groups, d, x, 6)
    tol = F64 if dtype == torch.float64 else F32
    for k in ref:
        np.testing.assert_allclose(out[k].cpu().numpy(), ref[k].cpu().numpy(),
                                   **tol)


def test_only_a_capture_goes_through_the_op(monkeypatch):
    """An eager call runs the op's body directly (the op's dispatch is a
    host cost a call); under fake tensors the call is the op
    ``repro_torch::fused_bracket_segsum``, which a capture records, and
    both give the plain version's shapes."""
    from repro_torch.core import graph
    calls = []
    op = ops.fused_bracket_segsum_op

    def counting(*a):
        calls.append(1)
        return op(*a)
    monkeypatch.setattr(ops, "fused_bracket_segsum_op", counting)
    rng = np.random.default_rng(3)
    groups = [(torch.as_tensor(rng.uniform(1.0, 500.0, 7)),
               torch.as_tensor(rng.uniform(0.1, 3.0, 7)),
               torch.as_tensor(np.sort(rng.integers(0, 3, 7)))) for _ in "hlm"]
    d = torch.as_tensor(rng.uniform(-150.0, 400.0, 5))
    x = torch.as_tensor(rng.uniform(150.0, 700.0, 5))
    prepared = [csr_group(*g, 3) for g in groups]    # as price() caches
    out = fused_bracket_segsum(*prepared, d, x, 3)
    assert calls == [] and all(v.shape == (5, 3) for v in out.values())
    fake = graph.abstract(fused_bracket_segsum, *prepared, d, x, 3)
    assert calls == [1] and all(v.shape == (5, 3) for v in fake.values())
    ref = bracket_segsum_ref(*groups, d, x, 3)
    assert all(torch.equal(out[k], ref[k]) for k in ref)
