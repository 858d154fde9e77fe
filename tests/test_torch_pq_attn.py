"""The ``pq_attn`` kernel's plain version (CPU route of
``repro_torch.kernels.pq_attn.ops``) held against the JAX package: its
Pallas kernel in interpret mode and its oracle, at the shapes of
``tests/test_kernels.py``, with the reference's tolerance there
(``rtol=atol=2e-4``: the ADC scores sum the table in another order than
the reconstructed keys' dot products).  Then what the kernel adds to the
reference's interface: the running max and denominator (two halves merged
through them equal the whole), and uint8 codes / bf16 tables and values
read as given (bit-equal to int32 codes and float32 copies)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pq_attn.ops import build_qlut as j_build_qlut
from repro.kernels.pq_attn.ops import encode_keys as j_encode_keys
from repro.kernels.pq_attn.ops import pq_attn_decode as j_pq_attn_decode
from repro.kernels.pq_attn.ref import pq_attn_decode_ref as j_ref
from repro.kernels.pq_attn.ref import reconstruct_keys as j_reconstruct
from repro_torch.kernels.pq_attn import ops, ref

RTOL = ATOL = 2e-4
SHAPES = [(16, 1, 1, 2, 4, 4), (64, 2, 4, 4, 16, 8), (100, 2, 8, 2, 32, 16),
          (256, 4, 8, 8, 64, 8)]   # S, G, H, M, K, Ds


def _setup(S, G, H, M, K, Ds, seed=0):
    rng = np.random.default_rng(seed)
    D = M * Ds
    q = rng.standard_normal((H, D)).astype(np.float32)
    k_books = rng.standard_normal((G, M, K, Ds)).astype(np.float32)
    k_codes = rng.integers(0, K, (S, G, M)).astype(np.int32)
    v = rng.standard_normal((S, G, D)).astype(np.float32)
    return q, k_codes, k_books, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("valid", [None, "partial"])
@pytest.mark.parametrize("S,G,H,M,K,Ds", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(S, G, H, M, K, Ds, valid):
    q, k_codes, k_books, v = _setup(S, G, H, M, K, Ds, seed=S)
    valid_len = None if valid is None else (2 * S) // 3
    got = ops.pq_attn_decode(*_t(q, k_codes, k_books, v),
                             valid_len=valid_len).numpy()
    want_kernel = np.asarray(j_pq_attn_decode(
        q, k_codes, k_books, v, valid_len=valid_len, block_s=32,
        interpret=True))
    want_oracle = np.asarray(j_ref(q, k_codes, k_books, v,
                                   valid_len=valid_len))
    np.testing.assert_allclose(got, want_kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_oracle, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ref.pq_attn_decode_ref(*_t(q, k_codes, k_books, v),
                               valid_len=valid_len).numpy(),
        want_oracle, rtol=RTOL, atol=ATOL)


def test_tables_keys_and_reconstruction_match_reference():
    q, k_codes, k_books, v = _setup(64, 2, 4, 4, 16, 8, seed=3)
    np.testing.assert_allclose(
        ops.build_qlut(*_t(q, k_books)).numpy(),
        np.asarray(j_build_qlut(q, k_books)), rtol=1e-6, atol=1e-6)
    keys = np.asarray(j_reconstruct(jnp.asarray(k_codes),
                                    jnp.asarray(k_books)))
    np.testing.assert_array_equal(
        ref.reconstruct_keys(*_t(k_codes, k_books)).numpy(), keys)
    noisy = (keys + 0.05 * np.random.default_rng(4).standard_normal(
        keys.shape)).astype(np.float32)
    got = ops.encode_keys(*_t(noisy, k_books)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_encode_keys(noisy,
                                                                k_books)))
    np.testing.assert_array_equal(got, k_codes)


def test_batched_and_stats():
    """A leading batch axis equals the rows one by one; the stats are the
    largest score and the softmax denominator."""
    B, S, G, H, M, K, Ds = 3, 40, 2, 4, 4, 16, 8
    rows = [_setup(S, G, H, M, K, Ds, seed=10 + b) for b in range(B)]
    q, codes, _, v = (np.stack([r[i] for r in rows]) for i in range(4))
    books = torch.from_numpy(rows[0][2])
    out, m, l = ops.pq_attn_decode(*_t(q, codes), books, torch.from_numpy(v),
                                   valid_len=33, return_stats=True)
    assert out.shape == (B, H, M * Ds) and m.shape == l.shape == (B, H)
    for b in range(B):
        one = ops.pq_attn_decode(*_t(q[b], codes[b]), books,
                                 torch.from_numpy(v[b]), valid_len=33)
        np.testing.assert_allclose(out[b].numpy(), one.numpy(), rtol=1e-6,
                                   atol=1e-6)
    keys = ref.reconstruct_keys(torch.from_numpy(codes[:, :33]), books)
    scores = torch.einsum("bgrd,bsgd->bgrs",
                          torch.from_numpy(q).reshape(B, G, H // G, -1),
                          keys) / (M * Ds) ** 0.5
    want_m = scores.amax(-1)
    want_l = torch.exp(scores - want_m[..., None]).sum(-1)
    np.testing.assert_allclose(m.numpy(), want_m.reshape(B, H).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), want_l.reshape(B, H).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split", [0, 1, 57, 100])
def test_two_halves_merged_through_stats_equal_the_whole(split):
    B, S, G, R, M, K, Dv = 2, 100, 2, 2, 4, 16, 8
    rng = np.random.default_rng(split)
    qlut = torch.from_numpy(rng.standard_normal((B, G * R, M, K)).astype(
        np.float32))
    codes = torch.from_numpy(rng.integers(0, K, (B, S, G, M)).astype(
        np.uint8))
    v = torch.from_numpy(rng.standard_normal((B, S, G, Dv)).astype(
        np.float32))
    whole, _, _ = ops.pq_attn(qlut, codes, v, S, 0.5)
    o1, m1, l1 = ops.pq_attn(qlut, codes, v, split, 0.5)
    o2, m2, l2 = ops.pq_attn(qlut, codes[:, split:].contiguous(),
                             v[:, split:].contiguous(), S - split, 0.5)
    m = torch.maximum(m1, m2)
    w1 = (l1 * torch.exp(m1 - m))[..., None]
    w2 = (l2 * torch.exp(m2 - m))[..., None]
    merged = (o1 * w1 + o2 * w2) / (w1 + w2)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_empty_prefix():
    qlut = torch.ones((1, 2, 2, 4))
    codes = torch.zeros((1, 5, 1, 2), dtype=torch.uint8)
    v = torch.ones((1, 5, 1, 8))
    out, m, l = ops.pq_attn(qlut, codes, v, 0, 1.0)
    assert torch.equal(out, torch.zeros((1, 2, 8)))
    assert torch.equal(m, torch.full((1, 2), ref.NEG_INIT))
    assert torch.equal(l, torch.zeros((1, 2)))


def _oracle(qlut, codes, v, start, stop, scale):
    """numpy: softmax over ``[start, stop)`` of ``scale * sum_m qlut[h, m,
    code]`` in float64 -> (out, m, l)."""
    B, H, M, K = qlut.shape
    G = codes.shape[2]
    R = H // G
    out = np.zeros((B, H, v.shape[-1]))
    m = np.full((B, H), ref.NEG_INIT)
    l = np.zeros((B, H))
    for b in range(B):
        for h in range(H):
            g = h // R
            if stop <= start:
                continue
            sc = np.array([scale * sum(float(qlut[b, h, mm, codes[b, s, g, mm]])
                                       for mm in range(M))
                           for s in range(start, stop)])
            m[b, h] = sc.max()
            e = np.exp(sc - sc.max())
            l[b, h] = e.sum()
            out[b, h] = (e[:, None] * v[b, start:stop, g]).sum(0) / e.sum()
    return out, m, l


@pytest.mark.parametrize("start,stop", [(0, 77), (13, 77), (64, 100),
                                        (99, 100), (40, 40), (70, 30),
                                        (100, 100)])
def test_window_start_against_numpy_oracle(start, stop):
    """Positions ``[start, valid_len)``: a window's tail (gemma2's local
    layers), one position, and empty ranges (``start >= valid_len``),
    against a float64 numpy oracle within ``RTOL``/``ATOL``."""
    B, S, G, R, M, K, Dv = 2, 100, 2, 2, 4, 16, 8
    rng = np.random.default_rng(start * 101 + stop)
    qlut = rng.standard_normal((B, G * R, M, K)).astype(np.float32)
    codes = rng.integers(0, K, (B, S, G, M)).astype(np.uint8)
    v = rng.standard_normal((B, S, G, Dv)).astype(np.float32)
    got = ops.pq_attn(*_t(qlut, codes, v), stop, 0.4, start)
    want = _oracle(qlut, codes, v, start, stop, 0.4)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
    if stop <= start:
        empty = ops.pq_attn(*_t(qlut, codes, v), 0, 0.4)
        for g, e in zip(got, empty):
            assert torch.equal(g, e)


def test_window_start_equals_shifted_prefix():
    """``[start, valid_len)`` is the prefix of ``valid_len - start``
    positions of the cache shifted by ``start``, bit for bit."""
    B, S, G, R, M, K, Dv = 2, 90, 2, 4, 4, 16, 8
    rng = np.random.default_rng(3)
    qlut, codes, v = _t(
        rng.standard_normal((B, G * R, M, K)).astype(np.float32),
        rng.integers(0, K, (B, S, G, M)).astype(np.uint8),
        rng.standard_normal((B, S, G, Dv)).astype(np.float32))
    got = ops.pq_attn(qlut, codes, v, 81, 0.5, 17)
    want = ops.pq_attn(qlut, codes[:, 17:].contiguous(),
                       v[:, 17:].contiguous(), 64, 0.5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="start"):
        ops.pq_attn(qlut, codes, v, 81, 0.5, S + 1)


def test_storage_types_read_as_given():
    """uint8 codes equal int32 codes; a bf16 table and bf16 values equal
    float32 copies of the same (rounded) numbers, bit for bit."""
    B, S, G, R, M, K, Dv = 2, 70, 2, 2, 4, 16, 8
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.standard_normal((B, G * R, M, K)).astype(
        np.float32)).to(torch.bfloat16)
    codes = torch.from_numpy(rng.integers(0, K, (B, S, G, M)).astype(
        np.uint8))
    v = torch.from_numpy(rng.standard_normal((B, S, G, Dv)).astype(
        np.float32)).to(torch.bfloat16)
    want = ops.pq_attn(table.float(), codes.to(torch.int32), v.float(), 61,
                       0.3)
    got = ops.pq_attn(table, codes, v, 61, 0.3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bad_shapes_raise():
    qlut = torch.ones((1, 2, 2, 4))
    v = torch.ones((1, 5, 1, 8))
    with pytest.raises(ValueError, match="valid_len"):
        ops.pq_attn(qlut, torch.zeros((1, 5, 1, 2), dtype=torch.uint8), v,
                    6, 1.0)
    with pytest.raises(ValueError, match="disagree"):
        ops.pq_attn(qlut, torch.zeros((1, 5, 1, 3), dtype=torch.uint8), v,
                    5, 1.0)


# The kernel's split over the valid prefix (pure Python, chosen from the
# shapes alone): every position lies in exactly one split, no split is
# empty, none starts beyond valid_len.
@pytest.mark.parametrize("rows", [1, 6, 24, 64, 512, 4096])
@pytest.mark.parametrize("valid_len", [1, 2, 63, 64, 65, 77, 255, 256, 257,
                                       1921, 2080, 32768, 200_000])
def test_split_geometry_covers_valid_len(valid_len, rows):
    chunk, n_split = ops.split_geometry(valid_len, rows)
    assert chunk % 64 == 0 and 64 <= chunk
    assert chunk <= 1024 or n_split == 65535 or chunk * 65535 >= valid_len
    assert 1 <= n_split <= 65535
    assert (n_split - 1) * chunk < valid_len <= n_split * chunk


def test_split_geometry_serving_shape_and_empty_prefix():
    # B=8, G=8 rows at the serving tail: 8 splits of 256, 512 CTAs
    assert ops.split_geometry(1921, 64) == (256, 8)
    assert ops.split_geometry(0, 64) == (64, 1)
    # at least 2 CTAs a SM when the prefix allows it, one split when short
    chunk, n_split = ops.split_geometry(2080, 24)
    assert (chunk, n_split) == (128, 17) and 24 * n_split >= 2 * 132
    assert ops.split_geometry(40, 64) == (64, 1)
    # more splits than the grid allows: the chunk grows past 1024
    chunk, n_split = ops.split_geometry(100_000_000, 1)
    assert n_split <= 65535 and chunk > 1024


@pytest.mark.parametrize("rows,n_split,reps,Dv", [(64, 8, 2, 128),
                                                  (6, 2, 4, 32),
                                                  (24, 17, 8, 64),
                                                  (8, 1, 2, 128)])
def test_workspace_floats(rows, n_split, reps, Dv):
    want = 0 if n_split == 1 else rows * n_split * reps * Dv \
        + rows * n_split * reps * 2
    assert ops.workspace_floats(rows, n_split, reps, Dv) == want


@pytest.mark.parametrize("dtype,Dv,offset,want", [
    (torch.bfloat16, 128, 0, 8), (torch.bfloat16, 132, 0, 4),
    (torch.bfloat16, 128, 4, 4), (torch.float32, 128, 0, 4)])
def test_value_vector(dtype, Dv, offset, want):
    v = torch.zeros(2 * Dv + 8, dtype=dtype)[offset:offset + Dv]
    assert ops.value_vector(v) == want
