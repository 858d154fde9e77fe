"""The port's quantised ADC tables (``quantize_lut``, ``lut_dtype`` in the
dispatch and in ``pq.cdist_sym``; CPU route) held against the JAX package
on the same seeded numpy inputs.

The int8 codes, ``scale`` and ``zero`` and the bfloat16 table are
identical to the reference's: the port reproduces its compiled arithmetic
(the division by 254 as a product with float32 ``1/254``, the dequantising
``q * scale + zero`` as one fused multiply-add).  Distances agree within
``rtol=1e-5, atol=1e-4``: the subspace sum runs in another order.
"""

import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import pq as jpq
from repro.kernels.pq_adc.ops import quantize_lut as jquantize_lut
from repro.kernels.pq_adc.ref import _dequant as jdequant
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import pq as tpq
from repro_torch.kernels.pq_adc.ops import (adc_lookup_quant,
                                           adc_sym_cdist_quant, quantize_lut)
from repro_torch.kernels.pq_adc.ref import dequantize

TOL = dict(rtol=1e-5, atol=1e-4)
DTYPES = ("int8", "bfloat16", "bf16")


def _lut(seed, shape, spread=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32) ** 2 * spread)


def _codes(seed, n, M, K):
    return np.random.default_rng(seed).integers(0, K, (n, M)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _same_table(got, want):
    """The quantised table, scale and zero, bit for bit."""
    q, scale, zero = got
    jq, jscale, jzero = (np.asarray(x) for x in want)
    if q.dtype == torch.bfloat16:
        np.testing.assert_array_equal(q.float().numpy(),
                                      jq.astype(np.float32))
    else:
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), jq)
    for g, w in ((scale, jscale), (zero, jzero)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,spread", [((4, 16, 16), 1.0),
                                          ((8, 32, 32), 250.0),
                                          ((3, 8), 1e-3), ((8, 256), 7.0)])
def test_quantize_lut_matches_jax(dtype, shape, spread):
    lut = _lut(sum(shape), shape, spread)
    _same_table(quantize_lut(_t(lut), dtype), jquantize_lut(lut, dtype))


def test_quantize_lut_constant_subspace():
    """A subspace with one value (range 0) takes the 1e-12 floor."""
    lut = _lut(1, (3, 8, 8))
    lut[1] = 2.5
    _same_table(quantize_lut(_t(lut), "int8"), jquantize_lut(lut, "int8"))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_dequantize_matches_jax(dtype):
    """The dequantised table: the reference's compiled fused multiply-add."""
    import jax
    lut = _lut(3, (4, 16, 16), 40.0)
    q, scale, zero = jquantize_lut(lut, dtype)
    want = np.asarray(jax.jit(jdequant)(q, scale, zero))
    got = dequantize(*quantize_lut(_t(lut), dtype))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,na,nb", [(4, 16, 12, 12), (8, 64, 9, 31),
                                       (3, 8, 1, 5)])
def test_adc_cdist_quant_matches_jax(dtype, M, K, na, nb):
    lut = _lut(M * K, (M, K, K), 3.0)
    ca, cb = _codes(1, na, M, K), _codes(2, nb, M, K)
    with jdispatch.use_backend("jax"):
        want = np.asarray(jdispatch.adc_cdist(ca, cb, lut, lut_dtype=dtype))
        full = np.asarray(jdispatch.adc_cdist(ca, cb, lut))
    tdispatch.reset_stats()
    got = tdispatch.adc_cdist(_t(ca), _t(cb), _t(lut), lut_dtype=dtype)
    assert tdispatch.stats[("adc_cdist_quant", "torch")] == 1
    assert ("adc_cdist", "torch") not in tdispatch.stats
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the reference's own bound against float32
    assert np.abs(got.numpy() - full).max() / (np.abs(full).max() + 1e-6) \
        < 0.02


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,n", [(4, 16, 12), (8, 256, 37)])
def test_adc_lookup_quant_matches_jax(dtype, M, K, n):
    qlut = _lut(K + M, (M, K), 5.0)
    codes = _codes(3, n, M, K)
    with jdispatch.use_backend("jax"):
        want = np.asarray(jdispatch.adc_lookup(codes, qlut, lut_dtype=dtype))
        full = np.asarray(jdispatch.adc_lookup(codes, qlut))
    tdispatch.reset_stats()
    got = tdispatch.adc_lookup(_t(codes), _t(qlut), lut_dtype=dtype)
    assert tdispatch.stats[("adc_lookup_quant", "torch")] == 1
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(got.numpy() - full).max() / (np.abs(full).max() + 1e-6) \
        < 0.02


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_adc_lookup_quant_batched_per_query(dtype):
    """``(Nq, M, K)`` tables: each query's table is quantised on its own,
    as the reference quantises one query's, so every row equals the
    reference's single-query result."""
    Nq, M, K = 5, 4, 16
    rng = np.random.default_rng(4)
    # queries on very different scales: a joint quantisation would differ
    qluts = _lut(5, (Nq, M, K)) * (10.0 ** rng.integers(-2, 3, (Nq, 1, 1)))
    qluts = qluts.astype(np.float32)
    codes = _codes(6, 23, M, K)
    got = tdispatch.adc_lookup(_t(codes), _t(qluts), lut_dtype=dtype)
    assert got.shape == (Nq, 23)
    with jdispatch.use_backend("jax"):
        for i in range(Nq):
            want = np.asarray(jdispatch.adc_lookup(codes, qluts[i],
                                                   lut_dtype=dtype))
            np.testing.assert_allclose(got[i].numpy(), want, **TOL)
            single = tdispatch.adc_lookup(_t(codes), _t(qluts[i]),
                                          lut_dtype=dtype)
            np.testing.assert_array_equal(got[i].numpy(), single.numpy())


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("M,K,n,Nq", [(4, 16, 37, 19), (3, 16, 21, 5),
                                      (16, 32, 17, 33)])
def test_adc_lookup_quant_shapes_match_jax(dtype, M, K, n, Nq):
    """Batched quantised lookups at shapes the kernel's tiles cut short
    (query and code counts not a multiple of 16, M = 3 at K = 16, M = 16)
    equal the reference's single-query quantised lookups."""
    qluts = _lut(M + Nq, (Nq, M, K), 3.0)
    codes = _codes(M + n, n, M, K)
    got = tdispatch.adc_lookup(_t(codes), _t(qluts), lut_dtype=dtype)
    assert got.shape == (Nq, n)
    with jdispatch.use_backend("jax"):
        want = np.stack([np.asarray(jdispatch.adc_lookup(codes, q,
                                                         lut_dtype=dtype))
                         for q in qluts])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_pq_cdist_sym_lut_dtype_matches_jax(dtype):
    M, K = 4, 16
    lut = _lut(9, (M, K, K), 2.0)
    ca, cb = _codes(7, 10, M, K), _codes(8, 14, M, K)
    with jdispatch.use_backend("jax"):
        want = np.asarray(jpq.cdist_sym(ca, cb, lut, lut_dtype=dtype))
    got = tpq.cdist_sym(ca, cb, lut, lut_dtype=dtype, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_quant_wrappers_check_their_inputs():
    q, scale, zero = quantize_lut(_t(_lut(1, (4, 16, 16))), "int8")
    codes = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int8 or bfloat16"):
        adc_sym_cdist_quant(codes, codes, q.float(), scale, zero)
    with pytest.raises(ValueError, match="scale"):
        adc_sym_cdist_quant(codes, codes, q, scale[:2], zero)
    with pytest.raises(ValueError, match="outside"):
        adc_sym_cdist_quant(codes + 16, codes, q, scale, zero)
    with pytest.raises(ValueError, match="must be"):
        adc_lookup_quant(codes, q[None], scale, zero)


@pytest.mark.parametrize("dtype", ["fp4", "int4", "float16"])
def test_unknown_lut_dtype_raises(dtype):
    codes = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        tdispatch.adc_cdist(codes, codes, torch.zeros((2, 4, 4)),
                            lut_dtype=dtype)
    with pytest.raises(ValueError, match="dtype"):
        tdispatch.adc_lookup(codes, torch.zeros((2, 4)), lut_dtype=dtype)
