"""The port's PQ distance scans (CPU route) held against the JAX package's
``adc_cdist`` / ``adc_lookup``.  Tolerance ``rtol=1e-6``: the sums over
the M subspaces may run in another order than XLA's reduction."""

import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro_torch.core import dispatch as tdispatch

TOL = dict(rtol=1e-6, atol=1e-6)


def _codes_and_tables(seed, M=4, K=16, Na=11, Nb=9, Nq=3):
    rng = np.random.default_rng(seed)
    lut = np.abs(rng.standard_normal((M, K, K))).astype(np.float32)
    ca = rng.integers(0, K, (Na, M)).astype(np.int32)
    cb = rng.integers(0, K, (Nb, M)).astype(np.int32)
    qlut = np.abs(rng.standard_normal((Nq, M, K))).astype(np.float32)
    return lut, ca, cb, qlut


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adc_cdist_matches_jax(seed):
    lut, ca, cb, _ = _codes_and_tables(seed)
    with jdispatch.use_backend("jax"):
        want = np.asarray(jdispatch.adc_cdist(ca, cb, lut))
    got = tdispatch.adc_cdist(torch.from_numpy(ca), torch.from_numpy(cb),
                              torch.from_numpy(lut))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adc_lookup_matches_jax(seed):
    _, ca, _, qlut = _codes_and_tables(seed)
    with jdispatch.use_backend("jax"):
        want = np.stack([np.asarray(jdispatch.adc_lookup(ca, q))
                         for q in qlut])
    codes = torch.from_numpy(ca)
    single = tdispatch.adc_lookup(codes, torch.from_numpy(qlut[0]))
    batch = tdispatch.adc_lookup(codes, torch.from_numpy(qlut))
    assert single.shape == (ca.shape[0],)
    assert batch.shape == (qlut.shape[0], ca.shape[0])
    np.testing.assert_allclose(single.numpy(), want[0], **TOL)
    np.testing.assert_allclose(batch.numpy(), want, **TOL)


@pytest.mark.parametrize("M,K,Nb,Nq", [(4, 16, 37, 19), (3, 16, 21, 5),
                                       (16, 32, 17, 33), (8, 256, 45, 7)])
def test_adc_lookup_shapes_match_jax(M, K, Nb, Nq):
    """Batched lookups at shapes the kernel's tiles cut short (query and
    code counts not a multiple of 16, M = 3 at K = 16, M = 16) equal the
    reference's single-query lookups."""
    _, _, cb, qlut = _codes_and_tables(11 + M, M=M, K=K, Nb=Nb, Nq=Nq)
    with jdispatch.use_backend("jax"):
        want = np.stack([np.asarray(jdispatch.adc_lookup(cb, q))
                         for q in qlut])
    got = tdispatch.adc_lookup(torch.from_numpy(cb), torch.from_numpy(qlut))
    assert got.shape == (Nq, Nb)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_adc_matches_pallas_interpret():
    lut, ca, cb, qlut = _codes_and_tables(7, M=2, K=8, Na=4, Nb=5)
    with jdispatch.use_backend("pallas_interpret"):
        want_c = np.asarray(jdispatch.adc_cdist(ca, cb, lut))
        want_l = np.asarray(jdispatch.adc_lookup(ca, qlut[0]))
    got_c = tdispatch.adc_cdist(torch.from_numpy(ca), torch.from_numpy(cb),
                                torch.from_numpy(lut))
    got_l = tdispatch.adc_lookup(torch.from_numpy(ca),
                                 torch.from_numpy(qlut[0]))
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=1e-5, atol=1e-5)


def test_codes_out_of_range_raise():
    lut, ca, cb, qlut = _codes_and_tables(3)
    bad = torch.from_numpy(ca).clone()
    bad[0, 0] = lut.shape[1]
    with pytest.raises(ValueError, match="outside"):
        tdispatch.adc_cdist(bad, torch.from_numpy(cb), torch.from_numpy(lut))
    with pytest.raises(ValueError, match="outside"):
        tdispatch.adc_lookup(-torch.ones_like(bad), torch.from_numpy(qlut))
    with pytest.raises(ValueError):
        tdispatch.adc_cdist(torch.from_numpy(ca)[:, :2], torch.from_numpy(cb),
                            torch.from_numpy(lut))


@pytest.mark.parametrize("which", ["codes_a", "codes_b"])
def test_out_of_range_names_the_tensor(which):
    lut, ca, cb, _ = _codes_and_tables(5)
    codes = {"codes_a": torch.from_numpy(ca), "codes_b": torch.from_numpy(cb)}
    codes[which] = codes[which].clone()
    codes[which][-1, -1] = -1
    with pytest.raises(ValueError, match=f"{which} holds codes outside"):
        tdispatch.adc_cdist(codes["codes_a"], codes["codes_b"],
                            torch.from_numpy(lut))


def test_adc_ledger_counts():
    lut, ca, cb, qlut = _codes_and_tables(4)
    tdispatch.reset_stats()
    tdispatch.adc_cdist(torch.from_numpy(ca), torch.from_numpy(cb),
                        torch.from_numpy(lut))
    tdispatch.adc_lookup(torch.from_numpy(ca), torch.from_numpy(qlut))
    assert tdispatch.stats == {("adc_cdist", "torch"): 1,
                               ("adc_lookup", "torch"): 1}
