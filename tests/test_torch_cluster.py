"""The port's evaluation helpers held against the JAX package:
hierarchical clustering (``linkage``, ``cut_k``, ``hierarchical_labels``)
and the Rand indices bit for bit, ``registry_rows`` equal, and ``dba``
within the kernel tests' tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cluster as jcluster
from repro.core.dba import dba as jdba
from repro.core import measures as jmeasures
from repro.core import metrics as jmetrics
from repro_torch.core import cluster as tcluster
from repro_torch.core.dba import dba as tdba
from repro_torch.core import measures as tmeasures
from repro_torch.core import metrics as tmetrics

METHODS = ("single", "complete", "average")


def _dist(seed: int, n: int, ties: bool = False) -> np.ndarray:
    """A symmetric float32 distance matrix with a zero diagonal; with
    ``ties`` its values are rounded to one decimal, so merges tie."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3))
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    if ties:
        d = np.round(d, 1)
    return d.astype(np.float32)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,seed,ties", [(2, 0, False), (7, 1, False),
                                         (30, 2, False), (30, 3, True)])
def test_linkage_bit_identical(method, n, seed, ties):
    d = _dist(seed, n, ties)
    want = jcluster.linkage(d, method)
    np.testing.assert_array_equal(tcluster.linkage(d, method), want)
    np.testing.assert_array_equal(
        tcluster.linkage(torch.from_numpy(d), method), want)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("k", [1, 2, 5, 29, 30, 31, 40])
def test_labels_bit_identical(method, k):
    d = _dist(4, 30, ties=True)
    want = jcluster.hierarchical_labels(d, k, method)
    got = tcluster.hierarchical_labels(torch.from_numpy(d), k, method)
    np.testing.assert_array_equal(got, want)
    if k < 30:
        Z = jcluster.linkage(d, method)
        np.testing.assert_array_equal(tcluster.cut_k(Z, 30, k),
                                      jcluster.cut_k(Z, 30, k))


def _label_pairs():
    rng = np.random.default_rng(5)
    yield rng.integers(0, 3, 50), rng.integers(0, 4, 50)
    a = rng.integers(0, 5, 40)
    yield a, a                                   # identical partitions
    yield np.zeros(12, int), np.zeros(12, int)   # one cluster each
    yield np.arange(9), np.arange(9)             # singletons each
    yield np.array([0, 0, 1, 1]), np.array([1, 1, 0, 0])


@pytest.mark.parametrize("i", range(5))
def test_rand_indices_equal_reference(i):
    a, b = list(_label_pairs())[i]
    for got_b in (b, torch.from_numpy(b)):
        assert tmetrics.rand_index(a, got_b) == jmetrics.rand_index(a, b)
        assert (tmetrics.adjusted_rand_index(a, got_b)
                == jmetrics.adjusted_rand_index(a, b))


def test_adjusted_rand_index_degenerate_branch():
    """One cluster on both sides: the largest and the expected index
    coincide, and both packages return 1.0."""
    a = np.zeros(6, int)
    assert tmetrics.adjusted_rand_index(a, a) == 1.0
    assert jmetrics.adjusted_rand_index(a, a) == 1.0


def test_registry_rows_equal_reference():
    assert tmeasures.registry_rows() == jmeasures.registry_rows()


def test_measure_labels_equal_reference():
    for name in ("dtw", "erp:g=1", "wdtw:g=0.25", "msm"):
        assert (tmeasures.resolve(name).label
                == jmeasures.resolve(name).label)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("iters", [1, 3])
def test_dba_matches_reference(window, iters):
    rng = np.random.default_rng(6)
    X = rng.standard_normal((9, 24)).astype(np.float32)
    c0 = X[2]
    want = np.asarray(jdba(jnp.asarray(c0), jnp.asarray(X), iters=iters,
                           window=window))
    got = tdba(torch.from_numpy(c0), torch.from_numpy(X), iters=iters,
               window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
