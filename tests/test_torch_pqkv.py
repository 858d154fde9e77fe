"""The port's PQ-KV cache (``repro_torch.serve.pqkv``) held against the JAX
package on the CPU.

Codes are compared exactly (``encode_kv``, and ``compress_cache`` given
the reference's own books, which the port cannot draw: ``jax.random``).
Decode attention's plain route is the reference's arithmetic step by
step, so its bf16 output agrees within one bf16 ulp at the output's scale
(``_ulps``; float32 sums in another order, then one rounding).  The
kernel route (here through the kernel's plain version) softmaxes online
and skips the bf16 rounding of the tail weights, so it agrees at the
reference's own PQ-KV tolerance, ``2e-2`` (``tests/test_pqkv.py``).
One ``pq_serve_step`` on the reference's weights and cache: logits within
``2e-2``, the updated cache's codes equal and its bf16 tensors within one
ulp at their scale (XLA keeps some bf16 intermediates in float32; see
``tests/test_torch_lm.py``).  The same tolerances hold gemma2's local
windows (both routes), ``mode="topk"`` and ``quantize_v=True`` (plain
route), and two PQ decode steps of the reduced gemma2, moe and vlm
configs in every mode.
"""

import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JModelConfig
from repro.serve import pqkv as jpq
from repro.serve.cache import init_cache as j_init_cache
from repro.serve.prefill import prefill as j_prefill
from repro_torch.configs import registry as tregistry
from repro_torch.core.kmeans import euclidean_kmeans
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.serve import pqkv as tpq

CPU = "cpu"
PQ_TOL = 2e-2
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16)


def _ulps(got, want) -> float:
    """Largest difference in units of one bf16 ulp at ``want``'s largest
    magnitude."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)
    return float(np.abs(got - want).max() / ulp)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(a, np.float32)
                                  if dtype is torch.bfloat16 else a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

def test_encode_decode_match_reference():
    rng = np.random.default_rng(0)
    G, M, K, Ds = 2, 4, 16, 4
    books = rng.standard_normal((G, M, K, Ds)).astype(np.float32)
    x = rng.standard_normal((3, 9, G, M * Ds)).astype(np.float32)
    want = np.asarray(jpq.encode_kv(x, books))
    got = tpq.encode_kv(_t(x), _t(books))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpq.decode_kv(got, _t(books)).numpy(),
        np.asarray(jpq.decode_kv(jnp.asarray(want), books)))
    # bf16 keys, as the cache holds them
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(
        tpq.encode_kv(_t(xb, torch.bfloat16), _t(books)).numpy(),
        np.asarray(jpq.encode_kv(jnp.asarray(xb), books)))


# ---------------------------------------------------------------------------
# Decode attention, one layer
# ---------------------------------------------------------------------------

def _layer(S, W, pos, seed=0, B=2, G=2, R=2, hd=16, M=4, K=16,
           coded_v=False):
    """Random q/k/v, random books, and the ring holding positions
    ``<= pos`` at slot ``p % W``; both packages' layer caches (``coded_v``:
    the values coded with their own random books)."""
    rng = np.random.default_rng(seed)
    bf = jnp.bfloat16
    q = jnp.asarray(rng.standard_normal((B, G, R, hd)), jnp.float32).astype(bf)
    k = jnp.asarray(rng.standard_normal((B, S, G, hd)), jnp.float32).astype(bf)
    v = jnp.asarray(rng.standard_normal((B, S, G, hd)), jnp.float32).astype(bf)
    books = jnp.asarray(rng.standard_normal((G, M, K, hd // M)), jnp.float32)
    codes = jpq.encode_kv(k, books)
    ring_k = np.zeros((B, W, G, hd), np.float32)
    ring_v = np.zeros((B, W, G, hd), np.float32)
    for p in range(pos + 1):
        ring_k[:, p % W] = np.asarray(k[:, p], np.float32)
        ring_v[:, p % W] = np.asarray(v[:, p], np.float32)
    ring_k, ring_v = jnp.asarray(ring_k).astype(bf), jnp.asarray(ring_v).astype(bf)
    if coded_v:
        v_books = jnp.asarray(rng.standard_normal((G, M, K, hd // M)),
                              jnp.float32)
        v_codes = jpq.encode_kv(v, v_books)
        jcache = (codes, books, None, v_codes, v_books, ring_k, ring_v)
        v_part = dict(v=None, v_codes=torch.from_numpy(np.array(v_codes)),
                      v_books=_t(v_books))
    else:
        jcache = (codes, books, v, None, None, ring_k, ring_v)
        v_part = dict(v=_t(v, torch.bfloat16))
    tcache = tpq.PQKVCache(
        k_codes=torch.from_numpy(np.array(codes)), k_books=_t(books),
        k_recent=_t(ring_k, torch.bfloat16),
        v_recent=_t(ring_v, torch.bfloat16), **v_part)
    return q, jcache, _t(q, torch.bfloat16), tcache


@pytest.mark.parametrize("S,W,pos", [(32, 8, 5), (32, 8, 20), (32, 8, 31),
                                     (16, 16, 15), (16, 32, 9)],
                         ids=["pos<W", "pos>=W", "last", "W=S", "W>S"])
def test_attention_decode_matches_reference(S, W, pos):
    jq, jcache, tq, tcache = _layer(S, W, pos, seed=S + W + pos)
    pqc_kw = dict(n_sub=4, codebook_size=16, recent_window=W)
    want = np.asarray(jpq.pq_attention_decode(
        jq, jcache, jnp.int32(pos), pqc=jpq.PQKVConfig(**pqc_kw)), np.float32)
    pqc = tpq.PQKVConfig(**pqc_kw)
    plain = tpq.pq_attention_decode(tq, tcache, pos, pqc=pqc)
    kernel = tpq.pq_attention_decode(tq, tcache, pos, pqc=pqc,
                                     route="kernel")
    assert plain.dtype == kernel.dtype == torch.bfloat16
    assert plain.shape == tq.shape
    assert _ulps(plain.float(), want) <= 1
    np.testing.assert_allclose(kernel.float().numpy(), want, rtol=PQ_TOL,
                               atol=PQ_TOL)
    # the default route for CPU tensors is the plain one
    assert torch.equal(tpq.pq_attention_decode(tq, tcache, pos, pqc=pqc),
                       plain)


@pytest.mark.parametrize("S,W,pos,window", [
    (64, 8, 40, 16), (64, 8, 63, 24), (64, 8, 20, 8), (64, 8, 12, 40),
    (64, 16, 50, 4), (32, 8, 31, 31)],
    ids=["tail-cut", "last", "window=W", "window>pos", "window<W",
         "window~S"])
def test_windowed_attention_decode_matches_reference(S, W, pos, window):
    """gemma2's local layers: the tail ``(pos - window, pos - W]`` and the
    ring's slots after ``pos - window``; empty tails (``window <= W``)
    included.  The plain route within one ulp, the kernel route (a window
    start on ``pq_attn``) within ``PQ_TOL``."""
    jq, jcache, tq, tcache = _layer(S, W, pos, seed=S + W + pos + window)
    kw = dict(n_sub=4, codebook_size=16, recent_window=W)
    want = np.asarray(jpq.pq_attention_decode(
        jq, jcache, jnp.int32(pos), pqc=jpq.PQKVConfig(**kw),
        window=window), np.float32)
    pqc = tpq.PQKVConfig(**kw)
    plain = tpq.pq_attention_decode(tq, tcache, pos, pqc=pqc, window=window)
    kernel = tpq.pq_attention_decode(tq, tcache, pos, pqc=pqc, window=window,
                                     route="kernel")
    assert _ulps(plain.float(), want) <= 1
    np.testing.assert_allclose(kernel.float().numpy(), want, rtol=PQ_TOL,
                               atol=PQ_TOL)
    start, stop = tpq.tail_range(pos, W, window)
    assert (start, stop) == (max(pos - window + 1, 0), max(pos - W + 1, 0))


@pytest.mark.parametrize("coded_v", [False, True], ids=["exact_v", "coded_v"])
@pytest.mark.parametrize("top_t,window", [(4, 0), (9, 0), (32, 0), (40, 0),
                                          (4, 20)])
def test_topk_matches_reference(top_t, window, coded_v):
    """``mode="topk"``: the top ``top_t`` ADC-scored tail positions' values
    (exact or decoded from their codes) and the exact ring, within one ulp
    of the reference; ``top_t >= S`` included."""
    S, W, pos = 32, 8, 27
    jq, jcache, tq, tcache = _layer(S, W, pos, seed=top_t + window,
                                    coded_v=coded_v)
    kw = dict(n_sub=4, codebook_size=16, recent_window=W, mode="topk",
              top_t=top_t)
    want = np.asarray(jpq.pq_attention_decode(
        jq, jcache, jnp.int32(pos), pqc=jpq.PQKVConfig(**kw),
        window=window), np.float32)
    got = tpq.pq_attention_decode(tq, tcache, pos, pqc=tpq.PQKVConfig(**kw),
                                  window=window)
    assert got.dtype == torch.bfloat16
    assert _ulps(got.float(), want) <= 1


def test_topk_covers_softmax_when_t_is_s():
    """top-T with T = S reduces to the dense softmax route (the reference's
    ``tests/test_pqkv.py`` check, at its tolerance ``2e-2``)."""
    jq, jcache, tq, tcache = _layer(16, 4, 15, seed=11)
    dense = tpq.pq_attention_decode(tq, tcache, 15,
                                    pqc=tpq.PQKVConfig(recent_window=4))
    sparse = tpq.pq_attention_decode(
        tq, tcache, 15, pqc=tpq.PQKVConfig(recent_window=4, mode="topk",
                                           top_t=16))
    np.testing.assert_allclose(dense.float().numpy(), sparse.float().numpy(),
                               rtol=PQ_TOL, atol=PQ_TOL)


@pytest.mark.parametrize("S,W,pos,window", [(32, 8, 20, 0), (32, 8, 31, 0),
                                            (16, 16, 15, 0), (64, 8, 50, 20),
                                            (300, 16, 299, 0)])
def test_quantize_v_matches_reference(S, W, pos, window):
    """Coded values, ``mode="softmax"``: the softmax mass aggregated per
    codeword times the value books, within one ulp of the reference (at S
    = 300 its contraction runs in chunks of 256 positions)."""
    jq, jcache, tq, tcache = _layer(S, W, pos, seed=pos, coded_v=True)
    kw = dict(n_sub=4, codebook_size=16, recent_window=W, quantize_v=True)
    want = np.asarray(jpq.pq_attention_decode(
        jq, jcache, jnp.int32(pos), pqc=jpq.PQKVConfig(**kw),
        window=window), np.float32)
    got = tpq.pq_attention_decode(tq, tcache, pos,
                                  pqc=tpq.PQKVConfig(**kw), window=window)
    assert _ulps(got.float(), want) <= 1


# ---------------------------------------------------------------------------
# compress_cache and one pq_serve_step on the reference's model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """The tiny model's reference weights, a reference prefill of a
    24-token prompt into a 32-slot cache, and the reference's PQ cache."""
    jcfg, tcfg = JModelConfig(**TINY), ModelConfig(**TINY)
    npp = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    jp = jax.tree.map(jnp.asarray, npp)
    tp = tlm.params_from_numpy(npp, tcfg, device=CPU)
    B, S, max_len = 2, 24, 32
    toks = np.random.default_rng(0).integers(0, 128, (B, S)).astype(np.int32)
    jl, jc = jax.jit(lambda p, c, t: j_prefill(p, jcfg, c, {"tokens": t}))(
        jp, j_init_cache(jcfg, B, max_len), jnp.asarray(toks))
    kw = dict(n_sub=4, codebook_size=16, recent_window=8, kmeans_iters=3,
              fit_sample=32)
    jpqc, tpqc = jpq.PQKVConfig(**kw), tpq.PQKVConfig(**kw)
    jpc = jpq.compress_cache(jc, jcfg, jpqc, pos=S,
                             key=jax.random.PRNGKey(1))
    tcache = {"k": _t(jc["k"], torch.bfloat16),
              "v": _t(jc["v"], torch.bfloat16)}
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, S=S, jl=jl, jc=jc,
                jpqc=jpqc, tpqc=tpqc, jpc=jpc, tcache=tcache)


def _port_pq_cache(sv):
    return tpq.compress_cache(
        {"k": sv["tcache"]["k"], "v": sv["tcache"]["v"].clone()},
        sv["tcfg"], sv["tpqc"], pos=sv["S"], books=_t(sv["jpc"].k_books))


def test_compress_cache_from_reference_books(served):
    jpc, tpc = served["jpc"], _port_pq_cache(served)
    np.testing.assert_array_equal(tpc.k_codes.numpy(),
                                  np.asarray(jpc.k_codes))
    np.testing.assert_array_equal(tpc.k_books.numpy(),
                                  np.asarray(jpc.k_books))
    for name in ("v", "k_recent", "v_recent"):
        np.testing.assert_array_equal(
            getattr(tpc, name).float().numpy(),
            np.asarray(getattr(jpc, name), np.float32), err_msg=name)


def test_pq_serve_step_matches_reference(served):
    sv = served
    jcfg, tcfg, S = sv["jcfg"], sv["tcfg"], sv["S"]
    tok = np.array(jnp.argmax(sv["jl"][:, -1], -1), np.int32)[:, None]
    jl, jpc = jax.jit(lambda p, c, t, pos: jpq.pq_serve_step(
        p, jcfg, c, t, pos, pqc=sv["jpqc"]))(sv["jp"], sv["jpc"],
                                             jnp.asarray(tok), jnp.int32(S))
    tl, tpc = tpq.pq_serve_step(sv["tp"], tcfg, _port_pq_cache(sv),
                                torch.from_numpy(tok), S, pqc=sv["tpqc"])
    assert tl.shape == (2, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=PQ_TOL)
    np.testing.assert_array_equal(tpc.k_codes.numpy(),
                                  np.asarray(jpc.k_codes))
    for name in ("v", "k_recent", "v_recent"):
        assert _ulps(getattr(tpc, name).float(),
                     np.asarray(getattr(jpc, name), np.float32)) <= 1, name


def test_init_pq_cache_matches_reference(served):
    """An empty PQ cache around the reference's books: the reference's
    shapes and dtypes, zeros, and a first step on it gives the reference's
    logits."""
    sv = served
    books = sv["jpc"].k_books
    jc = jpq.init_pq_cache(sv["jcfg"], sv["jpqc"], 2, 32, books)
    tc = tpq.init_pq_cache(sv["tcfg"], sv["tpqc"], 2, 32, _t(books),
                           device=CPU)
    for name in ("k_codes", "k_books", "v", "k_recent", "v_recent"):
        got, want = getattr(tc, name), np.asarray(getattr(jc, name))
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).split(".")[1] == str(want.dtype), name
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))
    tok = np.array([[5], [9]], np.int32)
    jl, _ = jpq.pq_serve_step(sv["jp"], sv["jcfg"], jc, jnp.asarray(tok),
                              jnp.int32(0), pqc=sv["jpqc"])
    tl, _ = tpq.pq_serve_step(sv["tp"], sv["tcfg"], tc,
                              torch.from_numpy(tok), 0, pqc=sv["tpqc"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=PQ_TOL)


def test_kernel_route_step_matches_plain(served, monkeypatch):
    """The whole step through the kernel route (its plain version here)
    against the plain route: logits within the PQ tolerance."""
    sv = served
    tok = torch.tensor([[3], [77]], dtype=torch.int32)
    plain, _ = tpq.pq_serve_step(sv["tp"], sv["tcfg"], _port_pq_cache(sv),
                                 tok, sv["S"], pqc=sv["tpqc"])
    inner = tpq.pq_attention_decode
    monkeypatch.setattr(tpq, "pq_attention_decode",
                        lambda *a, **k: inner(*a, route="kernel", **k))
    kern, _ = tpq.pq_serve_step(sv["tp"], sv["tcfg"], _port_pq_cache(sv),
                                tok, sv["S"], pqc=sv["tpqc"])
    np.testing.assert_allclose(kern.numpy(), plain.numpy(), atol=PQ_TOL)


# ---------------------------------------------------------------------------
# The other families: gemma2's local/global layers, moe, vlm; every mode
# ---------------------------------------------------------------------------

FAMILIES = ("gemma2-27b", "deepseek-moe-16b", "qwen3-moe-30b-a3b",
            "qwen2-vl-72b")
MODES = {"softmax": {}, "topk": dict(mode="topk", top_t=6),
         "quantize_v": dict(quantize_v=True),
         "topk+quantize_v": dict(mode="topk", top_t=6, quantize_v=True)}


FAMILY_STEPS = 2


@functools.lru_cache(maxsize=None)
def _family_prefill(arch, quantize_v):
    """A reference prefill of the reduced config (gemma2: 40 tokens, past
    its window of 32; the vlm with patch embeddings) and the reference's
    PQ cache of it (the books do not depend on the mode)."""
    import test_torch_lm as tl
    jcfg, tcfg, jp, tp = tl._both(arch, seed=2)
    B = 2
    S = tl._prompt_len(tcfg)
    jb, _ = tl._batches(arch + ("+patches" if tcfg.family == "vlm" else ""),
                        tcfg, B, S, seed=2)
    jl, jc = jax.jit(lambda p, c, b: j_prefill(p, jcfg, c, b, q_chunk=8))(
        jp, j_init_cache(jcfg, B, S + FAMILY_STEPS + 1), jb)
    kw = dict(n_sub=4, codebook_size=16, recent_window=8, kmeans_iters=3,
              fit_sample=64, quantize_v=quantize_v)
    jpc = jpq.compress_cache(jc, jcfg, jpq.PQKVConfig(**kw), pos=S,
                             key=jax.random.PRNGKey(3))
    return jcfg, tcfg, jp, tp, S, jl, jc, jpc, kw


def _family_run(arch, mode):
    """``FAMILY_STEPS`` PQ decode steps in both packages from the
    reference's PQ cache (:func:`_family_prefill`): logits within
    ``PQ_TOL``, codes equal, bf16 tensors within one ulp, the same greedy
    tokens."""
    jcfg, tcfg, jp, tp, S, jl, jc, jpc, kw = _family_prefill(
        arch, MODES[mode].get("quantize_v", False))
    kw = dict(kw, **MODES[mode])
    jpqc, tpqc = jpq.PQKVConfig(**kw), tpq.PQKVConfig(**kw)
    tpc = tpq.compress_cache(
        {"k": _t(jc["k"], torch.bfloat16), "v": _t(jc["v"], torch.bfloat16)},
        tcfg, tpqc, pos=S, books=_t(jpc.k_books),
        v_books=None if jpc.v_books is None else _t(jpc.v_books))
    names = ("k_codes", "v_codes") if jpqc.quantize_v else ("k_codes",)
    assert (tpc.v is None) == jpqc.quantize_v
    j_step = jax.jit(lambda p, c, t, pos: jpq.pq_serve_step(
        p, jcfg, c, t, pos, pqc=jpqc))
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for g in range(FAMILY_STEPS):
        jl, jpc = j_step(jp, jpc, jnp.asarray(tok), jnp.int32(S + g))
        tlg, tpc = tpq.pq_serve_step(tp, tcfg, tpc, torch.from_numpy(tok),
                                     S + g, pqc=tpqc)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jl), rtol=0,
                                   atol=PQ_TOL)
        for name in names:
            np.testing.assert_array_equal(getattr(tpc, name).numpy(),
                                          np.asarray(getattr(jpc, name)),
                                          err_msg=name)
        for name in ("v", "k_recent", "v_recent"):
            if getattr(jpc, name) is not None:
                assert _ulps(getattr(tpc, name).float(), np.asarray(
                    getattr(jpc, name), np.float32)) <= 1, name
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        np.testing.assert_array_equal(
            torch.argmax(tlg[:, -1], -1).numpy(), tok[:, 0])


@pytest.mark.parametrize("mode", tuple(MODES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_pq_serve_steps_match_reference(arch, mode):
    _family_run(arch, mode)


def test_quantize_v_cache_matches_reference(served):
    """``compress_cache`` and ``init_pq_cache`` with coded values, from the
    reference's key and value books: codes equal, no exact values, the
    reference's shapes and dtypes."""
    sv = served
    kw = dict(n_sub=4, codebook_size=16, recent_window=8, kmeans_iters=3,
              fit_sample=32, quantize_v=True)
    jpqc, tpqc = jpq.PQKVConfig(**kw), tpq.PQKVConfig(**kw)
    jpc = jpq.compress_cache(sv["jc"], sv["jcfg"], jpqc, pos=sv["S"],
                             key=jax.random.PRNGKey(1))
    tpc = tpq.compress_cache(sv["tcache"], sv["tcfg"], tpqc, pos=sv["S"],
                             books=_t(jpc.k_books), v_books=_t(jpc.v_books))
    assert jpc.v is None and tpc.v is None
    for name in ("k_codes", "v_codes", "k_books", "v_books", "k_recent",
                 "v_recent"):
        np.testing.assert_array_equal(
            getattr(tpc, name).float().numpy(),
            np.asarray(getattr(jpc, name), np.float32), err_msg=name)
    jc = jpq.init_pq_cache(sv["jcfg"], jpqc, 2, 32, jpc.k_books,
                           v_books=jpc.v_books)
    tc = tpq.init_pq_cache(sv["tcfg"], tpqc, 2, 32, _t(jpc.k_books),
                           device=CPU, v_books=_t(jpc.v_books))
    for name in tc._fields:
        got, want = getattr(tc, name), getattr(jc, name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert tuple(got.shape) == np.asarray(want).shape, name
            assert str(got.dtype).split(".")[1] == str(
                np.asarray(want).dtype), name
    # fit from a generator: value books beside the key books
    fit = tpq.compress_cache(sv["tcache"], sv["tcfg"], tpqc, pos=sv["S"],
                             generator=torch.Generator().manual_seed(0))
    assert fit.v_books.shape == fit.k_books.shape
    assert not torch.equal(fit.v_books, fit.k_books)


# ---------------------------------------------------------------------------
# Codebook fitting
# ---------------------------------------------------------------------------

def test_kmeans_batched_equals_looped_fits():
    rng = np.random.default_rng(0)
    F, N, K, D = 5, 60, 6, 4
    centers = rng.standard_normal((F, K, D)) * 4
    X = (centers[:, rng.integers(0, K, N)]
         + rng.standard_normal((F, N, D))).astype(np.float32)
    init = X[:, :K].copy()
    C, inertia = tpq.kmeans_batched(_t(X), _t(init), iters=4)
    _, inertia0 = tpq.kmeans_batched(_t(X), _t(init), iters=0)
    for f in range(F):
        one = euclidean_kmeans(_t(X[f]), K, iters=4, init=_t(init[f]))
        assert torch.equal(C[f], one.centroids)
        assert torch.equal(inertia[f], one.inertia)
    assert bool((inertia <= inertia0).all())
    assert bool((inertia < inertia0).any())


def test_fit_kv_books_shape_finite_and_fit():
    rng = np.random.default_rng(1)
    L, B, S, G, hd = 2, 2, 40, 2, 16
    pqc = tpq.PQKVConfig(n_sub=4, codebook_size=8, kmeans_iters=5,
                         fit_sample=64)
    # keys near 8 centres per subspace
    centres = rng.standard_normal((L, G, 4, 8, 4)) * 3
    pick = rng.integers(0, 8, (L, B, S, G, 4))
    kv = np.take_along_axis(
        np.broadcast_to(centres[:, None, None], (L, B, S, G, 4, 8, 4)),
        pick[..., None, None], axis=5)[..., 0, :]
    kv = (kv + 0.1 * rng.standard_normal(kv.shape)).reshape(L, B, S, G, hd)
    kv = torch.from_numpy(kv.astype(np.float32)).to(torch.bfloat16)
    books = tpq.fit_kv_books(kv, pqc, torch.Generator().manual_seed(0),
                             valid_len=32)
    assert books.shape == (L, G, 4, 8, 4) and books.dtype == torch.float32
    assert bool(torch.isfinite(books).all())
    again = tpq.fit_kv_books(kv, pqc, torch.Generator().manual_seed(0),
                             valid_len=32)
    assert torch.equal(books, again)

    def err(bk):
        rec = torch.stack([tpq.decode_kv(tpq.encode_kv(kv[i], bk[i]), bk[i])
                           for i in range(L)])
        return float(((rec - kv.float()) ** 2).sum())

    # K random cached keys as a codebook: what the fits start from
    rand = kv.float()[:, 0, torch.randperm(S)[:8]].permute(0, 2, 1, 3)
    rand = rand.reshape(L, G, 8, 4, 4).permute(0, 1, 3, 2, 4)
    assert err(books) < err(rand)


# ---------------------------------------------------------------------------
# Memory accounting, the CLI, and what raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw", [
    ("internlm2-1.8b", {}),
    ("qwen2-72b", dict(n_sub=4, codebook_size=16, recent_window=16)),
    ("minitron-8b", dict(codebook_size=64)),
    ("gemma2-27b", dict(quantize_v=True)),
    ("deepseek-moe-16b", dict(mode="topk", quantize_v=True))])
def test_pqkv_memory_matches_reference(arch, kw):
    want = jpq.pqkv_memory(jregistry.get_config(arch), jpq.PQKVConfig(**kw),
                           8, 2080)
    got = tpq.pqkv_memory(tregistry.get_config(arch), tpq.PQKVConfig(**kw),
                          8, 2080)
    assert got == want


def test_unported_options_raise():
    """What raises: an unported family (ssm), ``route="kernel"`` for the
    modes without a kernel (``topk``, coded values), an unknown mode, coded
    values without their books, and a fit without a generator."""
    cfg = dataclasses.replace(ModelConfig(**TINY), family="ssm")
    with pytest.raises(NotImplementedError, match="ssm"):
        tpq.init_pq_cache(cfg, tpq.PQKVConfig(), 1, 8,
                          torch.zeros((2, 2, 8, 256, 2)), device=CPU)
    with pytest.raises(ValueError, match="mode"):
        tpq.PQKVConfig(mode="sparse")
    _, _, tq, tcache = _layer(16, 8, 9)
    with pytest.raises(ValueError, match="mode='topk'"):
        tpq.pq_attention_decode(tq, tcache, 9, route="kernel",
                                pqc=tpq.PQKVConfig(mode="topk"))
    _, _, tq, coded = _layer(16, 8, 9, coded_v=True)
    with pytest.raises(ValueError, match="quantize_v"):
        tpq.pq_attention_decode(tq, coded, 9, route="kernel",
                                pqc=tpq.PQKVConfig(quantize_v=True))
    with pytest.raises(ValueError, match="v_books"):
        tpq.init_pq_cache(ModelConfig(**TINY), tpq.PQKVConfig(
            quantize_v=True), 1, 8, torch.zeros((2, 2, 8, 256, 2)),
            device=CPU)
    with pytest.raises(ValueError, match="generator"):
        tpq.compress_cache({"k": torch.zeros((2, 1, 8, 2, 16)),
                            "v": torch.zeros((2, 1, 8, 2, 16))},
                           ModelConfig(**TINY), tpq.PQKVConfig(), pos=4)


def test_serve_cli_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--arch", "internlm2-1.8b", "--reduced", "--device",
                     "cpu", "--batch", "2", "--prompt-len", "16", "--gen",
                     "4", "--pqkv", "--pq-window", "8"])
    text = out.getvalue()
    for line in ("prefill 16 tokens", "PQ-KV: exact", "decoded 3 steps x 2",
                 "greedy agreement with exact decode"):
        assert line in text, text
    # the production mesh needs 256 ranks; this run is one
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tserve.main(["--arch", "internlm2-1.8b", "--reduced", "--device",
                     "cpu", "--pqkv", "--production-mesh"])


@pytest.mark.parametrize("arch,flags", [
    ("gemma2-27b", ["--prompt-len", "40"]),
    ("deepseek-moe-16b", ["--pq-quantize-v"]),
    ("qwen2-vl-72b", ["--pq-quantize-v"])])
def test_serve_cli_families_on_cpu(arch, flags):
    """The launcher serves every ported family, exact and PQ-KV decode,
    with coded values under ``--pq-quantize-v``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--batch", "2", "--gen", "3", "--pqkv", "--pq-window",
                     "8", *flags])
    text = out.getvalue()
    for line in (f"family={tregistry.get_reduced(arch).family}",
                 "PQ-KV: exact", "decoded 2 steps x 2",
                 "greedy agreement with exact decode"):
        assert line in text, text
