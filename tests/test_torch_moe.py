"""The port's top-k routed experts (``repro_torch.models.layers.moe``) held
against the JAX package's ``moe`` on the CPU.

Routing is float32 and compared exactly: the token ids each expert takes
(``stats["tok_ec"]``) equal the reference's ``top_k`` over the capacity
matrix, ties included (both keep the lower index first).  The output is
bf16 and held within one bf16 ulp at its scale (``_ulps``; XLA keeps
some bf16 intermediates in float32, see ``tests/test_torch_lm.py``).  The
combine sums each token's partials in bf16 in the reference's update
order, expert by expert: shown bit for bit on partials that round
differently in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import layers as jlayers
from repro_torch.configs import registry as tregistry
from repro_torch.models import layers as tlayers

BF = jnp.bfloat16
ARCHS = ("deepseek-moe-16b", "qwen3-moe-30b-a3b")   # shared experts / none


def _ulps(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)
    return float(np.abs(got - want).max() / ulp)


def _params(jcfg, seed, router=None):
    """The reference's random expert weights (numpy), optionally with a
    given router matrix; the port's copy in bf16."""
    p = jax.tree.map(np.asarray, jlayers.init_moe(jax.random.PRNGKey(seed),
                                                  jcfg))
    if router is not None:
        p = p._replace(router=router.astype(np.float32))

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)

    sh = p.shared
    tp = tlayers.MoeParams(
        router=t(p.router), we_gate=t(p.we_gate), we_up=t(p.we_up),
        we_down=t(p.we_down),
        shared=None if sh is None else tlayers.MlpParams(
            t(sh.w_gate), t(sh.w_up), t(sh.w_down)))
    return jax.tree.map(jnp.asarray, p), tp


def _x(B, S, d, seed):
    x = np.random.default_rng(seed).standard_normal((B, S, d))
    xb = np.asarray(jnp.asarray(x, jnp.float32).astype(BF), np.float32)
    return jnp.asarray(xb).astype(BF), torch.from_numpy(xb).to(torch.bfloat16)


def _reference_routing(jp, jcfg, jx, cf=1.25):
    """The reference's routing lines (``repro/models/layers.py::moe``),
    step for step: its ``_dot``, softmax, ``top_k`` over the probabilities
    and over the capacity matrix ``W.T``."""
    B, S, d = jx.shape
    E, k = jcfg.n_experts, jcfg.n_active_experts
    T = B * S
    logits = jlayers._dot(jx.reshape(T, d), jp.router,
                          preferred=jnp.float32).astype(jnp.float32)
    top_w, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    W = jnp.zeros((T, E), jnp.float32).at[
        jnp.arange(T)[:, None], top_i].set(top_w)
    C = min(max(8, int(-(-k * T * cf // E) // 8 * 8)), T)
    return np.asarray(jax.lax.top_k(W.T, C)[1])


def _run(jcfg, tcfg, jp, tp, jx, tx):
    want = np.asarray(jax.jit(lambda p, x: jlayers.moe(p, jcfg, x))(jp, jx),
                      np.float32)
    stats = {}
    got = tlayers.moe(tp, tcfg, tx, stats=stats)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    np.testing.assert_array_equal(stats["tok_ec"].numpy(),
                                  _reference_routing(jp, jcfg, jx))
    assert _ulps(got.float(), want) <= 1
    return stats


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S", [(2, 24), (3, 1)])
def test_moe_matches_reference(arch, B, S):
    """Random routing at a prompt's shape and at decode's (``S = 1``)."""
    jcfg, tcfg = jregistry.get_reduced(arch), tregistry.get_reduced(arch)
    jp, tp = _params(jcfg, seed=B * S)
    jx, tx = _x(B, S, tcfg.d_model, seed=B + S)
    stats = _run(jcfg, tcfg, jp, tp, jx, tx)
    assert int(stats["routed"].sum()) == B * S * tcfg.n_active_experts


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["zero_router", "repeated_tokens"])
def test_routing_ties_and_capacity(arch, case):
    """Tied weights where capacity binds.  A zero router gives every token
    the same probabilities: all of them pick experts ``0..k-1`` (the lower
    index first), which take the first ``C`` tokens, and the other experts
    fill their slots with zero-weight tokens ``0..C-1``.  Tokens that
    repeat 5 distinct rows tie in every routing weight, so an expert
    choosing among them takes the lower ids first.  The routed ids equal
    the reference's, and tokens are dropped.

    Only exact ties are held: PyTorch's and XLA's ``exp`` differ by a
    float32 ulp here and there, so two different tokens whose weights lie
    an ulp apart may rank differently in the two packages."""
    jcfg, tcfg = jregistry.get_reduced(arch), tregistry.get_reduced(arch)
    d, E = tcfg.d_model, tcfg.n_experts
    rng = np.random.default_rng(5)
    zero = case == "zero_router"
    jp, tp = _params(jcfg, seed=3,
                     router=np.zeros((d, E)) if zero else None)
    rows = rng.standard_normal((5, d)).astype(np.float32)
    x = rows[rng.integers(0, 5, 64)].reshape(4, 16, d)
    x = np.asarray(jnp.asarray(x).astype(BF), np.float32)
    jx, tx = jnp.asarray(x).astype(BF), torch.from_numpy(x).to(torch.bfloat16)
    stats = _run(jcfg, tcfg, jp, tp, jx, tx)
    C = tlayers.moe_capacity(tcfg, 64)
    assert stats["tok_ec"].shape == (E, C) and C < 64
    assert stats["dropped"] > 0
    if zero:
        k = tcfg.n_active_experts
        want = np.tile(np.arange(C), (E, 1))
        np.testing.assert_array_equal(stats["tok_ec"].numpy(), want)
        assert stats["routed"].tolist() == [64] * k + [0] * (E - k)


def test_combine_order_is_the_references():
    """Three partials of one token: 1 and two halves of its bf16 ulp.
    Expert-major (the reference's update order: the halves first) sums to
    1 + ulp; the other order rounds each half away (ties to even), giving
    1.  The port's combine equals the reference's scatter-add and a
    sequential bf16 oracle, and differs from the reversed order."""
    half = 2.0 ** -8
    y = np.zeros((3, 2, 4), np.float32)               # (E, C, d)
    y[0, 0], y[1, 1], y[2, 0] = half, half, 1.0
    y[:, :, 1:] = np.random.default_rng(0).standard_normal((3, 2, 3))
    yb = np.asarray(jnp.asarray(y).astype(BF), np.float32)
    tok = np.array([[5, 2], [0, 5], [5, 1]], np.int64)   # distinct per e
    T = 6
    want = np.asarray(jnp.zeros((T, 4), BF).at[tok.reshape(-1)].add(
        jnp.asarray(yb).astype(BF).reshape(-1, 4)), np.float32)
    got = tlayers._combine(torch.from_numpy(yb).to(torch.bfloat16),
                           torch.from_numpy(tok), T).float().numpy()
    np.testing.assert_array_equal(got, want)

    def seq(order):
        out = torch.zeros((T, 4), dtype=torch.bfloat16)
        for e, c in order:
            out[tok[e, c]] = out[tok[e, c]] + torch.from_numpy(
                yb[e, c]).to(torch.bfloat16)
        return out.float().numpy()

    pairs = [(e, c) for e in range(3) for c in range(2)]
    np.testing.assert_array_equal(got, seq(pairs))
    assert got[5, 0] == 1.0 + 2 * half
    assert seq(pairs[::-1])[5, 0] == 1.0


@pytest.mark.parametrize("k,T,E,C", [
    (6, 8192, 64, 960),     # deepseek-moe-16b, a 4 x 2048 prompt
    (6, 4, 64, 4),          # its decode step: C = B
    (8, 4096, 128, 320),    # qwen3-moe-30b-a3b
    (2, 64, 8, 16),         # the reduced configs
    (2, 48, 8, 8),          # 15 rounded down to a multiple of 8
    (1, 1, 8, 1)])
def test_capacity(k, T, E, C):
    import dataclasses
    cfg = dataclasses.replace(tregistry.get_reduced("deepseek-moe-16b"),
                              n_experts=E, n_active_experts=k)
    assert tlayers.moe_capacity(cfg, T) == C


def test_top_k_keeps_the_lower_index_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, idx = tlayers.top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]


def test_pinned_routing():
    """``routing=`` the router's own choice gives the same bits; other
    experts give another output, weighted by the router's probabilities
    there."""
    jcfg, tcfg = (jregistry.get_reduced("deepseek-moe-16b"),
                  tregistry.get_reduced("deepseek-moe-16b"))
    _, tp = _params(jcfg, seed=4)
    _, tx = _x(2, 8, tcfg.d_model, seed=9)
    stats = {}
    free = tlayers.moe(tp, tcfg, tx, stats=stats)
    assert torch.equal(tlayers.moe(tp, tcfg, tx, routing=stats["top_i"]),
                       free)
    other = (stats["top_i"] + 1) % tcfg.n_experts
    moved = {}
    out = tlayers.moe(tp, tcfg, tx, routing=other, stats=moved)
    assert torch.equal(moved["top_i"], other)
    assert not torch.equal(out, free)
