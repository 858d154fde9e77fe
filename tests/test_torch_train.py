"""The port's LM training (``data/tokens``, ``train/losses``,
``train/optim``, ``train/step``, ``launch/train``) held against the JAX
package on the CPU.

The reference's ``init_train_state`` parameters (float32 masters, its
layers stacked) are carried to the port's per-layer tree by
``params_from_numpy(..., dtype=float32)``; its gradients and updated
states the same way, so every leaf is compared layer by layer.  The
reference runs jitted, as its launcher runs it.

Tolerances, and why:

* ``TokenStream`` batches: bit for bit (the same numpy draws).
* ``next_token_loss``: values and ``d loss / d logits`` within float32
  rounding (``rtol=1e-6``; XLA's ``logsumexp`` sums in another order).
* ``adamw_step`` on the reference's stacked tree: ``rtol=1e-6`` of each
  element and of the leaf's largest magnitude.  XLA fuses the update: it
  contracts ``p - lr * u`` (and the moments' ``b * m + c``) into one FMA
  where PyTorch rounds twice (more than half of the weights that differ),
  and rounds another step of it differently; each gap is one float32 ulp
  of the terms, which is most of what is left where they nearly cancel.
* The train step: the loss and metrics within ``LOSS_RTOL`` = 1e-4
  (1.1e-5 at worst here).  Per-leaf gradients within ``GRAD_RTOL`` = 5e-2
  of the reference's norm (3.6e-2 at worst): both forwards round to bf16
  after the same ops, but XLA keeps some bf16 intermediates in float32
  (its excess precision) and reduces a bf16 cotangent over the batch in
  bf16, where PyTorch accumulates in float32, so the norm scales' and
  biases' gradients, sums over every position, part by a few bf16 ulps.
  The moe family's within ``MOE_GRAD_RTOL`` = 1.5e-1: router logits an
  ulp apart send a token to another expert (ROADMAP queue 3, MoE ties),
  and that expert's gradient then differs by the token's share (7.7e-2
  here).
* Three AdamW steps (``microbatches=2``, ``loss_chunk=16``): each step's
  loss and metrics within ``STEP_RTOL`` = 1e-3 (7.1e-4 at worst here: the
  updates carry the gradients' differences into the next steps' losses);
  the change of all weights together within ``UPDATE_RTOL`` = 0.1 of the
  reference's in norm, and each leaf's change at cosine >= ``UPDATE_COS``
  = 0.3 with the reference's.  AdamW's first steps move a weight by about
  ``lr`` times the sign of its gradient, whatever its size, so where a
  gradient is mostly rounding noise its weight moves either way: the key
  bias, whose gradient softmax's shift invariance nearly cancels (qwen2's
  ``bk`` changes 0.94 apart in norm, cosine 0.56), zamba2's ``d_skip``
  (0.52).  A lost, reversed or unrelated update reads cosine 0, -1 or
  about 0.
* ``remat`` on or off, a resumed run against an uninterrupted one: bit
  for bit.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro.configs import registry as jregistry
from repro.data.tokens import TokenStream as JTokenStream
from repro.models import ssm as jssm
from repro.train import losses as jlosses
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import _tree
from repro_torch.configs import registry as tregistry
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import train as tlaunch
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep
from repro_torch.train.losses import next_token_loss

CPU = "cpu"
ARCHS = tregistry.ARCH_IDS
LOSS_RTOL = 1e-4
GRAD_RTOL = 5e-2
MOE_GRAD_RTOL = 1.5e-1
STEP_RTOL = 1e-3
UPDATE_RTOL = 1e-1
UPDATE_COS = 0.3
# ssd_forward's gradients against the reference's (test_ssd_clip_ties_cancel)
SSD_GRAD_RTOL = {"norm": 2e-2, **{k: 5e-3 for k in (
    "conv_x", "conv_B", "conv_C", "conv_bx", "conv_bB", "conv_bC", "a_log",
    "d_skip", "dt_bias")}}
B, S, Q_CHUNK = 4, 32, 16


def _extras(cfg):
    """The batch extras a family takes (``TokenStream``'s shapes)."""
    name = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
    return {name: (cfg.n_frontend_tokens, cfg.d_model)} if name else {}


def _np_batch(cfg, step=0, seed=1):
    return JTokenStream(cfg.vocab_size, S, B, seed=seed,
                        extras=_extras(cfg)).batch_at(step)


def _to_port(tree_np, cfg):
    """A reference tree of numpy leaves (parameters, gradients or
    moments: the parameters' structure) -> the port's per-layer float32
    tree."""
    if cfg.family == "encdec":
        return tencdec.encdec_params_from_numpy(tree_np, cfg, CPU,
                                                dtype=torch.float32)
    return tlm.params_from_numpy(tree_np, cfg, CPU, dtype=torch.float32)


def _ref_cast(params):
    """The reference train step's ``_bf16_cast`` (a closure inside its
    ``make_train_step``), on its stacked tree."""
    return jax.tree.map(lambda p: p.astype(jnp.bfloat16)
                        if (p.dtype == jnp.float32 and p.ndim >= 2) else p,
                        params)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    n = float(want.norm())
    return float((got - want).norm()) / n if n > 0 else float(got.norm())


# ---------------------------------------------------------------------------
# Token stream, loss, schedule, AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_token_stream_equals_reference(seed, step):
    extras = {"frames": (5, 8), "patches": (3, 4)}
    got = TokenStream(1000, 24, 3, seed=seed, extras=extras).batch_at(step)
    want = JTokenStream(1000, 24, 3, seed=seed, extras=extras).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    # and the iterator walks the same steps
    it = iter(TokenStream(50, 8, 2, seed=seed))
    for s in range(3):
        np.testing.assert_array_equal(
            next(it)["tokens"],
            JTokenStream(50, 8, 2, seed=seed).batch_at(s)["tokens"])


@pytest.mark.parametrize("ignore", [0, 9])
def test_next_token_loss_and_gradient(ignore):
    rng = np.random.default_rng(ignore)
    logits = (3 * rng.standard_normal((2, 7, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    labels.reshape(-1)[rng.permutation(14)[:ignore]] = -100

    def jf(lg):
        return jlosses.next_token_loss(lg, jnp.asarray(labels))

    (jl, jm), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tl, tm = next_token_loss(x, torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-6)
    assert float(tm["tokens"]) == 14 - ignore
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-9)
    if ignore:          # an ignored position takes no gradient
        assert not x.grad[torch.from_numpy(labels == -100)].any()


@given(st.integers(0, 20_000))
@settings(max_examples=15, deadline=None)
def test_lr_schedule_bounds(step):
    cfg = toptim.AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000,
                             min_lr_frac=0.1)
    lr = float(toptim.warmup_cosine(cfg, torch.tensor(step)))
    assert 0.0 <= lr <= cfg.lr * (1 + 1e-6)
    if step >= cfg.total_steps:
        assert lr == pytest.approx(cfg.lr * cfg.min_lr_frac, rel=1e-4)
    want = float(joptim.warmup_cosine(joptim.AdamWConfig(
        lr=3e-4, warmup_steps=100, total_steps=10_000, min_lr_frac=0.1),
        jnp.asarray(step)))
    assert lr == pytest.approx(want, rel=1e-6)


def test_zero_grad_moves_only_by_decay():
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    opt = toptim.adamw_init(params)
    cfg = toptim.AdamWConfig(lr=1e-2, weight_decay=0.0)
    zero = _tree.tree_map(torch.zeros_like, params)
    new_p, _ = toptim.adamw_step(cfg, params, zero, opt)
    torch.testing.assert_close(new_p["w"], torch.ones((4, 4)), rtol=0,
                               atol=1e-6)


def test_grad_step_descends_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = toptim.adamw_init(params)
    cfg = toptim.AdamWConfig(lr=5e-2, weight_decay=0.0, warmup_steps=0)
    for _ in range(50):
        params, opt = toptim.adamw_step(cfg, params, {"w": 2 * params["w"]},
                                        opt)
    assert float(params["w"].abs().max()) < 1.5
    assert int(opt.count) == 50


@pytest.mark.parametrize("arch", ["qwen2-72b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_adamw_step_matches_reference_on_stacked_tree(arch):
    """The same numpy parameters, gradients and moments through both
    ``adamw_step``s (the reference on its stacked tree, the port on its
    per-layer tree), two steps, gradients large enough to clip on the
    second: every leaf within rtol 1e-6.  Every leaf, norm scales and
    biases included, has random nonzero values, so a 1-D block leaf that
    the port left undecayed (its own ``ndim`` rule) would part by ``lr *
    weight_decay * p``, far above the tolerance: checked below."""
    jcfg, tcfg = jregistry.get_reduced(arch), tregistry.get_reduced(arch)
    like = jax.tree.map(np.asarray, jstep.init_train_state(
        jax.random.PRNGKey(0), jcfg).params)
    rng = np.random.default_rng(0)

    def rand(scale):
        return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)
                                       ).astype(np.float32), like)

    params = rand(0.1)
    opt = joptim.OptState(mu=rand(1e-3), nu=jax.tree.map(np.abs, rand(1e-5)),
                          count=np.int32(3))
    grads = [rand(1e-3), rand(1.0)]
    cfg = dict(lr=1e-3, weight_decay=0.1, warmup_steps=2, total_steps=10)

    jp, jo = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, opt)
    jfn = jax.jit(lambda p, g, o: joptim.adamw_step(
        joptim.AdamWConfig(**cfg), p, g, o))
    tp = _to_port(params, tcfg)
    to = toptim.OptState(mu=_to_port(opt.mu, tcfg), nu=_to_port(opt.nu, tcfg),
                         count=torch.tensor(3, dtype=torch.int32))
    tp0 = _tree.tree_map(torch.clone, tp)
    for g in grads:
        jp, jo = jfn(jp, jax.tree.map(jnp.asarray, g), jo)
        tp, to = toptim.adamw_step(toptim.AdamWConfig(**cfg), tp,
                                   _to_port(g, tcfg), to)
    assert int(to.count) == int(jo.count) == 5
    for got, want in ((tp, jp), (to.mu, jo.mu), (to.nu, jo.nu)):
        want = _to_port(jax.tree.map(np.asarray, want), tcfg)
        for (path, a), b in zip(_tree.leaves_with_paths(got),
                                _tree.leaves(want)):
            b = b.numpy()
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=_tree.path_name(path))
    # the decay of 1-D block leaves is what the tolerance sees
    undecayed = [p for path, p in _tree.leaves_with_paths(tp0)
                 if path[0] != "final_norm" and p.dim() == 1]
    assert undecayed
    for p in undecayed:
        assert float((1e-3 * 0.1 * p).abs().median()) > 1e-6 * 0.1 * 10


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_cast_follows_the_stacked_shapes(arch):
    """The port's per-layer cast gives every leaf the dtype and value the
    reference's ``_bf16_cast`` gives it on the stacked tree: every leaf
    under the layer stacks in bf16 (norm scales, biases, the SSM's
    ``conv_*``, ``a_log``, ``d_skip``, ``dt_bias`` too), ``final_norm``,
    ``enc_norm`` and ``shared_attn``'s 1-D leaves in float32.  With the
    port's own ``ndim`` those 1-D block leaves would stay float32."""
    jcfg, tcfg = jregistry.get_reduced(arch), tregistry.get_reduced(arch)
    params = jax.tree.map(np.asarray, jstep.init_train_state(
        jax.random.PRNGKey(0), jcfg).params)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), params)
    cast = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        _ref_cast(jax.tree.map(jnp.asarray, params)))
    dtypes = jax.tree.map(lambda a: np.asarray(a).dtype == jnp.bfloat16,
                          _ref_cast(params))
    got = tstep.bf16_cast(_to_port(params, tcfg))
    want = _to_port(cast, tcfg)
    want_bf16 = _to_port(jax.tree.map(
        lambda b, a: np.full(a.shape, float(b), np.float32), dtypes, params),
        tcfg)
    one_d = 0
    for (path, g), w, isb in zip(_tree.leaves_with_paths(got),
                                 _tree.leaves(want), _tree.leaves(want_bf16)):
        name = _tree.path_name(path)
        assert (g.dtype == torch.bfloat16) == bool(isb.flatten()[0]), name
        assert torch.equal(g.float(), w), name
        one_d += g.dim() == 1 and g.dtype == torch.bfloat16
    assert one_d >= tcfg.n_layers      # the rule the port's ndim would miss


# ---------------------------------------------------------------------------
# Gradients through the models
# ---------------------------------------------------------------------------

def test_dot_f32_gradient_matches_reference():
    """``_dot_f32``'s gradient (the CPU form; the card's ``_MmF32`` has
    the same arithmetic, tests/test_torch_cuda.py) against ``jax.vjp`` of
    the reference's ``ssm._proj``: float32 cotangent times the bf16
    operand in float32, rounded to bf16.  The sums run in another order,
    so a result next to a bf16 rounding boundary may round the other way:
    every element within one bf16 ulp of the larger (plus the float32 sum's
    rounding, 2^-16 of its terms' magnitudes), nearly all equal."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 17, 96)).astype(np.float32)
    w = (0.05 * rng.standard_normal((96, 80))).astype(np.float32)
    ct = rng.standard_normal((3, 17, 80)).astype(np.float32)
    _, vjp = jax.vjp(jssm._proj, jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = (np.asarray(g) for g in vjp(jnp.asarray(ct)))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    out = tlayers._dot_f32(tx, tw)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jssm._proj(x, w)), rtol=1e-5,
                               atol=1e-6)
    out.backward(torch.from_numpy(ct))
    # the float32 sums' rounding scales with the sum of the terms'
    # magnitudes: a result near 0 may differ by more than its own ulp
    x2, c2 = np.abs(x.reshape(-1, 96)), np.abs(ct.reshape(-1, 80))
    terms = ((c2 @ np.abs(w).T).reshape(x.shape), x2.T @ c2)
    for got, want, t in ((tx.grad.numpy(), jgx, terms[0]),
                         (tw.grad.numpy(), jgw, terms[1])):
        assert np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))
        bound = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7
        assert (np.abs(got - want) <= bound + t * 2.0 ** -16).all()
        assert np.mean(got == want) >= 0.99


def test_ssd_clip_ties_cancel(monkeypatch):
    """``ssd_forward`` clips ``cum_i - cum_j`` and ``seg_end - cum`` to
    [-60, 0] before ``exp``; both are exactly 0 on the diagonal and at the
    chunk's last position.  ``jnp.clip`` splits a tie's gradient 0.5 /
    0.5, ``torch.clamp`` passes it whole; the two terms of each
    difference cancel either way: the port's gradient equals the one with
    the reference's split (``torch.maximum`` / ``torch.minimum`` split
    ties too) within float32 rounding, and both the reference's within
    its tolerance (``SSD_GRAD_RTOL``: bf16-rounded gradients within 1e-2,
    3.6e-3 at worst; ``norm``'s, a bf16 reduction, 2e-2; the float32
    leaves' 5e-3)."""
    jcfg, tcfg = (jregistry.get_reduced("mamba2-780m"),
                  tregistry.get_reduced("mamba2-780m"))
    p = jax.tree.map(np.asarray, jssm.init_ssm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    def ref(pp):
        _, vjp = jax.vjp(lambda q: jssm.ssd_forward(
            q, jcfg, jnp.asarray(x).astype(jnp.bfloat16), chunk=16
        ).astype(jnp.float32), pp)
        return vjp(jnp.asarray(ct))[0]

    jg = jax.jit(ref)(jax.tree.map(jnp.asarray, p))

    ties = []

    def grads():
        tp = tssm.SsmParams(*(torch.tensor(np.asarray(a), requires_grad=True)
                              for a in p))
        y = tssm.ssd_forward(tp, tcfg, torch.from_numpy(x).bfloat16(),
                             chunk=16)
        y.float().backward(torch.from_numpy(ct))
        return [t.grad for t in tp]

    clamp_exp = tssm._clip_exp

    def counting(v):
        ties.append(int((v == 0).sum()))
        return clamp_exp(v)

    monkeypatch.setattr(tssm, "_clip_exp", counting)
    port = grads()
    assert sum(ties) >= 2 * 2 * 16 * tcfg.ssm_heads   # diagonals at least
    monkeypatch.setattr(tssm, "_clip_exp", lambda v: torch.exp(torch.minimum(
        torch.maximum(v, v.new_tensor(-60.0)), v.new_tensor(0.0))))
    split = grads()
    for name, a, b, j in zip(tssm.SsmParams._fields, port, split, jg):
        assert _rel(a, b) <= 1e-5, name
        assert _rel(a, torch.from_numpy(np.array(j))) <= SSD_GRAD_RTOL.get(
            name, 1e-2), name


def _ref_grads(jcfg, params, batch):
    fwd = jstep.make_forward(jcfg, q_chunk=Q_CHUNK)

    def loss(p, mb):
        return jlosses.next_token_loss(fwd(_ref_cast(p), batch=mb),
                                       mb["labels"])

    (l, m), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    return float(l), {k: float(v) for k, v in m.items()}, g


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """One microbatch from the reference's ``init_train_state`` masters:
    the loss and metrics within ``LOSS_RTOL``, every leaf's gradient
    within ``GRAD_RTOL`` (``MOE_GRAD_RTOL``) of the reference's in norm,
    float32 gradients of bf16-rounded values where the leaf is cast."""
    jcfg, tcfg = jregistry.get_reduced(arch), tregistry.get_reduced(arch)
    state = jstep.init_train_state(jax.random.PRNGKey(0), jcfg)
    batch = _np_batch(jcfg)
    jl, jm, jg = _ref_grads(jcfg, state.params, batch)
    params = _to_port(jax.tree.map(np.asarray, state.params), tcfg)
    fn = tstep.make_loss_and_grads(tcfg, q_chunk=Q_CHUNK)
    tl, tm, tg = fn(params, {k: torch.from_numpy(v) for k, v in
                             batch.items()})
    assert abs(float(tl) - jl) <= LOSS_RTOL * abs(jl)
    assert sorted(tm) == sorted(jm) == ["ce", "ppl", "tokens", "z_loss"]
    for k in jm:
        assert abs(float(tm[k]) - jm[k]) <= LOSS_RTOL * abs(jm[k]), k
    tol = MOE_GRAD_RTOL if tcfg.family == "moe" else GRAD_RTOL
    want = _to_port(jax.tree.map(np.asarray, jg), tcfg)
    for (path, g), w in zip(_tree.leaves_with_paths(tg), _tree.leaves(want)):
        name = _tree.path_name(path)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel(g, w) <= tol, (name, _rel(g, w))
        if toptim.matrix_like(path, g):     # through the bf16 cast
            assert torch.equal(g, g.bfloat16().float()), name


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal(arch):
    """``remat`` on and off: the same loss and gradients, bit for bit
    (the recomputation runs the same ops on the same values)."""
    cfg = tregistry.get_reduced(arch)
    state = tstep.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   CPU)
    batch = {k: torch.from_numpy(v) for k, v in _np_batch(cfg).items()}
    runs = [tstep.make_loss_and_grads(cfg, q_chunk=Q_CHUNK, remat=r)(
        state.params, batch) for r in (True, False)]
    (l1, m1, g1), (l2, m2, g2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(g1),
                                                 _tree.leaves(g2)))


def test_remat_recomputes_in_backward(monkeypatch):
    """With ``remat`` the layer bodies run again in the backward pass."""
    cfg = tregistry.get_reduced("internlm2-1.8b")
    state = tstep.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   CPU)
    batch = {k: torch.from_numpy(v) for k, v in _np_batch(cfg).items()}
    calls = []
    real = tlm.block_apply
    monkeypatch.setattr(tlm, "block_apply",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for remat, want in ((False, cfg.n_layers), (True, 2 * cfg.n_layers)):
        calls.clear()
        tstep.make_loss_and_grads(cfg, q_chunk=Q_CHUNK, remat=remat)(
            state.params, batch)
        assert len(calls) == want


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "seamless-m4t-large-v2"])
def test_loss_chunk_and_microbatches(arch):
    """``loss_chunk`` gives the unchunked loss and gradients within
    float32 rounding; ``microbatches=2`` gives the mean of the two
    halves' losses and gradients."""
    cfg = tregistry.get_reduced(arch)
    state = tstep.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   CPU)
    batch = {k: torch.from_numpy(v) for k, v in _np_batch(cfg).items()}
    l0, m0, g0 = tstep.make_loss_and_grads(cfg, Q_CHUNK)(state.params, batch)
    l1, m1, g1 = tstep.make_loss_and_grads(cfg, Q_CHUNK, loss_chunk=8)(
        state.params, batch)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    assert sorted(m1) == sorted(m0) and float(m1["tokens"]) == B * S
    for a, b in zip(_tree.leaves(g1), _tree.leaves(g0)):
        assert _rel(a, b) <= 1e-2
    lm_, mm, gm = tstep.make_loss_and_grads(cfg, Q_CHUNK, microbatches=2)(
        state.params, batch)
    halves = [tstep.make_loss_and_grads(cfg, Q_CHUNK)(
        state.params, {k: v[i * B // 2:(i + 1) * B // 2]
                       for k, v in batch.items()}) for i in (0, 1)]
    assert torch.equal(lm_, (halves[0][0] + halves[1][0]) / 2)
    assert all(torch.equal(mm[k], halves[1][1][k]) for k in mm)
    for g, a, b in zip(_tree.leaves(gm), _tree.leaves(halves[0][2]),
                       _tree.leaves(halves[1][2])):
        assert torch.equal(g, (a + b) / 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """Three ``make_train_step`` steps with ``microbatches=2`` and
    ``loss_chunk=16`` from the reference's masters: each step's loss and
    metrics within ``STEP_RTOL``, the step counter, the change of the
    weights within ``UPDATE_RTOL`` and ``UPDATE_COS``."""
    jcfg, tcfg = jregistry.get_reduced(arch), tregistry.get_reduced(arch)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    kw = dict(q_chunk=Q_CHUNK, microbatches=2, loss_chunk=16)
    jstate = jstep.init_train_state(jax.random.PRNGKey(0), jcfg)
    p0 = _to_port(jax.tree.map(np.asarray, jstate.params), tcfg)
    tstate = tstep.TrainState(step=torch.tensor(0, dtype=torch.int32),
                              params=_tree.tree_map(torch.clone, p0),
                              opt=toptim.adamw_init(p0))
    jfn = jax.jit(jstep.make_train_step(jcfg, joptim.AdamWConfig(**opt),
                                        **kw))
    tfn = tstep.make_train_step(tcfg, toptim.AdamWConfig(**opt), **kw)
    for s in range(3):
        batch = _np_batch(jcfg, step=s)
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tfn(tstate, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        assert sorted(tm) == sorted(jm)
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= STEP_RTOL * abs(
                float(jm[k])), (s, k)
    assert int(tstate.step) == int(jstate.step) == 3
    assert int(tstate.opt.count) == 3
    want = _to_port(jax.tree.map(np.asarray, jstate.params), tcfg)
    moved, moved_ref = [], []
    for (path, got), w, p in zip(_tree.leaves_with_paths(tstate.params),
                                 _tree.leaves(want), _tree.leaves(p0)):
        a, b = (got - p).flatten(), (w - p).flatten()
        cos = float(a @ b) / float(a.norm() * b.norm())
        assert cos >= UPDATE_COS, (_tree.path_name(path), cos)
        moved.append(a)
        moved_ref.append(b)
    assert _rel(torch.cat(moved), torch.cat(moved_ref)) <= UPDATE_RTOL


def test_mb_constraint_raises():
    cfg = tregistry.get_reduced("internlm2-1.8b")
    step = tstep.make_train_step(cfg, toptim.AdamWConfig(), microbatches=2,
                                 mb_constraint={"tokens": ("data", None)})
    state = tstep.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    batch = {k: torch.zeros((2, 8), dtype=torch.int32)
             for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="mesh"):
        step(state, batch)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _argv(tmp, *extra, steps=6):
    return ["--arch", "qwen2-vl-72b", "--reduced", "--device", "cpu",
            "--steps", str(steps), "--batch", "4", "--seq", "16",
            "--microbatches", "2", "--ckpt-every", "3", *extra]


def _ckpt_leaves(d, step):
    with open(os.path.join(d, f"step_{step:010d}", "manifest.json")) as f:
        man = json.load(f)["leaves"]
    return [(m["name"], np.load(os.path.join(d, f"step_{step:010d}",
                                             m["file"]))) for m in man]


def _preempt_at(monkeypatch, k):
    """The launcher's stream sends SIGTERM to its own process while it
    draws batch ``k`` (step ``k + 1``): no timing race."""

    class Stream(TokenStream):
        def batch_at(self, step):
            if step == k:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().batch_at(step)

    monkeypatch.setattr(tlaunch, "TokenStream", Stream)


def test_resume_equals_uninterrupted_run(tmp_path, monkeypatch, capsys):
    """One run of 6 steps (checkpoints at 3 and 6); a second run of the
    same 6 steps preempted after step 3 (checkpoint and exit), then
    resumed from its checkpoint to 6: the two step-6 checkpoints and final
    states are equal bit for bit, and the per-step records agree."""
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    out_full, out_part = tmp_path / "full.jsonl", tmp_path / "part.jsonl"
    s_full = tlaunch.main(_argv(tmp_path, "--ckpt-dir", full,
                                "--metrics-out", str(out_full)))
    _preempt_at(monkeypatch, 2)
    s_stop = tlaunch.main(_argv(tmp_path, "--ckpt-dir", part,
                                "--metrics-out", str(out_part)))
    text = capsys.readouterr().out
    assert "(preempted)" in text and "signal" in text
    assert int(s_stop.step) == 3 and tlaunch.latest_step(part) == 3
    monkeypatch.setattr(tlaunch, "TokenStream", TokenStream)
    s_part = tlaunch.main(_argv(tmp_path, "--ckpt-dir", part,
                                "--metrics-out", str(out_part)))
    assert "restored step 3" in capsys.readouterr().out
    assert tlaunch.latest_step(full) == tlaunch.latest_step(part) == 6
    a, b = _ckpt_leaves(full, 6), _ckpt_leaves(part, 6)
    assert [n for n, _ in a] == [n for n, _ in b]
    assert a[0][0] == "step" and "params__embed" in [n for n, _ in a]
    for (name, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    for x, y in zip(_tree.leaves(s_full), _tree.leaves(s_part)):
        assert torch.equal(x, y)
    recs = [json.loads(line) for line in out_full.read_text().splitlines()]
    recs_part = [json.loads(line)
                 for line in out_part.read_text().splitlines()]
    assert [r["step"] for r in recs_part] == [1, 2, 3, 4, 5, 6]
    assert [r["loss"] for r in recs] == [r["loss"] for r in recs_part]
    assert all(np.isfinite(r["loss"]) for r in recs)


def test_preemption_checkpoints_and_exits(tmp_path, monkeypatch, capsys):
    """SIGTERM during step 2 of 10: the step finishes, a checkpoint of
    step 2 is written synchronously before ``main`` returns, the handlers
    are restored, and a resumed run starts at step 3."""
    d = str(tmp_path / "ck")
    _preempt_at(monkeypatch, 1)
    before = signal.getsignal(signal.SIGTERM)
    state = tlaunch.main(_argv(tmp_path, "--ckpt-dir", d, steps=10))
    assert signal.getsignal(signal.SIGTERM) is before
    assert int(state.step) == 2 and tlaunch.latest_step(d) == 2
    out = capsys.readouterr().out
    assert "finished at step 2" in out and "(preempted)" in out
    monkeypatch.setattr(tlaunch, "TokenStream", TokenStream)
    state = tlaunch.main(_argv(tmp_path, "--ckpt-dir", d, steps=4))
    out = capsys.readouterr().out
    assert "restored step 2" in out
    assert '"step": 3' in out and '"step": 1' not in out
    assert int(state.step) == 4


@pytest.mark.parametrize("flag", ["--production-mesh", "--multi-pod"])
def test_mesh_flags_raise(tmp_path, flag, monkeypatch):
    # the production meshes need 256 and 512 ranks; this run is one
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    size = {"--production-mesh": 256, "--multi-pod": 512}[flag]
    argv = ["--production-mesh", "--multi-pod"][: 1 + (size == 512)]
    with pytest.raises(ValueError, match=f"needs {size} ranks"):
        tlaunch.main(_argv(tmp_path, *argv))


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = tregistry.get_reduced("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstep.init_train_state(torch.Generator(), cfg)
    argv = _argv(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(argv[:argv.index("--device")]
                     + argv[argv.index("--device") + 2:])
