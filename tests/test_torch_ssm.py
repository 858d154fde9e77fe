"""The port's Mamba2 SSD blocks and the ssm / hybrid LM families held
against the JAX package on the CPU, on the reference's own weights carried
across by ``params_from_numpy`` (mamba2-780m and zamba2-2.7b at their
reduced configs).  The reference runs jitted, as its launcher runs it.

Tolerances:

* float32 SSM states (the scan's state, the convolutions' windows) within
  ``STATE_RTOL`` / ``STATE_ATOL`` (1e-4) of the reference on the same
  bf16 inputs: the ``cumsum``, the einsums over the state and the
  convolution step's sum over its taps add in XLA's order there and in
  PyTorch's here;
* bf16 outputs and KV caches within one bf16 ulp at the tensor's largest
  magnitude (``_ulps``), as ``test_torch_lm``;
* logits within ``LOGIT_ATOL = 2e-2``, greedy tokens equal.

Through the whole hybrid model (zamba2) a float32 sum that lands next to
a bf16 rounding boundary now and then rounds the other way in one
package, in the shared attention block or an SSM block's output, with
excess precision on or off: one activation an ulp apart, whose next
norm factor (rounded to bf16) scales a whole row by an ulp.  The SSM
states downstream are float32 functions of that row, so zamba2's are
held within ``STATE_ULPS`` bf16 ulps at their scale and its final hidden
states within ``HIDDEN_ULPS``, as gemma2's in ``test_torch_lm``; with
excess precision off its hidden states are within one ulp
(``test_hybrid_without_excess_precision``).  mamba2's states stay within
1e-4 through the model.

The port's full-sequence ``forward`` is also held against its own
token-by-token decode (``OWN_CORR``, top-1 agreement ``OWN_TOP1``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve.cache import init_cache as j_init_cache
from repro.serve.decode import serve_step as j_serve_step
from repro_torch.configs import registry as tregistry
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.serve.cache import init_cache
from repro_torch.serve.decode import serve_step

CPU = torch.device("cpu")
LOGIT_ATOL = 2e-2
STATE_RTOL = STATE_ATOL = 1e-4
OWN_CORR = 0.9999          # forward vs the port's own decode, logits
OWN_TOP1 = 0.98            # and their argmax agreement
ARCHS = ("mamba2-780m", "zamba2-2.7b")
# through the whole model, bf16 ulps at the tensor's scale (module
# docstring); an arch not listed holds states to STATE_RTOL / STATE_ATOL
# and hidden states to one ulp
STATE_ULPS = {"zamba2-2.7b": 2}
HIDDEN_ULPS = {"zamba2-2.7b": 2}


def _ulps(got, want) -> float:
    """Largest difference of two bf16 tensors in units of one bf16 ulp at
    the reference tensor's largest magnitude."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    return float(np.abs(got - want).max() / ulp)


def _close_state(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=STATE_RTOL, atol=STATE_ATOL,
                               err_msg=what)


def _rnd(rng, a, scale=0.1):
    """Random float32 numbers of ``a``'s shape (``a`` an array or a
    shape tuple)."""
    shape = a if isinstance(a, tuple) else np.shape(a)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _np_ssm(jcfg, seed=0):
    """One reference SSM layer as numpy, with random conv biases and norm
    scale (the reference initialises them to zero)."""
    p = jax.tree.map(np.asarray, jssm.init_ssm(jax.random.PRNGKey(seed),
                                               jcfg))
    rng = np.random.default_rng(seed)
    return p._replace(conv_bx=_rnd(rng, p.conv_bx),
                      conv_bB=_rnd(rng, p.conv_bB),
                      conv_bC=_rnd(rng, p.conv_bC), norm=_rnd(rng, p.norm))


def _np_params(jcfg, seed=0):
    """The reference's LM parameters as numpy, with random norm scales and
    conv biases so that they are exercised."""
    p = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(seed),
                                                 jcfg))
    rng = np.random.default_rng(seed)
    s = p.blocks.ssm
    blocks = p.blocks._replace(
        ln=_rnd(rng, p.blocks.ln),
        ssm=s._replace(conv_bx=_rnd(rng, s.conv_bx),
                       conv_bB=_rnd(rng, s.conv_bB),
                       conv_bC=_rnd(rng, s.conv_bC), norm=_rnd(rng, s.norm)))
    shared = p.shared_attn
    if shared is not None:
        shared = shared._replace(ln1=_rnd(rng, shared.ln1),
                                 ln2=_rnd(rng, shared.ln2))
    return p._replace(blocks=blocks, shared_attn=shared,
                      final_norm=_rnd(rng, p.final_norm))


def _both(arch, seed=0):
    jcfg, tcfg = jregistry.get_reduced(arch), tregistry.get_reduced(arch)
    npp = _np_params(jcfg, seed)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, npp),
            tlm.params_from_numpy(npp, tcfg, device=CPU))


def _bf16_input(rng, shape):
    """The same bf16 activations for both packages."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                    jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_dot_f32_keeps_the_float32_sum():
    """The SSM projections' product: bf16 operands, float32 result, no
    rounding to bf16 (``_dot`` rounds; this one must not)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 64), generator=g)
    w = torch.randn((64, 48), generator=g)
    got = tlayers._dot_f32(x, w)
    want = (x.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double())
    assert got.dtype == torch.float32 and got.shape == (3, 5, 48)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-5)
    assert not torch.equal(got, tlayers._dot(x, w).float())


@pytest.mark.parametrize("C,T", [(128, 40), (16, 7)])
def test_causal_conv_matches_reference(C, T):
    """Float32 depthwise causal conv + bias + silu, its taps added in the
    reference's order."""
    rng = np.random.default_rng(C)
    u = rng.standard_normal((2, T, C)).astype(np.float32)
    w = _rnd(rng, (4, C), 0.5)
    b = _rnd(rng, (C,))
    want = np.asarray(jax.jit(jssm._causal_conv)(u, w, b))
    got = tssm._causal_conv(*map(torch.from_numpy, (u, w, b)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,chunk", [(64, 16), (40, 16)],
                         ids=["4_chunks", "one_chunk"])
def test_ssd_forward_matches_reference(T, chunk):
    """``ssd_forward`` with an initial state and ``return_state``: several
    chunks of 16 (T = 64), and one chunk of ``T`` where 16 does not divide
    it (T = 40): the output within one bf16 ulp, the final state within
    the state tolerance."""
    jcfg = jregistry.get_reduced("mamba2-780m")
    tcfg = tregistry.get_reduced("mamba2-780m")
    p = _np_ssm(jcfg)
    tp = tlm._ssm_from_numpy(p, CPU)
    rng = np.random.default_rng(T)
    jx, tx = _bf16_input(rng, (2, T, jcfg.d_model))
    s0 = _rnd(rng, (2, jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state))
    jo, js = jax.jit(lambda p_, x, s: jssm.ssd_forward(
        p_, jcfg, x, chunk=chunk, initial_state=s, return_state=True))(
        jax.tree.map(jnp.asarray, p), jx, jnp.asarray(s0))
    to, ts = tssm.ssd_forward(tp, tcfg, tx, chunk=chunk,
                              initial_state=torch.from_numpy(s0),
                              return_state=True)
    assert to.dtype == torch.bfloat16 and to.shape == (2, T, jcfg.d_model)
    assert ts.dtype == torch.float32
    assert _ulps(to.float(), jo) <= 1
    _close_state(ts, js, "final state")
    # without the initial state and the final state: the same output path
    jo0 = jax.jit(lambda p_, x: jssm.ssd_forward(p_, jcfg, x, chunk=chunk))(
        jax.tree.map(jnp.asarray, p), jx)
    assert _ulps(tssm.ssd_forward(tp, tcfg, tx, chunk=chunk).float(),
                 jo0) <= 1


def test_ssd_decode_step_matches_reference():
    """Six recurrence steps from a random state: every step's output
    within one bf16 ulp and all four states within the state tolerance."""
    jcfg = jregistry.get_reduced("mamba2-780m")
    tcfg = tregistry.get_reduced("mamba2-780m")
    p = _np_ssm(jcfg, seed=1)
    tp = tlm._ssm_from_numpy(p, CPU)
    jp = jax.tree.map(jnp.asarray, p)
    rng = np.random.default_rng(1)
    state = [np.asarray(a) for a in jssm.init_ssm_state(jcfg, 2)]
    state = [_rnd(rng, a) for a in state]
    jst = tuple(map(jnp.asarray, state))
    tst = tuple(torch.from_numpy(a.copy()) for a in state)
    assert [t.shape for t in tssm.init_ssm_state(tcfg, 2, CPU)] == [
        a.shape for a in state]
    jstep = jax.jit(lambda p_, x, s: jssm.ssd_decode_step(p_, jcfg, x, s))
    for step in range(6):
        jx, tx = _bf16_input(rng, (2, 1, jcfg.d_model))
        jo, jst = jstep(jp, jx, jst)
        to, tst = tssm.ssd_decode_step(tp, tcfg, tx, tst)
        assert _ulps(to.float(), jo) <= 1, step
        for name, t, j in zip(tssm.SSM_STATES, tst, jst):
            assert t.dtype == torch.float32
            _close_state(t, j, f"{name} step {step}")


def test_ssd_forward_equals_its_decode_steps():
    """The chunked pass and the O(1) recurrence are one computation: the
    port's ``ssd_forward`` over 32 positions (chunks of 8) against 32 of
    its own decode steps: the outputs within one bf16 ulp, the final
    states within the state tolerance."""
    cfg = tregistry.get_reduced("mamba2-780m")
    p = tlm._ssm_from_numpy(_np_ssm(jregistry.get_reduced("mamba2-780m")),
                            CPU)
    _, x = _bf16_input(np.random.default_rng(2), (2, 32, cfg.d_model))
    out, S = tssm.ssd_forward(p, cfg, x, chunk=8, return_state=True)
    state = tssm.init_ssm_state(cfg, 2, CPU)
    steps = []
    for t in range(32):
        o, state = tssm.ssd_decode_step(p, cfg, x[:, t:t + 1], state)
        steps.append(o)
    assert _ulps(torch.cat(steps, 1).float(), out.float()) <= 1
    _close_state(state[0], S, "final state")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_ssm_layouts(arch):
    """Layer ``i`` of the hybrid is group ``i // attn_every``'s ``i %
    attn_every``-th; the shared block is one DenseBlock; the float32
    leaves stay float32, the projections are bf16, all equal to the
    reference's."""
    jcfg, tcfg = jregistry.get_reduced(arch), tregistry.get_reduced(arch)
    npp = _np_params(jcfg)
    tp = tlm.params_from_numpy(npp, tcfg, device=CPU)
    assert len(tp.blocks) == tcfg.n_layers
    f32 = ("conv_x", "conv_B", "conv_C", "conv_bx", "conv_bB", "conv_bC",
           "a_log", "d_skip", "dt_bias")
    for i, blk in enumerate(tp.blocks):
        assert isinstance(blk, tlm.SsmBlock)
        idx = divmod(i, tcfg.attn_every) if tcfg.family == "hybrid" else i
        for name in tssm.SsmParams._fields:
            dtype = torch.float32 if name in f32 else torch.bfloat16
            want = torch.from_numpy(np.array(
                getattr(npp.blocks.ssm, name)[idx], np.float32)).to(dtype)
            got = getattr(blk.ssm, name)
            assert got.dtype == dtype and torch.equal(got, want), name
    if tcfg.family == "hybrid":
        assert isinstance(tp.shared_attn, tlm.DenseBlock)
        assert torch.equal(tp.shared_attn.attn.wq, torch.from_numpy(
            np.array(npp.shared_attn.attn.wq, np.float32)).to(torch.bfloat16))
        assert [tlm.shared_slot(tcfg, i) for i in range(4)] == [0, None, 1,
                                                                None]
    else:
        assert tp.shared_attn is None and tp.lm_head is None   # tied


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """``forward`` over 64 positions with SSD chunks of 16: logits within
    ``LOGIT_ATOL``, final hidden states within ``HIDDEN_ULPS``."""
    _forward_run(arch, HIDDEN_ULPS.get(arch, 1))


def test_hybrid_without_excess_precision():
    """The reference compiled without excess precision: zamba2's final
    hidden states within one bf16 ulp of the port's (in a subprocess,
    since the flag is read when JAX starts)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           str(root / "tests")]))
    code = ("import test_torch_ssm as t\n"
            "t._forward_run('zamba2-2.7b', 1)\n"
            "print('within one ulp')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "within one ulp" in proc.stdout, proc.stdout


def _forward_run(arch, hidden_ulps):
    jcfg, tcfg, jp, tp = _both(arch)
    toks = _tokens(tcfg, 2, 64)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    want = np.asarray(jax.jit(lambda p, b: jlm.forward(
        p, jcfg, b, q_chunk=16, ssm_chunk=16))(jp, jb))
    got = tlm.forward(tp, tcfg, tb, q_chunk=16, ssm_chunk=16)
    assert got.shape == want.shape == (2, 64, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)
    hid_j = np.asarray(jax.jit(lambda p, b: jlm.forward(
        p, jcfg, b, q_chunk=16, ssm_chunk=16, return_hidden=True))(jp, jb))
    hid_t = tlm.forward(tp, tcfg, tb, q_chunk=16, ssm_chunk=16,
                        return_hidden=True)
    assert hid_t.dtype == torch.bfloat16
    assert _ulps(hid_t.float(), hid_j) <= hidden_ulps


def _ref_cache_flat(jcfg, cache):
    """The reference's cache as numpy with the hybrid's ``(groups,
    attn_every)`` state axes merged into the port's flat layer axis."""
    out = {}
    for name, a in cache.items():
        a = np.asarray(a, np.float32)
        if jcfg.family == "hybrid" and not name.startswith("attn_"):
            a = a.reshape(jcfg.n_layers, *a.shape[2:])
        out[name] = a
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_reference(arch):
    """A 12-token prompt fed one token at a time (as the launcher prefills
    these families), then 4 greedy steps, in both packages: after every
    step the logits within ``LOGIT_ATOL``, the SSM states within the state
    tolerance (zamba2's within ``STATE_ULPS``), the hybrid's KV slots
    within ``STATE_ULPS`` (the second slot's input comes through SSM
    blocks); the greedy tokens equal."""
    jcfg, tcfg, jp, tp = _both(arch, seed=1)
    B, S, gen = 2, 12, 4
    toks = _tokens(tcfg, B, S, seed=1)
    jc = j_init_cache(jcfg, B, S + gen)
    tc = init_cache(tcfg, B, S + gen, device=CPU)
    want_shapes = {k: v.shape for k, v in _ref_cache_flat(jcfg, jc).items()}
    assert {k: tuple(v.shape) for k, v in tc.items()} == want_shapes
    j_step = jax.jit(lambda p, c, t, pos: j_serve_step(p, jcfg, c, t, pos))
    j_tok, t_tok = jnp.asarray(toks[:, :1]), torch.from_numpy(toks[:, :1])
    for pos in range(S + gen):
        jl, jc = j_step(jp, jc, j_tok, jnp.int32(pos))
        tl, tc = serve_step(tp, tcfg, tc, t_tok, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, err_msg=str(pos))
        ref = _ref_cache_flat(jcfg, jc)
        for name, t in tc.items():
            if name.startswith("attn_"):       # slot 1 on lies downstream
                assert t.dtype == torch.bfloat16
                assert _ulps(t.float(), ref[name]) <= STATE_ULPS[arch], (
                    name, pos)
            elif arch in STATE_ULPS:
                assert t.dtype == torch.float32
                assert _ulps(t, ref[name]) <= STATE_ULPS[arch], (name, pos)
            else:
                assert t.dtype == torch.float32
                _close_state(t, ref[name], f"{name} pos {pos}")
        if pos + 1 < S:
            nxt = toks[:, pos + 1:pos + 2]
            j_tok, t_tok = jnp.asarray(nxt), torch.from_numpy(nxt)
        else:
            j_tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
            t_tok = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
            np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_own_decode(arch):
    """The port's ``forward`` over 256 tokens (SSD chunks of 128) against
    its own 256 ``serve_step``s: logits at correlation ``OWN_CORR`` or
    better, argmax agreement ``OWN_TOP1`` or better (the reference agrees
    with itself at 0.99999997 and 0.999998 here)."""
    _, tcfg, _, tp = _both(arch, seed=2)
    B, S = 2, 256
    toks = torch.from_numpy(_tokens(tcfg, B, S, seed=2))
    fwd = tlm.forward(tp, tcfg, {"tokens": toks})
    cache = init_cache(tcfg, B, S, device=CPU)
    steps = []
    for pos in range(S):
        lg, cache = serve_step(tp, tcfg, cache, toks[:, pos:pos + 1], pos)
        steps.append(lg)
    dec = torch.cat(steps, 1)
    corr = float(np.corrcoef(fwd.flatten().double().numpy(),
                             dec.flatten().double().numpy())[0, 1])
    top1 = float((fwd.argmax(-1) == dec.argmax(-1)).float().mean())
    assert corr >= OWN_CORR, corr
    assert top1 >= OWN_TOP1, top1
