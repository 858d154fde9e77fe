"""The port's encoder-decoder (seamless-m4t-large-v2 at its reduced config)
and the attention forms it needs, held against the JAX package on the
CPU, on the reference's own weights carried across by
``encdec_params_from_numpy``.  The reference runs jitted.

Tolerances, as ``test_torch_lm``: bf16 tensors (encoder output, cross and
self K/V caches) within one bf16 ulp at the tensor's largest magnitude
(``_ulps``), float32 logits within ``LOGIT_ATOL = 2e-2``, greedy tokens
equal.  The decoder's final hidden states through ``forward_encdec`` are
held within ``HIDDEN_ULPS`` (2): XLA's default excess precision keeps
some residual sums in float32 there; with it off they are within one
ulp, and every check here holds at one ulp
(``test_encdec_without_excess_precision``).  The port's
``forward_encdec`` is also held against its own token-by-token decode
(``OWN_CORR``, ``OWN_TOP1``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.serve.cache import init_cache as j_init_cache
from repro.serve.decode import prefill_cache_encdec as j_prefill_encdec
from repro.serve.decode import serve_step as j_serve_step
from repro_torch.configs import registry as tregistry
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serve.cache import init_cache
from repro_torch.serve.decode import prefill_cache_encdec, serve_step

CPU = torch.device("cpu")
ARCH = "seamless-m4t-large-v2"
LOGIT_ATOL = 2e-2
HIDDEN_ULPS = 2
OWN_CORR = 0.9999
OWN_TOP1 = 0.98


def _ulps(got, want) -> float:
    """Largest difference of two bf16 tensors in units of one bf16 ulp at
    the reference tensor's largest magnitude."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    return float(np.abs(got - want).max() / ulp)


def _rnd(rng, a, scale=0.1):
    return (scale * rng.standard_normal(np.shape(a))).astype(np.float32)


def _np_params(jcfg, seed=0):
    """The reference's parameters as numpy, with random norm scales (the
    reference initialises them to zero)."""
    p = jax.tree.map(np.asarray, jencdec.init_params_encdec(
        jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    enc = p.enc_blocks._replace(ln1=_rnd(rng, p.enc_blocks.ln1),
                                ln2=_rnd(rng, p.enc_blocks.ln2))
    dec = p.dec_blocks._replace(ln1=_rnd(rng, p.dec_blocks.ln1),
                                ln_x=_rnd(rng, p.dec_blocks.ln_x),
                                ln2=_rnd(rng, p.dec_blocks.ln2))
    return p._replace(enc_blocks=enc, dec_blocks=dec,
                      enc_norm=_rnd(rng, p.enc_norm),
                      final_norm=_rnd(rng, p.final_norm))


def _both(seed=0):
    jcfg, tcfg = jregistry.get_reduced(ARCH), tregistry.get_reduced(ARCH)
    npp = _np_params(jcfg, seed)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, npp),
            tencdec.encdec_params_from_numpy(npp, tcfg, device=CPU))


def _frames(cfg, B, seed=0):
    f = np.random.default_rng(seed + 50).standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return jnp.asarray(f), torch.from_numpy(f)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_encdec_params_from_numpy_layouts():
    """Encoder layer ``i`` and decoder layer ``i`` are the stacked
    arrays' ``i``-th, every weight bf16 and equal to the reference's."""
    jcfg, tcfg = jregistry.get_reduced(ARCH), tregistry.get_reduced(ARCH)
    npp = _np_params(jcfg)
    tp = tencdec.encdec_params_from_numpy(npp, tcfg, device=CPU)
    assert len(tp.enc_blocks) == tcfg.n_enc_layers
    assert len(tp.dec_blocks) == tcfg.n_layers

    def same(t, a):
        want = torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
        assert t.dtype == torch.bfloat16 and torch.equal(t, want)

    same(tp.embed, npp.embed)
    same(tp.frame_proj, npp.frame_proj)
    same(tp.lm_head, npp.lm_head)
    same(tp.enc_norm, npp.enc_norm)
    for i, blk in enumerate(tp.enc_blocks):
        same(blk.ln2, npp.enc_blocks.ln2[i])
        same(blk.attn.wo, npp.enc_blocks.attn.wo[i])
        same(blk.mlp.w_up, npp.enc_blocks.mlp.w_up[i])
    for i, blk in enumerate(tp.dec_blocks):
        same(blk.ln_x, npp.dec_blocks.ln_x[i])
        same(blk.self_attn.wq, npp.dec_blocks.self_attn.wq[i])
        same(blk.cross_attn.wk, npp.dec_blocks.cross_attn.wk[i])
        same(blk.mlp.w_down, npp.dec_blocks.mlp.w_down[i])


@pytest.mark.parametrize("form", ["bidirectional", "cross_masked"])
def test_attention_forms_match_reference(form):
    """``attention(causal=False)`` (the encoder) and cross-attention
    (the reference's ``kv_override=(k, v, kv_mask)``, the port's ``kv=(k,
    v), kv_mask=``) with some keys masked out, in
    query chunks of 8: the output within one bf16 ulp.  Cross-attention
    ropes the queries (here at real positions, so the rotation shows) and
    takes the keys as given."""
    jcfg, tcfg = jregistry.get_reduced(ARCH), tregistry.get_reduced(ARCH)
    npp = _np_params(jcfg)
    tp = tencdec.encdec_params_from_numpy(npp, tcfg, device=CPU)
    rng = np.random.default_rng(3)
    B, S, Sk, G, hd = 2, 16, 24, tcfg.n_kv_heads, tcfg.head_dim_
    x = jnp.asarray(rng.standard_normal((B, S, tcfg.d_model)), jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kw_j, kw_t = {}, {}
    if form == "cross_masked":
        k = jnp.asarray(rng.standard_normal((B, Sk, G, hd)), jnp.bfloat16)
        v = jnp.asarray(rng.standard_normal((B, Sk, G, hd)), jnp.bfloat16)
        mask = rng.random((B, Sk)) < 0.7
        mask[:, 0] = True
        kw_j["kv_override"] = (k, v, jnp.asarray(mask))
        kw_t["kv"] = tuple(
            torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
            for a in (k, v))
        kw_t["kv_mask"] = torch.from_numpy(mask)
        blk_j = jax.tree.map(lambda a: jnp.asarray(a[0]),
                             npp.dec_blocks.cross_attn)
        blk_t = tp.dec_blocks[0].cross_attn
    else:
        blk_j = jax.tree.map(lambda a: jnp.asarray(a[0]), npp.enc_blocks.attn)
        blk_t = tp.enc_blocks[0].attn
    want = jax.jit(lambda p, x_, po, kw: jlayers.attention(
        p, jcfg, x_, po, causal=False, q_chunk=8, **kw))(
        blk_j, x, jnp.asarray(pos), kw_j)
    got = tlayers.attention(blk_t, tcfg, tx, torch.from_numpy(pos),
                            causal=False, q_chunk=8, **kw_t)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _ulps(got.float(), want) <= 1


def test_attention_decode_reads_without_writing():
    """``attention_decode(update_cache=False)``: the cache is left as it
    was, and the output is the reference's (cross-attention decode at
    position ``Sf - 1`` with position-0 tables)."""
    jcfg, tcfg, jp, tp = _both()
    rng = np.random.default_rng(4)
    B, Sf, G, hd = 2, tcfg.n_frontend_tokens, tcfg.n_kv_heads, tcfg.head_dim_
    kc = jnp.asarray(rng.standard_normal((B, Sf, G, hd)), jnp.bfloat16)
    vc = jnp.asarray(rng.standard_normal((B, Sf, G, hd)), jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((B, 1, tcfg.d_model)), jnp.bfloat16)
    zero = jlayers.rotary(jnp.zeros((B, 1), jnp.int32), hd, jcfg.rope_theta)
    blk_j = jax.tree.map(lambda a: a[1], jp.dec_blocks.cross_attn)
    want, _, _ = jax.jit(lambda p, x_, k, v, cs: jlayers.attention_decode(
        p, jcfg, x_, k, v, jnp.int32(Sf - 1), update_cache=False,
        cos_sin=cs))(blk_j, x, kc, vc, zero)
    tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
              for a in (kc, vc))
    before = (tk.clone(), tv.clone())
    got = tlayers.attention_decode(
        tp.dec_blocks[1].cross_attn, tcfg,
        torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16),
        tk, tv, Sf - 1, update_cache=False,
        cos_sin=tencdec.zero_cos_sin(tcfg, B, 1, CPU))
    assert torch.equal(tk, before[0]) and torch.equal(tv, before[1])
    assert _ulps(got.float(), want) <= 1


def test_encode_and_cross_kv_match_reference():
    """The bidirectional encoder's output and every decoder layer's cross
    K/V within one bf16 ulp."""
    jcfg, tcfg, jp, tp = _both()
    jf, tf = _frames(tcfg, 2)
    want = jax.jit(lambda p, f: jencdec.encode_frames(p, jcfg, f))(jp, jf)
    got = tencdec.encode_frames(tp, tcfg, tf)
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, tcfg.n_frontend_tokens, tcfg.d_model)
    assert _ulps(got.float(), want) <= 1
    for i, blk in enumerate(tp.dec_blocks):
        jb = jax.tree.map(lambda a: a[i], jp.dec_blocks.cross_attn)
        jk, jv = jencdec.cross_kv(jb, jcfg, want)
        tk, tv = tencdec.cross_kv(blk.cross_attn, tcfg, got)
        assert _ulps(tk.float(), jk) <= 1 and _ulps(tv.float(), jv) <= 1


def test_forward_encdec_matches_reference():
    """``forward_encdec`` over 16 frames and 24 tokens, query chunks of 8:
    logits within ``LOGIT_ATOL``, final hidden states within
    ``HIDDEN_ULPS``."""
    _forward_run(HIDDEN_ULPS)


def test_encdec_without_excess_precision():
    """The reference compiled without excess precision: the decoder's
    final hidden states within one bf16 ulp, and the prefill and decode
    checks of ``test_serve_step_matches_reference`` (in a subprocess,
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
    code = ("import test_torch_encdec as t\n"
            "t._forward_run(1)\n"
            "t.test_serve_step_matches_reference()\n"
            "print('within one ulp')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "within one ulp" in proc.stdout, proc.stdout


def _forward_run(hidden_ulps):
    jcfg, tcfg, jp, tp = _both()
    jf, tf = _frames(tcfg, 2)
    toks = _tokens(tcfg, 2, 24)
    jb = {"frames": jf, "tokens": jnp.asarray(toks)}
    tb = {"frames": tf, "tokens": torch.from_numpy(toks)}
    want = np.asarray(jax.jit(lambda p, b: jencdec.forward_encdec(
        p, jcfg, b, q_chunk=8))(jp, jb))
    got = tencdec.forward_encdec(tp, tcfg, tb, q_chunk=8)
    assert got.shape == want.shape == (2, 24, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)
    hid_j = np.asarray(jax.jit(lambda p, b: jencdec.forward_encdec(
        p, jcfg, b, q_chunk=8, return_hidden=True))(jp, jb))
    hid_t = tencdec.forward_encdec(tp, tcfg, tb, q_chunk=8,
                                   return_hidden=True)
    assert _ulps(hid_t.float(), hid_j) <= hidden_ulps


def test_serve_step_matches_reference():
    """``prefill_cache_encdec`` then a 12-token prompt fed one token at a
    time and 4 greedy steps, in both packages: the cross caches after the
    prefill and the self caches after every step within one bf16 ulp,
    the logits within ``LOGIT_ATOL``, the greedy tokens equal; the cross
    caches are never written by a step."""
    jcfg, tcfg, jp, tp = _both(seed=1)
    B, S, gen = 2, 12, 4
    jf, tf = _frames(tcfg, B, seed=1)
    toks = _tokens(tcfg, B, S, seed=1)
    jc = j_init_cache(jcfg, B, S + gen)
    tc = init_cache(tcfg, B, S + gen, device=CPU)
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: v.shape for k, v in jc.items()}
    jc = jax.jit(lambda p, c, f: j_prefill_encdec(p, jcfg, c, f))(jp, jc, jf)
    tc = prefill_cache_encdec(tp, tcfg, tc, tf)
    for name in ("cross_k", "cross_v"):
        assert tc[name].dtype == torch.bfloat16
        assert _ulps(tc[name].float(), jc[name]) <= 1, name
    cross = {n: tc[n].clone() for n in ("cross_k", "cross_v")}
    j_step = jax.jit(lambda p, c, t, pos: j_serve_step(p, jcfg, c, t, pos))
    j_tok, t_tok = jnp.asarray(toks[:, :1]), torch.from_numpy(toks[:, :1])
    for pos in range(S + gen):
        jl, jc = j_step(jp, jc, j_tok, jnp.int32(pos))
        tl, tc = serve_step(tp, tcfg, tc, t_tok, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, err_msg=str(pos))
        for name in ("self_k", "self_v"):
            assert _ulps(tc[name].float(), jc[name]) <= 1, (name, pos)
        if pos + 1 < S:
            nxt = toks[:, pos + 1:pos + 2]
            j_tok, t_tok = jnp.asarray(nxt), torch.from_numpy(nxt)
        else:
            j_tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
            t_tok = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
            np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    assert all(torch.equal(tc[n], t) for n, t in cross.items())


def test_forward_encdec_matches_own_decode():
    """The port's ``forward_encdec`` over 64 tokens against its own
    ``prefill_cache_encdec`` and 64 ``serve_step``s: logits at correlation
    ``OWN_CORR`` or better, argmax agreement ``OWN_TOP1`` or better."""
    _, tcfg, _, tp = _both(seed=2)
    B, S = 2, 64
    _, tf = _frames(tcfg, B, seed=2)
    toks = torch.from_numpy(_tokens(tcfg, B, S, seed=2))
    fwd = tencdec.forward_encdec(tp, tcfg, {"frames": tf, "tokens": toks})
    cache = prefill_cache_encdec(tp, tcfg, init_cache(tcfg, B, S, device=CPU),
                                 tf)
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


def test_lm_init_params_refuses_encdec():
    """``lm.init_params`` raises ``ValueError`` for encdec naming
    ``models.encdec``, as the reference's does."""
    cfg = tregistry.get_reduced(ARCH)
    with pytest.raises(ValueError, match="models.encdec"):
        tlm.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    with pytest.raises(ValueError, match="models.encdec"):
        tlm.forward(None, cfg, {"tokens": torch.zeros((1, 2), dtype=torch.int32)})
