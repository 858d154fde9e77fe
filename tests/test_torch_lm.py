"""The port's dense LM (``forward``, ``prefill``, ``serve_step``) held
against the JAX package on the CPU, on the reference's own weights carried
across by ``params_from_numpy``.  The reference runs jitted, as its
launcher runs it.

The port rounds to bf16 after every op where the reference's code does.
XLA's default ``--xla_allow_excess_precision`` lets the reference keep
some of those bf16 intermediates in float32 inside its fusions, so by
default the two differ in the last bf16 bit here and there.  Hence the
tolerances: every bf16 tensor within one bf16 ulp of its largest
magnitude (``_ulps``), float32 logits within ``atol=2e-2``, greedy tokens
equal.
With excess precision off, the reference's caches equal the port's bit
for bit through prefill and decode, and its logits within 1e-7
(``test_bit_exact_without_excess_precision``, in a subprocess, since the
flag is read when JAX starts).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JModelConfig
from repro.serve.cache import init_cache as j_init_cache
from repro.serve.decode import serve_step as j_serve_step
from repro.serve.prefill import prefill as j_prefill
from repro_torch.configs import registry as tregistry
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.serve.cache import init_cache
from repro_torch.serve.decode import serve_step
from repro_torch.serve.prefill import prefill

CPU = "cpu"
LOGIT_ATOL = 2e-2
# the tiny config of tests/test_pqkv.py
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16)
ARCHS = ("tiny", "internlm2-1.8b", "qwen2-72b")   # qwen2: QKV bias


def _cfgs(arch):
    if arch == "tiny":
        return JModelConfig(**TINY), ModelConfig(**TINY)
    return jregistry.get_reduced(arch), tregistry.get_reduced(arch)


def _ulps(got, want) -> float:
    """Largest difference of two bf16 tensors in units of one bf16 ulp at
    the reference tensor's largest magnitude."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    return float(np.abs(got - want).max() / ulp)


def _np_params(jcfg, seed=0):
    """The reference's parameters as numpy, with random norm scales (the
    reference initialises them to zero) so the norms are exercised, and
    random QKV biases where the config has them."""
    p = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(seed),
                                                 jcfg))
    rng = np.random.default_rng(seed)

    def rnd(a):
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    blocks = p.blocks
    attn = blocks.attn
    if attn.bq is not None:
        attn = attn._replace(bq=rnd(attn.bq), bk=rnd(attn.bk), bv=rnd(attn.bv))
    blocks = blocks._replace(ln1=rnd(blocks.ln1), ln2=rnd(blocks.ln2),
                             attn=attn)
    return p._replace(blocks=blocks, final_norm=rnd(p.final_norm))


def _both(arch, seed=0):
    jcfg, tcfg = _cfgs(arch)
    npp = _np_params(jcfg, seed)
    jp = jax.tree.map(jnp.asarray, npp)
    return jcfg, tcfg, jp, tlm.params_from_numpy(npp, tcfg, device=CPU)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", tregistry.ARCH_IDS)
def test_configs_equal_reference(arch):
    for get_j, get_t in ((jregistry.get_config, tregistry.get_config),
                         (jregistry.get_reduced, tregistry.get_reduced)):
        assert dataclasses.asdict(get_t(arch)) == dataclasses.asdict(
            get_j(arch))
    assert tregistry.ARCH_IDS == jregistry.ARCH_IDS


def test_params_from_numpy_round_trip():
    jcfg, tcfg = _cfgs("qwen2-72b")
    npp = _np_params(jcfg)
    tp = tlm.params_from_numpy(npp, tcfg, device=CPU)
    assert len(tp.blocks) == tcfg.n_layers and tp.lm_head is not None

    def same(t, a, dtype):
        want = torch.from_numpy(np.array(a, np.float32)).to(dtype)
        assert t.dtype == dtype and torch.equal(t, want)

    same(tp.embed, npp.embed, torch.bfloat16)
    same(tp.lm_head, npp.lm_head, torch.bfloat16)
    same(tp.final_norm, npp.final_norm, torch.bfloat16)
    for i, blk in enumerate(tp.blocks):
        same(blk.ln1, npp.blocks.ln1[i], torch.bfloat16)
        same(blk.ln2, npp.blocks.ln2[i], torch.bfloat16)
        for name in ("wq", "wk", "wv", "wo"):
            same(getattr(blk.attn, name), getattr(npp.blocks.attn, name)[i],
                 torch.bfloat16)
        for name in ("bq", "bk", "bv"):      # biases stay float32
            same(getattr(blk.attn, name), getattr(npp.blocks.attn, name)[i],
                 torch.float32)
        for name in ("w_gate", "w_up", "w_down"):
            same(getattr(blk.mlp, name), getattr(npp.blocks.mlp, name)[i],
                 torch.bfloat16)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = _both(arch)
    toks = _tokens(tcfg, 2, 32)
    # q_chunk=8: four query chunks, as a long prompt takes
    want = np.asarray(jax.jit(lambda p, t: jlm.forward(
        p, jcfg, {"tokens": t}, q_chunk=8))(jp, jnp.asarray(toks)))
    got = tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                      q_chunk=8).numpy()
    assert got.shape == want.shape == (2, 32, tcfg.padded_vocab)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    hid_j = np.asarray(jax.jit(lambda p, t: jlm.forward(
        p, jcfg, {"tokens": t}, q_chunk=8, return_hidden=True))(
            jp, jnp.asarray(toks)))
    hid_t = tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                        q_chunk=8, return_hidden=True)
    assert hid_t.dtype == torch.bfloat16
    assert _ulps(hid_t.float(), hid_j) <= 1


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_prefill_and_greedy_decode_match_reference(arch):
    """Prefill a 24-token prompt into a 32-slot cache, then 4 greedy decode
    steps in both packages: caches within 1 bf16 ulp, logits within
    ``LOGIT_ATOL``, identical greedy tokens."""
    _decode_run(arch, steps=4)


def _decode_run(arch, steps, exact=False):
    """Prefill and ``steps`` greedy decode steps in both packages, checked
    after each; ``exact``: caches must be bit-identical."""
    jcfg, tcfg, jp, tp = _both(arch, seed=1)
    B, S, max_len = 2, 24, 32
    toks = _tokens(tcfg, B, S, seed=1)

    def check_caches(step):
        for name in ("k", "v"):
            got, want = tc[name].float().numpy(), np.asarray(jc[name],
                                                            np.float32)
            if exact:
                assert np.array_equal(got, want), (name, step)
            else:
                assert _ulps(got, want) <= 1, (name, step)

    j_pre = jax.jit(lambda p, c, t: j_prefill(p, jcfg, c, {"tokens": t},
                                              q_chunk=8))
    j_step = jax.jit(lambda p, c, t, pos: j_serve_step(p, jcfg, c, t, pos))
    jl, jc = j_pre(jp, j_init_cache(jcfg, B, max_len), jnp.asarray(toks))
    tc = init_cache(tcfg, B, max_len, device=CPU)
    tl, tc = prefill(tp, tcfg, tc, {"tokens": torch.from_numpy(toks)},
                     q_chunk=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    check_caches("prefill")
    j_tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    t_tok = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
    for step in range(steps):
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        jl, jc = j_step(jp, jc, j_tok, jnp.int32(S + step))
        tl, tc = serve_step(tp, tcfg, tc, t_tok, S + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=1e-6 if exact else LOGIT_ATOL)
        check_caches(step)
        j_tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        t_tok = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
    return ("exact",) if exact else ()


def test_bit_exact_without_excess_precision():
    """The reference compiled without excess precision: prefill and three
    decode steps give the port's caches bit for bit (qwen2 reduced, with
    QKV biases, and internlm2 reduced)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           str(root / "tests")]))
    code = ("import test_torch_lm as t\n"
            "for arch in ('internlm2-1.8b', 'qwen2-72b'):\n"
            "    print(arch, *t._decode_run(arch, steps=3, exact=True))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("exact") == 2, proc.stdout


def test_rope_tables_against_reference():
    """Frequencies equal the reference's bit for bit; cos/sin within one
    float32 ulp (the reference's compiler approximates them)."""
    from repro.models import layers as jlayers
    pos = np.arange(0, 4096, 7, dtype=np.int32)[None]
    jc, js = map(np.asarray, jax.jit(
        lambda p: jlayers.rotary(p, 128, 1e4))(jnp.asarray(pos)))
    tc, ts = tlayers.rotary(torch.from_numpy(pos), 128, 1e4)
    for t, j in ((tc, jc), (ts, js)):
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=2 ** -23)


@pytest.mark.parametrize("family", ["moe", "vlm", "ssm", "hybrid", "encdec"])
def test_unported_families_raise(family):
    cfg = dataclasses.replace(ModelConfig(**TINY), family=family)
    with pytest.raises(NotImplementedError, match=family):
        tlm.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    with pytest.raises(NotImplementedError, match=family):
        init_cache(cfg, 1, 8, device=CPU)


def test_local_global_raises():
    cfg = tregistry.get_reduced("gemma2-27b")
    with pytest.raises(NotImplementedError, match="local/global"):
        tlm.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)


def test_init_params_shapes_and_scale():
    cfg = tregistry.get_reduced("internlm2-1.8b")
    p = tlm.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    assert p.embed.shape == (cfg.padded_vocab, cfg.d_model)
    assert p.embed.dtype == torch.bfloat16
    assert len(p.blocks) == cfg.n_layers
    std = float(p.blocks[0].mlp.w_up.float().std())
    assert 0.015 < std < 0.025
    logits = tlm.forward(p, cfg, {"tokens": torch.zeros((1, 4),
                                                        dtype=torch.int32)})
    assert torch.isfinite(logits).all()


def test_entry_points_need_a_card_unless_told():
    cfg = tregistry.get_reduced("internlm2-1.8b")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_params(cfg, torch.Generator().manual_seed(0))
