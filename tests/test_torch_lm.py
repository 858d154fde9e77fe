"""The port's LM (``forward``, ``prefill``, ``serve_step``) held against
the JAX package on the CPU, on the reference's own weights carried across
by ``params_from_numpy``: the dense family (internlm2, qwen2 with QKV
biases, gemma2's local/global layers with sandwich norms, softcaps and a
scaled embedding), the moe family (deepseek-moe with shared experts,
qwen3-moe without) and the vlm family (qwen2-vl with and without patch
embeddings, M-RoPE), each at its reduced config.  The reference runs
jitted, as its launcher runs it.

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
flag is read when JAX starts).  gemma2 keeps more bf16 intermediates in
float32 under excess precision (the embedding's scale, the sandwich
norms), so its final hidden states are held within two ulps at their
scale, not one (``HIDDEN_ULPS``); with excess precision off its hidden
states equal the port's bit for bit, and the moe and vlm families' caches
and logits too, through prefill and three decode steps
(``test_families_bit_exact_without_excess_precision``).
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
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ModelConfig
from repro_torch.serve.cache import init_cache
from repro_torch.serve.decode import serve_step
from repro_torch.serve.prefill import prefill

CPU = "cpu"
LOGIT_ATOL = 2e-2
# final hidden states: bf16 ulps at their scale (default 1)
HIDDEN_ULPS = {"gemma2-27b": 2}
# the tiny config of tests/test_pqkv.py
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16)
ARCHS = ("tiny", "internlm2-1.8b", "qwen2-72b")   # qwen2: QKV bias
# the other families' reduced configs ("+patches": a vlm batch with patch
# embeddings, so M-RoPE's grid positions and the projection run)
FAMILY_CASES = ("gemma2-27b", "deepseek-moe-16b", "qwen3-moe-30b-a3b",
                "qwen2-vl-72b", "qwen2-vl-72b+patches")


def _cfgs(arch):
    arch = arch.split("+")[0]
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
    for name in ("post_attn_ln", "post_mlp_ln"):     # gemma2's sandwich
        if getattr(blocks, name, None) is not None:
            blocks = blocks._replace(**{name: rnd(getattr(blocks, name))})
    return p._replace(blocks=blocks, final_norm=rnd(p.final_norm))


def _both(arch, seed=0):
    jcfg, tcfg = _cfgs(arch)
    npp = _np_params(jcfg, seed)
    jp = jax.tree.map(jnp.asarray, npp)
    return jcfg, tcfg, jp, tlm.params_from_numpy(npp, tcfg, device=CPU)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _batches(case, cfg, B, S, seed=0):
    """The same batch for both packages: tokens, and for a ``+patches``
    case ``n_frontend_tokens`` patch embeddings."""
    toks = _tokens(cfg, B, S, seed)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if case.endswith("+patches"):
        pt = np.random.default_rng(seed + 100).standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(pt), torch.from_numpy(pt)
    return jb, tb


def _prompt_len(cfg):
    """24 positions, or 8 past gemma2's window, so that it cuts."""
    return cfg.sliding_window + 8 if cfg.sliding_window else 24


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


@pytest.mark.parametrize("arch", ARCHS + FAMILY_CASES)
def test_forward_matches_reference(arch):
    _forward_run(arch)


def _forward_run(arch):
    """``forward`` in both packages: logits within ``LOGIT_ATOL``, final
    hidden states within ``HIDDEN_ULPS``; ``("exact",)`` if the hidden
    states are bit-identical."""
    jcfg, tcfg, jp, tp = _both(arch)
    S = 32 + tcfg.sliding_window // 2       # gemma2: past its window of 32
    jb, tb = _batches(arch, tcfg, 2, S)
    # q_chunk=8: several query chunks, as a long prompt takes
    want = np.asarray(jax.jit(lambda p, b: jlm.forward(
        p, jcfg, b, q_chunk=8))(jp, jb))
    got = tlm.forward(tp, tcfg, tb, q_chunk=8).numpy()
    assert got.shape == want.shape == (2, S, tcfg.padded_vocab)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    hid_j = np.asarray(jax.jit(lambda p, b: jlm.forward(
        p, jcfg, b, q_chunk=8, return_hidden=True))(jp, jb))
    hid_t = tlm.forward(tp, tcfg, tb, q_chunk=8, return_hidden=True)
    assert hid_t.dtype == torch.bfloat16
    assert _ulps(hid_t.float(), hid_j) <= HIDDEN_ULPS.get(arch, 1)
    return ("exact",) if np.array_equal(hid_t.float().numpy(),
                                        hid_j.astype(np.float32)) else ()


@pytest.mark.parametrize("arch", ARCHS[:2] + FAMILY_CASES)
def test_prefill_and_greedy_decode_match_reference(arch):
    """Prefill a 24-token prompt (gemma2: 40, past its window of 32) into a
    cache 8 slots longer, then 4 greedy decode steps in both packages:
    caches within 1 bf16 ulp, logits within ``LOGIT_ATOL``, identical
    greedy tokens."""
    _decode_run(arch, steps=4)


def _decode_run(arch, steps, exact=False):
    """Prefill and ``steps`` greedy decode steps in both packages, checked
    after each; ``exact``: caches must be bit-identical."""
    jcfg, tcfg, jp, tp = _both(arch, seed=1)
    B = 2
    S = _prompt_len(tcfg)
    max_len = S + 8
    jb, tb = _batches(arch, tcfg, B, S, seed=1)

    def check_caches(step):
        for name in ("k", "v"):
            got, want = tc[name].float().numpy(), np.asarray(jc[name],
                                                            np.float32)
            if exact:
                assert np.array_equal(got, want), (name, step)
            else:
                assert _ulps(got, want) <= 1, (name, step)

    j_pre = jax.jit(lambda p, c, b: j_prefill(p, jcfg, c, b, q_chunk=8))
    j_step = jax.jit(lambda p, c, t, pos: j_serve_step(p, jcfg, c, t, pos))
    jl, jc = j_pre(jp, j_init_cache(jcfg, B, max_len), jb)
    tc = init_cache(tcfg, B, max_len, device=CPU)
    tl, tc = prefill(tp, tcfg, tc, tb, q_chunk=8)
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


def test_families_bit_exact_without_excess_precision():
    """The reference compiled without excess precision: gemma2's final
    hidden states equal the port's bit for bit; the moe (deepseek's shared
    experts, qwen3's 128-expert layout cut down) and vlm (with patches)
    reduced configs give the port's caches bit for bit through prefill and
    three decode steps.  (gemma2's caches are not checked bit for bit: its
    attention softcap's ``tanh`` is XLA's approximation, not PyTorch's.)"""
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
            "print('gemma2', *t._forward_run('gemma2-27b'))\n"
            "for arch in ('deepseek-moe-16b', 'qwen3-moe-30b-a3b', "
            "'qwen2-vl-72b+patches'):\n"
            "    print(arch, *t._decode_run(arch, steps=3, exact=True))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("exact") == 4, proc.stdout


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


NEW_FAMILIES = ("mamba2-780m", "zamba2-2.7b", "seamless-m4t-large-v2")


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_families_params_and_cache_layouts(arch):
    """The ssm, hybrid and encdec families: ``init_params`` /
    ``init_params_encdec`` give the reference's parameter shapes (the
    hybrid's ``(groups, attn_every)`` stacking flattened to layers), bf16
    weights and float32 SSM leaves, and ``init_cache`` the reference's
    cache shapes and dtypes (the hybrid's states with a flat layer axis),
    all zero."""
    from repro.models import encdec as jencdec
    from repro_torch.models import encdec as tencdec
    jcfg, cfg = _cfgs(arch)
    gen = torch.Generator().manual_seed(0)
    if cfg.family == "encdec":
        ref = jax.eval_shape(lambda: jencdec.init_params_encdec(
            jax.random.PRNGKey(0), jcfg))
        p = tencdec.init_params_encdec(cfg, gen, device=CPU)
        pairs = [(p.embed, ref.embed), (p.frame_proj, ref.frame_proj),
                 (p.lm_head, ref.lm_head)]
        for name in ("enc_blocks", "dec_blocks"):
            ours, theirs = getattr(p, name), getattr(ref, name)
            assert len(ours) == jax.tree.leaves(theirs)[0].shape[0]
            pairs += zip(jax.tree.leaves(tuple(ours[-1])),
                         [jax.ShapeDtypeStruct(a.shape[1:], a.dtype)
                          for a in jax.tree.leaves(theirs)])
    else:
        ref = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
        p = tlm.init_params(cfg, gen, device=CPU)
        assert len(p.blocks) == cfg.n_layers
        assert (p.shared_attn is not None) == (cfg.family == "hybrid")
        pairs = [(p.embed, ref.embed)]
        lead = 2 if cfg.family == "hybrid" else 1
        for field in tssm.SsmParams._fields:
            want = getattr(ref.blocks.ssm, field)
            pairs.append((getattr(p.blocks[0].ssm, field),
                          jax.ShapeDtypeStruct(want.shape[lead:],
                                               want.dtype)))
            f32 = field.startswith("conv") or field in ("a_log", "d_skip",
                                                        "dt_bias")
            assert getattr(p.blocks[-1].ssm, field).dtype == (
                torch.float32 if f32 else torch.bfloat16), field
        if cfg.family == "hybrid":
            pairs += list(zip(jax.tree.leaves(tuple(p.shared_attn)),
                              jax.tree.leaves(ref.shared_attn)))
    for leaf, want in pairs:
        assert tuple(leaf.shape) == tuple(want.shape)
    cache = init_cache(cfg, 2, 8, device=CPU)
    want = j_init_cache(jcfg, 2, 8)
    assert sorted(cache) == sorted(want)
    for name, t in cache.items():
        w = want[name]
        shape = (w.shape if cfg.family != "hybrid" or name.startswith("attn")
                 else (cfg.n_layers, *w.shape[2:]))
        assert tuple(t.shape) == tuple(shape), name
        assert str(t.dtype).split(".")[-1] == str(w.dtype), name
        assert not t.any()


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_families_refuse_batched_prefill_and_pqkv(arch):
    """Batched ``prefill`` and PQ-KV (``init_pq_cache``,
    ``compress_cache``, ``pq_serve_step``) raise ``NotImplementedError``
    naming the family for ssm, hybrid and encdec, as the reference
    refuses them."""
    from repro_torch.serve import pqkv
    _, cfg = _cfgs(arch)
    fam = cfg.family
    tokens = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match=fam):
        prefill(None, cfg, {}, tokens)
    with pytest.raises(NotImplementedError, match=fam):
        pqkv.init_pq_cache(cfg, pqkv.PQKVConfig(), 1, 8,
                           torch.zeros((2, 2, 8, 256, 2)), device=CPU)
    with pytest.raises(NotImplementedError, match=fam):
        pqkv.compress_cache({}, cfg, pqkv.PQKVConfig(), pos=4)
    with pytest.raises(NotImplementedError, match=fam):
        pqkv.pq_serve_step(None, cfg, None, tokens["tokens"][:, :1], 4,
                           pqc=pqkv.PQKVConfig())


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_serve_cli_new_families_on_cpu(arch):
    """The launcher serves the ssm, hybrid and encdec families on the CPU,
    prefilling one token at a time (encdec after encoding its frames);
    ``--pqkv`` raises naming the family; without ``--device`` and without
    a card it raises."""
    import contextlib
    import io
    from repro_torch.launch import serve as tserve
    fam = tregistry.get_reduced(arch).family
    base = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
            "--gen", "3"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(base + ["--device", "cpu"])
    text = out.getvalue()
    for line in (f"family={fam}", "prefill 8 tokens", "decoded 2 steps x 2",
                 "sample output ids"):
        assert line in text, text
    with pytest.raises(NotImplementedError, match=fam):
        tserve.main(base + ["--device", "cpu", "--pqkv"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(base)


def test_mrope_tables_against_reference():
    """M-RoPE positions equal the reference's; the sectioned tables within
    one float32 ulp (cos/sin as in ``test_rope_tables_against_reference``),
    at the full config's head_dim 128 and sections 16/24/24 and at the
    reduced config's cut sections."""
    from repro.models import layers as jlayers
    for hd, sections, n_front in ((128, (16, 24, 24), 256),
                                  (16, (4, 6, 6), 8)):
        pos = np.broadcast_to(np.arange(300, dtype=np.int32), (2, 300))
        jm = np.asarray(jlayers.mrope_positions(jnp.asarray(pos), n_front,
                                                sections))
        tm = tlayers.mrope_positions(torch.from_numpy(pos.copy()), n_front,
                                     sections)
        np.testing.assert_array_equal(tm.numpy(), jm)
        jc, js = map(np.asarray, jax.jit(lambda m: jlayers._mrope_tables(
            m, hd, 1e6, sections))(jnp.asarray(jm)))
        tc, ts = tlayers._mrope_tables(tm, hd, 1e6, sections)
        for t, j in ((tc, jc), (ts, js)):
            assert t.shape == j.shape == (2, 300, hd // 2)
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=2 ** -23)


@pytest.mark.parametrize("arch", ["gemma2-27b", "deepseek-moe-16b",
                                  "qwen2-vl-72b"])
def test_params_from_numpy_layouts(arch):
    """gemma2's ``(L/2, 2)`` pairs become layers ``2j, 2j+1``; moe blocks
    carry the router, the experts and the shared experts; vlm the patch
    projection; every weight in bf16 equal to the reference's."""
    jcfg, tcfg = _cfgs(arch)
    npp = _np_params(jcfg)
    tp = tlm.params_from_numpy(npp, tcfg, device=CPU)
    assert len(tp.blocks) == tcfg.n_layers

    def same(t, a):
        want = torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
        assert t.dtype == torch.bfloat16 and torch.equal(t, want)

    for i, blk in enumerate(tp.blocks):
        if tcfg.local_global:
            j, k = divmod(i, 2)
            same(blk.post_attn_ln, npp.blocks.post_attn_ln[j, k])
            same(blk.post_mlp_ln, npp.blocks.post_mlp_ln[j, k])
            same(blk.attn.wq, npp.blocks.attn.wq[j, k])
            same(blk.mlp.w_down, npp.blocks.mlp.w_down[j, k])
            assert tlm.layer_window(tcfg, i) == (tcfg.sliding_window
                                                 if k == 0 else 0)
        elif tcfg.family == "moe":
            assert isinstance(blk, tlm.MoeBlock)
            for name in ("router", "we_gate", "we_up", "we_down"):
                same(getattr(blk.moe, name), getattr(npp.blocks.moe, name)[i])
            same(blk.moe.shared.w_up, npp.blocks.moe.shared.w_up[i])
        else:
            assert blk.post_attn_ln is None and blk.post_mlp_ln is None
            same(blk.attn.wk, npp.blocks.attn.wk[i])
    if tcfg.family == "vlm":
        same(tp.patch_proj, npp.patch_proj)
    else:
        assert tp.patch_proj is None


def test_prefill_with_patches_equals_forward():
    """The vlm prefill with patches (M-RoPE, the projection) gives the last
    position's logits of ``forward`` over the same batch."""
    jcfg, tcfg, _, tp = _both("qwen2-vl-72b")
    _, tb = _batches("qwen2-vl-72b+patches", tcfg, 2, 24)
    want = tlm.forward(tp, tcfg, tb, q_chunk=8)[:, -1:]
    got, _ = prefill(tp, tcfg, init_cache(tcfg, 2, 24, device=CPU), tb,
                     q_chunk=8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["gemma2-27b", "deepseek-moe-16b",
                                  "qwen3-moe-30b-a3b", "qwen2-vl-72b"])
def test_init_params_families(arch):
    """Random parameters of every family: the reference's shapes, bf16,
    and a forward pass with finite logits."""
    jcfg, cfg = _cfgs(arch)
    p = tlm.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    ref = _np_params(jcfg)
    ours = tlm.params_from_numpy(ref, cfg, device=CPU)
    for a, b in zip(jax.tree.leaves(tuple(p)), jax.tree.leaves(tuple(ours))):
        assert a.shape == b.shape and a.dtype == b.dtype
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros((1, 2, cfg.d_model))
    assert torch.isfinite(tlm.forward(p, cfg, batch)).all()


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
