"""The port on a mesh across CPU ranks (``repro_torch.sharding.partition``,
``launch/mesh.py``, the model's mesh forms in ``models/spmd.py``).

Each multi-rank test spawns one group of four ``gloo`` processes on a
``(2, 2)`` mesh over ``("data", "model")``, rendezvousing through a
``FileStore`` under ``tmp_path`` (so pytest-xdist workers never race for a
port) and joined under ``JOIN_S``, after which the group is killed.  Rank 0
saves what it gathered; the test holds it against the same reduced config
run unsharded in this process from the same seed.

Tolerances.  On the mesh every row-parallel product (``wo``, ``w_down``,
the SSM's ``out_proj``, the experts' ``we_down``) sums its contraction in
``TP = 2`` partial sums, added after each is rounded to bf16, where one
device sums once; the decode attention merges ``TP = 2`` partial softmax
sums; the FSDP reduce-scatter of each gradient adds ``DP = 2`` partial
gradients.  A partial sum rounded to bf16 moves a value by at most one
bf16 ulp (2**-8 relative), so activations and logits are held within a few
bf16 ulps of their scale (``ACT_TOL``), the loss within ``LOSS_RTOL``,
each gradient within ``GRAD_RTOL`` of its norm (the one-device parity
tests' bound: bf16 cotangents), and the updated float32 masters within
``PARAM_TOL`` (one AdamW step of lr 3e-4 moves a weight by at most about
3e-4; a reordered gradient changes the step, not the weight, by that much
at most).
"""

from __future__ import annotations

import multiprocessing as mp
import time
import traceback

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.configs.registry import get_reduced
from repro_torch.data.tokens import TokenStream
from repro_torch.kernels import _build
from repro_torch.launch import cells, cost, mesh as tmesh
from repro_torch.sharding import partition as P
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.step import (init_train_state, make_loss_and_grads,
                                    make_train_step)

WORLD = 4
JOIN_S = 300
TP = DP = 2
# the loss: float32 sums of bf16 logits, TP-reordered (see above)
LOSS_RTOL = 1e-4
# each gradient leaf, as a relative norm: the bf16 cotangents carry the
# activations' reordered roundings (test_torch_train's GRAD_RTOL)
GRAD_RTOL = 5e-2
# bf16 activations and float32 logits: a few bf16 ulps (2**-8) of scale
ACT_TOL = dict(rtol=4 * 2 ** -8, atol=4 * 2 ** -8)
# the masters after one step (lr 3e-4): the step's size
PARAM_TOL = dict(rtol=0.0, atol=3e-4)
B, S = 4, 16
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# The group
# ---------------------------------------------------------------------------

def _worker(rank, store_path, case, out_path, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        mesh = tmesh.device_mesh(
            tmesh.MeshDesc((DP, TP), ("data", "model")), "cpu")
        out = CASES[case](mesh, *args)
        if rank == 0:
            torch.save(out, out_path)
    except BaseException:
        with open(f"{out_path}.rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _run_group(tmp_path, case, *args):
    ctx = mp.get_context("spawn")
    out = tmp_path / f"{case}.pt"
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp_path / "store"), case, str(out),
                               args)) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{case}: the group did not end within {JOIN_S} s"
    errors = "".join(e.read_text() for e in sorted(
        tmp_path.glob(f"{case}.pt.rank*.err")))
    assert [p.exitcode for p in procs] == [0] * WORLD, \
        f"{case}: exit codes {[p.exitcode for p in procs]}\n{errors}"
    return torch.load(out, weights_only=False)


# ---------------------------------------------------------------------------
# What each rank runs
# ---------------------------------------------------------------------------

def _batch(cfg):
    out = TokenStream(cfg.vocab_size, S, B).batch_at(0)
    extra = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
    if extra:
        out[extra] = np.random.default_rng(0).standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _train(cfg, mesh=None, steps=1):
    state = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = _batch(cfg)
    mb = None
    if mesh is not None:
        state = P.distribute(state, cells.state_specs(state, mesh), mesh)
        batch = P.distribute(batch, P.batch_specs(batch, mesh), mesh)
        mb = P.batch_specs({k: v[: B // 2] for k, v in batch.items()},
                           mesh)
    grads_of = make_loss_and_grads(cfg, q_chunk=8, microbatches=2,
                                   mb_constraint=mb)
    step = make_train_step(cfg, AdamWConfig(), q_chunk=8, microbatches=2,
                           mb_constraint=mb)
    losses = []
    with cells.mesh_context(mesh):
        grads = P.full(grads_of(state.params, batch)[2])
        for _ in range(steps):
            state, metrics = step(state, batch)
            losses.append(P.full(metrics["loss"]))
    return {"loss": torch.stack(losses), "grads": grads,
            "params": P.full(state.params)}


def _case_train(mesh, arch):
    return _train(get_reduced(arch), mesh)


def _prompted(cfg, S_max=32, prompt=24):
    """bf16 weights, the cache of a prompt served token by token on one
    device, and the next token."""
    from repro_torch.models.lm import init_params
    from repro_torch.serve.cache import init_cache
    from repro_torch.serve.decode import serve_step
    gen = torch.Generator().manual_seed(1)
    params = init_params(cfg, gen, "cpu")
    cache = init_cache(cfg, B, S_max, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, prompt + 2), generator=gen,
                         dtype=torch.int32)
    for p in range(prompt):
        _, cache = serve_step(params, cfg, cache, toks[:, p:p + 1], p)
    return params, cache, toks


def _decode(cfg, mesh, pqc=None, steps=2, prompt=24):
    from repro_torch.serve.decode import serve_step
    from repro_torch.serve.pqkv import compress_cache, pq_serve_step
    params, cache, toks = _prompted(cfg, prompt=prompt)
    if pqc is not None:
        cache = compress_cache(cache, cfg, pqc, pos=prompt,
                               generator=torch.Generator().manual_seed(2))
    if mesh is not None:
        params = P.distribute(params, P.param_specs(params, mesh,
                                                    fsdp=False), mesh)
        cache = P.distribute(cache, P.cache_specs(cache, mesh), mesh)
    logits = []
    with cells.mesh_context(mesh):
        for i in range(steps):
            tok = toks[:, prompt + i:prompt + i + 1]
            if mesh is not None:
                tok = P.distribute({"token": tok}, P.batch_specs(
                    {"token": tok}, mesh), mesh)["token"]
            if pqc is None:
                out, cache = serve_step(params, cfg, cache, tok, prompt + i)
            else:
                out, cache = pq_serve_step(params, cfg, cache, tok,
                                           prompt + i, pqc=pqc)
            logits.append(P.full(out))
    return {"logits": torch.stack(logits), "cache": P.full(cache)}


def _case_decode(mesh, arch):
    return _decode(get_reduced(arch), mesh)


def _pqc():
    from repro_torch.serve.pqkv import PQKVConfig
    return PQKVConfig(n_sub=4, codebook_size=16, recent_window=8,
                      kmeans_iters=3)


def _case_pq_decode(mesh, arch):
    return _decode(get_reduced(arch), mesh, pqc=_pqc())


def _case_ckpt(mesh, directory):
    from repro_torch.checkpoint.ckpt import save
    cfg = get_reduced("internlm2-1.8b")
    state = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    state = P.distribute(state, cells.state_specs(state, mesh), mesh)
    save(directory, 1, state)
    return {"placements": [str(t.placements)
                           for t in _tree.leaves(state.params)[:3]]}


def _host_bytes() -> int:
    """Bytes of every live plain tensor's storage in this process
    (storages shared by views counted once)."""
    import gc
    seen = {}
    for o in gc.get_objects():
        if type(o) is torch.Tensor and o.device.type == "cpu":
            st = o.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


# a gloo worker thread may hold a finished collective's buffers for a
# moment after the collective returns: a reading above the bound is taken
# again until they are let go, for at most this long
SETTLE_S = 1.0


def _settled_bytes(bound: int) -> int:
    """:func:`_host_bytes`, read again every 10 ms (after a collection of
    cycles) while above ``bound`` for up to ``SETTLE_S``: what the
    program itself holds stays."""
    import gc
    deadline = time.monotonic() + SETTLE_S
    got = _host_bytes()
    while got > bound and time.monotonic() < deadline:
        time.sleep(0.01)
        gc.collect()
        got = _host_bytes()
    return got


def _case_ckpt_peak(mesh, directory):
    """``save`` and ``AsyncCheckpointer.submit`` of a DTensor train state,
    the bytes of this rank's live tensors read after each leaf's gather:
    beyond what the rank held before, never more than the largest leaf."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.ckpt import AsyncCheckpointer, save
    cfg = get_reduced("internlm2-1.8b")
    state = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    largest = max(t.numel() * t.element_size() for t in _tree.leaves(state))
    state = P.distribute(state, cells.state_specs(state, mesh), mesh)
    gathered = DTensor.full_tensor
    peak = {}

    def tracked(self, *a, **k):
        out = gathered(self, *a, **k)
        peak["extra"] = max(peak.get("extra", 0),
                            _settled_bytes(base + largest) - base)
        return out

    base = _host_bytes()
    DTensor.full_tensor = tracked
    try:
        save(directory, 1, state)
        ck = AsyncCheckpointer(directory + "_async")
        ck.submit(2, state)
        ck.close()
    finally:
        DTensor.full_tensor = gathered
    assert 0 < peak["extra"] <= largest, (peak, largest)
    return {"extra": peak["extra"], "largest": largest}


CASES = {"train": _case_train, "decode": _case_decode,
         "pq_decode": _case_pq_decode, "ckpt": _case_ckpt,
         "ckpt_peak": _case_ckpt_peak}


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def _rel(got, want) -> float:
    n = float(want.norm())
    return float((got - want).norm()) / n if n > 0 else float(got.norm())


def _close_trees(got, want, **tol):
    for (path, g), (_, w) in zip(_tree.leaves_with_paths(got),
                                 _tree.leaves_with_paths(want)):
        torch.testing.assert_close(g.float(), w.float(), **tol,
                                   msg=lambda m: f"{path}: {m}")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b",
                                  "mamba2-780m"])
def test_train_step_on_2x2_equals_one_device(tmp_path, arch):
    got = _run_group(tmp_path, "train", arch)
    want = _train(get_reduced(arch))
    torch.testing.assert_close(got["loss"], want["loss"], rtol=LOSS_RTOL,
                               atol=0.0)
    for (path, g), (_, w) in zip(_tree.leaves_with_paths(got["grads"]),
                                 _tree.leaves_with_paths(want["grads"])):
        assert _rel(g, w) <= GRAD_RTOL, (_tree.path_name(path), _rel(g, w))
    _close_trees(got["params"], want["params"], **PARAM_TOL)


def test_exact_decode_with_a_sequence_sharded_cache(tmp_path):
    got = _run_group(tmp_path, "decode", "internlm2-1.8b")
    want = _decode(get_reduced("internlm2-1.8b"), None)
    torch.testing.assert_close(got["logits"], want["logits"], **ACT_TOL)
    _close_trees(got["cache"], want["cache"], **ACT_TOL)


def test_pq_decode_with_a_sequence_sharded_cache(tmp_path):
    got = _run_group(tmp_path, "pq_decode", "internlm2-1.8b")
    want = _decode(get_reduced("internlm2-1.8b"), None, pqc=_pqc())
    torch.testing.assert_close(got["logits"], want["logits"], **ACT_TOL)
    g, w = got["cache"], want["cache"]
    # the codes (every position's, the two steps' included) are the same
    # choices; the exact ring and values carry the activations' rounding
    assert torch.equal(g.k_codes, w.k_codes)
    assert torch.equal(g.k_books, w.k_books)
    for f in ("v", "k_recent", "v_recent"):
        torch.testing.assert_close(getattr(g, f), getattr(w, f), **ACT_TOL)


def test_checkpoint_saved_on_2x2_restores_on_one_device(tmp_path):
    from repro_torch.checkpoint.ckpt import latest_step, restore
    d = str(tmp_path / "ck")
    got = _run_group(tmp_path, "ckpt", d)
    assert "Shard" in " ".join(got["placements"])
    cfg = get_reduced("internlm2-1.8b")
    want = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    like = init_train_state(torch.Generator().manual_seed(9), cfg, "cpu")
    back = restore(d, latest_step(d), like)
    for (path, g), (_, w) in zip(_tree.leaves_with_paths(back),
                                 _tree.leaves_with_paths(want)):
        assert g.dtype == w.dtype and torch.equal(g, w), path


def test_checkpoint_on_2x2_holds_one_leaf_at_a_time(tmp_path):
    """Saving a sharded state, directly and through the async writer, a
    rank holds at most one whole leaf beyond its shards (every rank
    checks its own); both checkpoints restore bit for bit."""
    from repro_torch.checkpoint.ckpt import latest_step, restore
    d = str(tmp_path / "ck")
    got = _run_group(tmp_path, "ckpt_peak", d)
    assert 0 < got["extra"] <= got["largest"]
    cfg = get_reduced("internlm2-1.8b")
    want = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    like = init_train_state(torch.Generator().manual_seed(9), cfg, "cpu")
    for path in (d, d + "_async"):
        back = restore(path, latest_step(path), like)
        for g, w in zip(_tree.leaves(back), _tree.leaves(want)):
            assert torch.equal(g, w)


def test_checkpoint_restores_onto_the_host_mesh(tmp_path, host_mesh):
    """A checkpoint laid out for the mesh of the run that restores it:
    DTensors on the host mesh, whole again bit for bit."""
    from repro_torch.checkpoint.ckpt import restore, save
    cfg = get_reduced("internlm2-1.8b")
    want = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    save(str(tmp_path), 1, want)
    like = init_train_state(torch.Generator().manual_seed(9), cfg, "cpu")
    back = restore(str(tmp_path), 1, like, mesh=host_mesh,
                   specs=cells.state_specs(like, host_mesh))
    assert all(P.is_dtensor(t) for t in _tree.leaves(back))
    for g, w in zip(_tree.leaves(P.full(back)), _tree.leaves(want)):
        assert torch.equal(g, w)


def test_validate_search_mesh_errors():
    with pytest.raises(ValueError, match="expected a 1-D"):
        tmesh.validate_search_mesh(tmesh.make_host_mesh(), 1)
    with pytest.raises(ValueError, match="n_shards=4 but the mesh has 2"):
        tmesh.validate_search_mesh(tmesh.make_search_mesh(2), 4)
    tmesh.validate_search_mesh(tmesh.make_search_mesh(4), 4)


@pytest.mark.parametrize("flags,size", [
    (["--production-mesh"], 256),
    (["--production-mesh", "--multi-pod"], 512)])
def test_launchers_name_the_ranks_a_mesh_needs(tmp_path, monkeypatch, flags,
                                                size):
    from repro_torch.launch import serve, train
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match=f"needs {size} ranks.*has 4"):
        train.main(["--arch", "internlm2-1.8b", "--reduced", "--device",
                    "cpu", "--steps", "1", *flags])
    if size == 256:
        with pytest.raises(ValueError, match="needs 256 ranks"):
            serve.main(["--arch", "internlm2-1.8b", "--reduced",
                        "--device", "cpu", *flags])


def test_256_devices_count_internlm2_train_4k_as_one_card():
    """A fake group of 256 ranks counts the train cell per device on meta:
    its bf16 FLOPs times 256 fall within 1.10x of one card's count."""
    from repro_torch.configs.registry import SHAPES
    shape = SHAPES["train_4k"]
    card = cost.count_cell(cells.build_cell("internlm2-1.8b", shape))
    with cost.fake_group(tmesh.make_production_mesh()) as mesh:
        dev = cost.count_cell(cells.build_cell("internlm2-1.8b", shape,
                                               mesh))
    ratio = dev.flops_bf16 * 256 / card.flops_bf16
    assert 1.0 <= ratio <= 1.10, ratio
    assert dev.collectives["all-gather"] > 0
    assert dev.collectives["reduce-scatter"] > 0
    assert dev.peak_bytes < card.peak_bytes


# one core's output over sequence shards against one device's: the merge
# reorders the tail's float32 softmax sums before the one rounding to
# bf16, so an element moves by at most one bf16 ulp (2**-7 relative)
SPLIT_TOL = dict(rtol=2 ** -7, atol=2 ** -12)
ON_DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device_or_skip(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(device)


@pytest.mark.parametrize("device", ON_DEVICES)
@pytest.mark.parametrize("n,pos,window", [(2, 40, 0), (4, 20, 0),
                                          (4, 50, 24)])
def test_pq_decode_core_over_sequence_shards(device, n, pos, window):
    """``pq_attention_decode`` on ``n`` shards of the coded tail (``s0`` /
    ``reduce`` from ``shard_threads``), merged over the shards, equals the
    one-device call on the whole cache: on the card the kernel route (row
    11 on each shard's part of the tail, the log-sum-exp merge), on the
    CPU the plain route.  At ``pos`` 20 of 64 the tail (positions 0-12)
    lies in the first of four shards; the window (positions 27-42) cuts
    the first shard out."""
    from repro_torch.serve.pqkv import (PQKVCache, PQKVConfig,
                                        pq_attention_decode)
    dev = _device_or_skip(device)
    g = torch.Generator().manual_seed(n * 100 + pos)
    B, S, G, R, hd, M, K, W = 2, 64, 2, 2, 16, 4, 16, 8
    pqc = PQKVConfig(n_sub=M, codebook_size=K, recent_window=W)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    lc = PQKVCache(
        k_codes=torch.randint(0, K, (B, S, G, M), generator=g,
                              dtype=torch.uint8).to(dev),
        k_books=rnd(G, M, K, hd // M), v=rnd(B, S, G, hd, dtype=BF16),
        k_recent=rnd(B, W, G, hd, dtype=BF16),
        v_recent=rnd(B, W, G, hd, dtype=BF16), v_codes=None, v_books=None)
    q = rnd(B, G, R, hd, dtype=BF16)
    want = pq_attention_decode(q, lc, pos, pqc=pqc, window=window)
    Sl = S // n

    def shard(rank, reduce):
        part = lc._replace(k_codes=lc.k_codes[:, rank * Sl:(rank + 1) * Sl],
                           v=lc.v[:, rank * Sl:(rank + 1) * Sl])
        return pq_attention_decode(q, part, pos, pqc=pqc, window=window,
                                   s0=rank * Sl, reduce=reduce)

    before = _build.LAUNCHES["pq_attn"]
    got = P.shard_threads(shard, n)
    if dev.type == "cuda":
        assert _build.LAUNCHES["pq_attn"] - before == n
    for out in got:
        torch.testing.assert_close(out.float(), want.float(), **SPLIT_TOL)


@pytest.mark.parametrize("device", ON_DEVICES)
@pytest.mark.parametrize("n,window", [(2, 0), (4, 0), (4, 12)])
def test_exact_decode_core_over_sequence_shards(device, n, window):
    """``layers._decode_attend`` on ``n`` shards of an exact cache, the
    step written by the shard that holds ``pos``, equals the one-device
    call: the same output within one bf16 ulp, the same caches."""
    from repro_torch.models.layers import _decode_attend, rotary
    dev = _device_or_skip(device)
    cfg = get_reduced("internlm2-1.8b")
    H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g = torch.Generator().manual_seed(n + window)
    B, S, pos = 2, 32, 21

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev, BF16)

    kc, vc = rnd(B, S, G, hd), rnd(B, S, G, hd)
    q2, k2, v2 = rnd(B, 1, H * hd), rnd(B, 1, G * hd), rnd(B, 1, G * hd)
    cs = rotary(torch.full((B, 1), pos, dtype=torch.int32, device=dev), hd,
                cfg.rope_theta)
    k_one, v_one = kc.clone(), vc.clone()
    want = _decode_attend(cfg, q2, k2, v2, cs, k_one, v_one, pos,
                          window=window)
    Sl = S // n
    k_parts = [t.clone() for t in kc.chunk(n, dim=1)]
    v_parts = [t.clone() for t in vc.chunk(n, dim=1)]
    got = P.shard_threads(lambda r, reduce: _decode_attend(
        cfg, q2, k2, v2, cs, k_parts[r], v_parts[r], pos, window=window,
        s0=r * Sl, reduce=reduce), n)
    for out in got:
        torch.testing.assert_close(out.float(), want.float(), **SPLIT_TOL)
    assert torch.equal(torch.cat(k_parts, 1), k_one)
    assert torch.equal(torch.cat(v_parts, 1), v_one)


@pytest.fixture
def host_mesh(tmp_path):
    """The ``(1, 1)`` host mesh on a ``gloo`` group of one, in this
    process."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "host_store"), 1), rank=0, world_size=1)
    try:
        yield tmesh.device_mesh(tmesh.make_host_mesh(), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("what", ["train", "decode", "pq_decode"])
def test_host_mesh_equals_no_mesh_bit_for_bit(host_mesh, what):
    """On one device the partition is the identity: the ``DTensor`` run
    takes the one-device code on whole tensors, so every number is the
    meshless run's."""
    cfg = get_reduced("internlm2-1.8b")
    if what == "train":
        got, want = _train(cfg, host_mesh), _train(cfg)
        keys = ("loss", "grads", "params")
    else:
        pqc = _pqc() if what == "pq_decode" else None
        got, want = _decode(cfg, host_mesh, pqc), _decode(cfg, None, pqc)
        keys = ("logits", "cache")
    for k in keys:
        for (path, g), (_, w) in zip(_tree.leaves_with_paths(got[k]),
                                     _tree.leaves_with_paths(want[k])):
            assert torch.equal(g, w), (k, _tree.path_name(path))
