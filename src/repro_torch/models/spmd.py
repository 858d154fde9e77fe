"""The model's ops on a mesh: the forms that attention, decode attention,
the float32-result product, the experts, the SSD, the embedding lookup
and the PQ-KV decode step take when their input is a ``DTensor`` (the
reference lets XLA's SPMD partitioner lay them out; here each rank runs
the one-device code on its blocks through ``local_map``).  On a mesh of
one device every form runs the one-device code on whole tensors, so the
host mesh keeps the one-device bits.

Full-sequence attention (train, prefill, the encoder): the batch lies on
the DP axes and the heads on ``model``, as the column-parallel ``wq`` /
``wk`` / ``wv`` leave them.  A rank holds heads ``[h0, h0 + H/m)``; where
its KV heads are its own (``G`` divisible by ``m`` and whole groups per
rank) it keeps ``k`` and ``v`` sharded, else it gathers them over
``model``: ``wk`` / ``wv`` columns are ``G * hd`` and 16 shards cut a
head in two.  That gather is the port's, not the reference's layout, so
the cost pass lists it as forced.  Each rank's heads then attend as on
one card (:func:`~repro_torch.models.layers._attend_chunks`), whole GQA
groups in the one-card layout, single heads with their group's keys
otherwise.

Decode attention over a cache whose sequence axis lies on ``model``
becomes a ``model``-axis reduction (the reference's partition docstring):
the step's query, key and value are replicated over ``model`` (one
token's, a small gather), and each rank runs the one-device decode core
(``layers._decode_attend``; ``serve/pqkv.py``'s ``_pq_write_attend``
around row 11) on its positions, given their first, ``s0``, and a
``model``-axis ``reduce``: the rank that holds ``pos`` writes it, and the
ranks merge with the softmax's global maximum and denominator (an
all-reduce of the max, then of the sums) before one all-reduce of the
weighted values.  Only the order of the sums differs from the one-card
step; where the cache is not split the core runs without ``reduce``, as
on one card.

A ``local_map`` input that each rank uses for its own share of the work
(a weight over its batch rows, keys over its heads) gets a gradient of
partial sums (:func:`_grad_layout`); the other forms are documented
where they are defined.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..sharding.partition import (batch_like, is_dtensor, model_all_reduce,
                                  model_axis, planned_redistribute,
                                  replicate_model)

__all__ = ["attention_mesh", "attention_decode_mesh", "mm_f32_mesh",
           "moe_mesh", "pq_attn_block_mesh", "ssd_forward_mesh",
           "ssd_decode_step_mesh", "embed_mesh"]


def _shard_of(x, dim: int) -> bool:
    """True when DTensor ``x`` lies split along ``dim`` over a ``model``
    axis of more than one rank."""
    m, _, mdim = model_axis(x.device_mesh)
    return m > 1 and x.placements[mdim].is_shard(dim)


def _local(fn, out, mesh, grads=None):
    """``local_map`` of ``fn`` with one output laid out as ``out``;
    ``grads`` gives each DTensor input's gradient layout where it is not
    the input's own (:func:`_grad_layout`)."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=list(out), device_mesh=mesh,
                     in_grad_placements=grads)


def _grad_layout(t, batch_split: bool, model_split: bool):
    """The layout of the gradient a rank computes for DTensor input ``t``
    of a local function.  Where ``t`` is split, the rank's gradient is its
    block's.  Where ``t`` is replicated, each rank adds only what its own
    work contributes: partial sums over the DP axes when that work covers
    its batch rows (``batch_split``), over ``model`` when it covers its
    own heads or experts (``model_split``); a rank that repeats the same
    work holds the whole gradient."""
    if t is None or not is_dtensor(t):
        return None
    from torch.distributed.tensor import Partial, Replicate
    out = []
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        split = model_split if name == "model" else batch_split
        out.append(pl if not pl.is_replicate()
                   else Partial() if split else Replicate())
    return out


def attention_mesh(p, cfg, x, positions, *, causal: bool, window: int,
                   q_chunk: int, cos_sin: Optional[Tuple],
                   kv: Optional[Tuple], kv_mask) -> torch.Tensor:
    """:func:`~repro_torch.models.layers.attention` of a DTensor ``x``
    (module docstring)."""
    from .layers import _attend_chunks, _dot, apply_rope, rotary
    mesh = x.device_mesh
    m, coord, _ = model_axis(mesh)
    H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    R = H // G
    B, S, _ = x.shape
    q2 = _dot(x, p.wq, p.bq)                                 # (B, S, H hd)
    if H % m == 0 and _shard_of(q2, 2):
        h0, Hl = coord * (H // m), H // m
    else:
        q2 = replicate_model(q2, planned=False, label="attention: q heads")
        h0, Hl = 0, H
    if kv is None:
        k2, v2 = _dot(x, p.wk, p.bk), _dot(x, p.wv, p.bv)
    else:                       # (B, Sk, G * hd) or (B, Sk, G, hd)
        k2, v2 = (t.flatten(2) for t in kv)
    if (Hl < H and G % m == 0 and Hl % R == 0 and _shard_of(k2, 2)
            and _shard_of(v2, 2)):
        g0, Gl = coord * (G // m), G // m
    else:
        k2, v2 = (replicate_model(t, planned=False,
                                  label="attention: kv heads split by model")
                  for t in (k2, v2))
        g0, Gl = 0, G
    if cos_sin is None:
        cos_sin = rotary(positions, hd, cfg.rope_theta)
    cos, sin = (batch_like(t, q2) for t in cos_sin)
    mask = batch_like(kv_mask, q2)
    scale = hd ** -0.5

    def local(ql, kl, vl, cosl, sinl, maskl):
        Bl, Sk = ql.shape[0], kl.shape[1]
        kl = kl.reshape(Bl, Sk, Gl, hd)
        vl = vl.reshape(Bl, Sk, Gl, hd)
        if kv is None:
            kl = apply_rope(kl, cosl, sinl)
        if Hl % R == 0:                   # whole groups: the one-card form
            first = h0 // R - g0
            q = ql.reshape(Bl, S, Hl // R, R, hd)
            kl = kl[:, :, first:first + Hl // R]
            vl = vl[:, :, first:first + Hl // R]
        else:                             # a head at a time, its group's k
            idx = torch.tensor([(h0 + j) // R - g0 for j in range(Hl)],
                               device=kl.device)
            q = ql.reshape(Bl, S, Hl, 1, hd)
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        q = apply_rope(q, cosl, sinl)
        out = _attend_chunks(q, kl, vl, causal=causal, window=window,
                             q_chunk=q_chunk, scale=scale,
                             cap=cfg.attn_softcap, kv_mask=maskl)
        return out.reshape(Bl, S, Hl * hd)

    heads = Hl < H                      # ranks attend with their own heads
    grads = tuple(_grad_layout(t, False, heads)
                  for t in (q2, k2, v2, cos, sin, mask))
    out = _local(local, q2.placements, mesh, grads)(q2, k2, v2, cos, sin,
                                                    mask)
    return _dot(out, p.wo)


def _split_seq(cache, mesh):
    """``(s0, reduce)`` of this rank's share of a cache ``(B, Smax, ...)``
    whose sequence lies on a ``model`` axis of more than one rank: its
    first position and the ``model``-axis reduction that merges the
    ranks' attention; ``(0, None)`` (one rank's code) otherwise."""
    m, coord, _ = model_axis(mesh)
    if not _shard_of(cache, 1):
        return 0, None
    return (coord * (cache.shape[1] // m),
            lambda t, op: model_all_reduce(t, op, mesh))


def attention_decode_mesh(p, cfg, x, k_cache, v_cache, pos: int, *,
                          window: int, update_cache: bool,
                          cos_sin: Optional[Tuple]) -> torch.Tensor:
    """:func:`~repro_torch.models.layers.attention_decode` of a DTensor
    ``x`` over DTensor caches ``(B, Smax, G, hd)`` (module docstring):
    each rank runs the one-device core
    (:func:`~repro_torch.models.layers._decode_attend`) on its share."""
    from .layers import _decode_attend, _dot, rotary
    mesh = x.device_mesh
    B = x.shape[0]
    q2 = replicate_model(_dot(x, p.wq, p.bq))
    kn = vn = None
    if update_cache:
        kn = replicate_model(_dot(x, p.wk, p.bk))
        vn = replicate_model(_dot(x, p.wv, p.bv))
    if cos_sin is None:
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        cos_sin = rotary(positions, cfg.head_dim_, cfg.rope_theta)
    cos, sin = (batch_like(t, q2) for t in cos_sin)
    s0, reduce = _split_seq(k_cache, mesh)
    if reduce is None or not _shard_of(v_cache, 1):   # one card's, whole
        s0, reduce = 0, None
        k_cache, v_cache = (replicate_model(
            t, planned=False, label="decode: cache not split by model")
            for t in (k_cache, v_cache))

    def local(ql, knl, vnl, kc, vc, cosl, sinl):
        return _decode_attend(cfg, ql, knl, vnl, (cosl, sinl), kc, vc, pos,
                              window=window, s0=s0, reduce=reduce)

    out = _local(local, q2.placements, mesh)(q2, kn, vn, k_cache, v_cache,
                                             cos, sin)
    return _dot(out, p.wo)


def _dp_dims(mesh):
    """The DP mesh dims (``pod``, ``data``), major first."""
    return [i for i, n in enumerate(mesh.mesh_dim_names)
            if n in ("pod", "data")]


def mm_f32_mesh(x, w):
    """``_dot_f32`` of DTensors ``x (n, d)`` and ``w (d, e)``, each rank
    running the one-device form on its blocks (``torch.mm(...,
    out_dtype=float32)`` has no ``DTensor`` strategy): rows of ``x`` and
    columns of ``w`` keep their split, a split contraction gives partial
    sums.  A mesh dim they split otherwise is gathered first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from .layers import _dot_f32
    mesh = x.device_mesh
    xs, ws, out = list(x.placements), list(w.placements), []
    gx, gw = [], []                     # the gradients' layouts
    for i, (px, pw) in enumerate(zip(xs, ws)):
        if px.is_shard(1) and pw.is_shard(0):
            out.append(Partial())
            gx.append(px), gw.append(pw)
        elif px.is_shard(0) and pw.is_replicate():
            out.append(Shard(0))
            gx.append(px), gw.append(Partial())
        elif px.is_replicate() and pw.is_shard(1):
            out.append(Shard(1))
            gx.append(Partial()), gw.append(pw)
        else:
            xs[i], ws[i] = Replicate(), Replicate()
            out.append(Replicate())
            gx.append(Replicate()), gw.append(Replicate())
    if xs != list(x.placements):
        x = x.redistribute(mesh, xs)
    if ws != list(w.placements):
        w = w.redistribute(mesh, ws)
    return _local(_dot_f32, out, mesh, (gx, gw))(x, w)


def _gather_dp(t, mesh):
    """``t`` (a local block of rows) gathered along dim 0 over the DP
    axes, rows in the global order (differentiable)."""
    import torch.distributed._functional_collectives as funcol
    for dim in reversed(_dp_dims(mesh)):          # minor axis first
        if mesh.size(dim) > 1:
            t = funcol.all_gather_tensor_autograd(t, 0, (mesh, dim))
    return t


def moe_mesh(p, cfg, x, capacity_factor: float):
    """:func:`~repro_torch.models.layers.moe` of a DTensor ``x (B, S,
    d)``, the reference's expert-parallel layout: experts on ``model``,
    each expert's capacity rows on the DP axes.

    Every rank routes its own tokens (the same float32 routing), and the
    routing weights ``(T, E)`` and the tokens are gathered over the DP
    axes, since an expert takes its ``C`` best tokens among all ``T``
    (``C`` from the global token count, as on one card).  A rank then runs
    its experts on its share of their capacity rows and adds the weighted
    outputs into float32 ``(T, d)`` partial sums, which are reduced over
    every axis back to the token's rows (a reduce-scatter over DP, an
    all-reduce over ``model``) and rounded to bf16 once.  One card adds
    them in bf16 expert by expert; the sums agree to the rounding of
    more than two terms.  The token gather is listed as forced in the
    cost pass: the reference's compiler may move tokens by all-to-all."""
    from torch.distributed.tensor import Partial, Replicate
    from ..sharding.partition import constrain_batch, forced_gather
    from .layers import BF16, _act, _dot, mlp, moe_capacity, top_k
    mesh = x.device_mesh
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_active_experts
    T = B * S
    C = moe_capacity(cfg, T, capacity_factor)
    m, coord, _ = model_axis(mesh)
    El = E // m if E % m == 0 else E
    e0 = coord * El if El < E else 0
    n_dp, i_dp = 1, 0
    for dim in _dp_dims(mesh):
        n_dp, i_dp = n_dp * mesh.size(dim), (
            i_dp * mesh.size(dim) + mesh.get_coordinate()[dim])
    Cl = C // n_dp if C % n_dp == 0 else C
    c0 = i_dp * Cl if Cl < C else 0
    xf = constrain_batch(x.reshape(T, d))
    wg, wu, wd = p.we_gate, p.we_up, p.we_down

    def local(xl, router, wgl, wul, wdl):
        logits = _dot(xl, router).float()
        probs = torch.softmax(logits, dim=-1)
        top_w, top_i = top_k(probs, k)
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
        Wl = torch.zeros((xl.shape[0], E), dtype=torch.float32,
                         device=xl.device)
        Wl.scatter_(1, top_i, top_w)
        with forced_gather("moe: routing and tokens over dp"):
            W = _gather_dp(Wl, mesh)                       # (T, E)
            xa = _gather_dp(xl, mesh)                      # (T, d)
        w_ec, tok_ec = top_k(W.T[e0:e0 + El], C)           # (El, C)
        w_ec, tok_ec = w_ec[:, c0:c0 + Cl], tok_ec[:, c0:c0 + Cl]
        xg = xa[tok_ec.reshape(-1)].reshape(El, Cl, d).to(BF16).float()
        g = torch.bmm(xg, wgl.to(BF16).float())
        u = torch.bmm(xg, wul.to(BF16).float())
        h = (_act(g, cfg.act) * u).to(BF16)
        y = torch.bmm(h, wdl.to(BF16)) * w_ec[..., None].to(BF16)
        out = torch.zeros((T, d), dtype=torch.float32, device=xl.device)
        for e in range(El):
            out = out.index_add(0, tok_ec[e], y[e].float())
        return out

    # a split of the experts or of the capacity rows sums over its axes
    names = mesh.mesh_dim_names
    split = [(n == "model" and El < E) or (n != "model" and Cl < C)
             for n in names]
    batch = any(xf.placements[i].is_shard() for i in _dp_dims(mesh))
    grads = (_grad_layout(xf, False, El < E),
             _grad_layout(p.router, batch, El < E),
             *(_grad_layout(w, Cl < C, El < E) for w in (wg, wu, wd)))
    out = _local(local, [Partial() if s else Replicate() for s in split],
                 mesh, grads)(xf, p.router, wg, wu, wd)
    out = constrain_batch(out).to(BF16)
    if p.shared is not None:
        out = out + constrain_batch(mlp(p.shared, xf.to(BF16), cfg.act))
    return out.reshape(B, S, d)


def pq_attn_block_mesh(attn_p, cfg, x, lc, pos: int, *, pqc, window: int,
                       cos_sin) -> torch.Tensor:
    """The PQ-KV decode step of one layer (``serve/pqkv.py``'s
    ``_pq_attn_block``) on a DTensor ``x`` over a DTensor compressed
    cache: the query, key and value replicated over ``model``, then each
    rank runs the one-device core (``serve/pqkv.py``'s
    ``_pq_write_attend``) on its share.  Where the cache's sequence lies
    on ``model`` the rank holding ``pos`` writes its codes (and value),
    every rank writes the ring, and the kernel route runs row 11
    (``pq_attn``) on the rank's positions, the ranks merging its ``(o, m,
    l)`` by the log-sum-exp rule (an all-reduce of the max, then of the
    weighted sums) before the ring, as on one card."""
    from ..serve.pqkv import _pq_write_attend
    from .layers import _dot
    mesh = x.device_mesh
    q2 = replicate_model(_dot(x, attn_p.wq, attn_p.bq))
    kn = replicate_model(_dot(x, attn_p.wk, attn_p.bk))
    vn = replicate_model(_dot(x, attn_p.wv, attn_p.bv))
    cos, sin = (batch_like(t, q2) for t in cos_sin)
    s0, reduce = _split_seq(lc.k_codes, mesh)

    def local(ql, knl, vnl, cosl, sinl, *parts):
        return _pq_write_attend(cfg, ql, knl, vnl, (cosl, sinl),
                                type(lc)(*parts), pos, pqc=pqc,
                                window=window, s0=s0, reduce=reduce)

    out = _local(local, q2.placements, mesh)(q2, kn, vn, cos, sin,
                                             *tuple(lc))
    return _dot(out, attn_p.wo)


def _gated_norm(y, norm, eps: float, mesh, split: bool):
    """The SSM's gated RMS norm of ``y (..., din)`` float32 on this rank's
    channels: the mean square over every channel (an all-reduce of the
    sums over ``model`` where ``din`` is split), then the bf16 scaling of
    :func:`~repro_torch.models.layers.rms_norm`."""
    from .layers import BF16, rms_norm
    x = y.to(BF16)
    if not split:
        return rms_norm(x, norm, eps)
    din = x.shape[-1] * model_axis(mesh)[0]
    var = model_all_reduce(x.float().square().sum(dim=-1, keepdim=True),
                           "sum", mesh) / din
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + norm.to(x.dtype))


def ssd_forward_mesh(p, cfg, x, chunk: int):
    """:func:`~repro_torch.models.ssm.ssd_forward` of a DTensor ``x (B, T,
    d)``: the projections as ``DTensor`` products (``z``, ``x`` and ``dt``
    column-parallel over ``model``, ``B`` and ``C`` whole), then each rank
    runs the convolutions, the chunked scan, the skip and the gate on its
    own heads (``ssm._ssd_core``), the gated norm's mean square summed
    over ``model``, and ``out_proj`` row-parallel (partial sums over
    ``model``)."""
    from .layers import _dot, _dot_f32
    from .ssm import _ssd_core
    mesh = x.device_mesh
    z, xr, dtr = (_dot_f32(x, w) for w in (p.wz, p.wx, p.wdt))
    Br, Cr = (_shared_proj(x, w) for w in (p.wB, p.wC))
    split = _shard_of(xr, 2)
    if not (split and _shard_of(z, 2) and _shard_of(dtr, 2)):
        z, xr, dtr = (replicate_model(t, planned=False,
                                      label="ssm: heads not split")
                      for t in (z, xr, dtr))
        split = False

    def local(zl, xl, bl, cl, dl, *leaves):
        pl = type(p)(*leaves)
        outs = dict(wz=zl, wx=xl, wB=bl, wC=cl, wdt=dl)
        y, _ = _ssd_core(pl, cfg, outs.__getitem__, chunk, None)
        return _gated_norm(y, pl.norm, cfg.norm_eps, mesh, split)

    leaves = tuple(p)
    if not split:
        leaves = tuple(replicate_model(t, planned=False,
                                       label="ssm: heads not split")
                       for t in leaves)
    batch = any(xr.placements[i].is_shard() for i in _dp_dims(mesh))
    grads = tuple(_grad_layout(t, False, split) for t in (z, xr, Br, Cr, dtr))
    grads += tuple(_grad_layout(t, batch, split) for t in leaves)
    yn = _local(local, xr.placements, mesh, grads)(z, xr, Br, Cr, dtr,
                                                   *leaves)
    return _dot(yn, p.out_proj)


class _GatherModel(torch.autograd.Function):
    """This rank's block along ``dim`` gathered over ``model`` into a whole
    that every ``model`` rank holds alike.  The gradient of that whole
    arrives whole on every rank (reduced before), so a block's gradient is
    its own slice of it: nothing is sent back (an all-gather's own
    backward, a reduce-scatter, would add the ranks' equal copies)."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        import torch.distributed._functional_collectives as funcol
        _, coord, mdim = model_axis(mesh)
        ctx.dim, ctx.coord, ctx.n = dim, coord, t.shape[dim]
        with planned_redistribute():
            out = funcol.all_gather_tensor(t.contiguous(), dim, (mesh, mdim))
            return funcol.wait_tensor(out)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.coord * ctx.n, ctx.n), None, None


def _shared_proj(x, w):
    """``_dot_f32(x, w)`` of a projection every head shares (the SSD's
    ``B`` and ``C``: ``w`` whole on ``model``), whole on every ``model``
    rank.  Each rank projects its ``1/m`` of the positions and the ranks
    gather the rest, so no rank repeats another's products; the rows'
    products are the one-device ones.  Without a split (one rank on
    ``model``, or positions ``m`` does not divide) every rank projects
    all of them."""
    from .layers import _dot_f32
    mesh = x.device_mesh
    m, coord, dim = model_axis(mesh)
    T = x.shape[1]
    w = replicate_model(w)
    if m == 1 or T % m or _shard_of(x, 1) or _shard_of(x, 2):
        return replicate_model(_dot_f32(x, w))

    def local(xl, wl):
        part = xl[:, coord * (T // m):(coord + 1) * (T // m)]
        return _GatherModel.apply(_dot_f32(part, wl), mesh, 1)

    batch = any(x.placements[i].is_shard() for i in _dp_dims(mesh))
    return _local(local, x.placements, mesh,
                  (_grad_layout(x, False, True),
                   _grad_layout(w, batch, True)))(x, w)


def ssd_decode_step_mesh(p, cfg, x, state):
    """:func:`~repro_torch.models.ssm.ssd_decode_step` of a DTensor ``x
    (B, 1, d)`` over DTensor states (the SSD state's heads and the
    x-convolution's channels on ``model``, the B / C convolutions' whole),
    each rank on its own heads as :func:`ssd_forward_mesh`."""
    from .layers import _dot, _dot_f32
    from .ssm import _decode_core
    mesh = x.device_mesh
    z, xr, dtr = (_dot_f32(x, w)[:, 0] for w in (p.wz, p.wx, p.wdt))
    Br, Cr = (replicate_model(_dot_f32(x, w)[:, 0]) for w in (p.wB, p.wC))
    split = (_shard_of(xr, 1) and _shard_of(z, 1) and _shard_of(dtr, 1)
             and _shard_of(state[0], 1) and _shard_of(state[1], 2))
    if not split:
        z, xr, dtr = (replicate_model(t, planned=False,
                                      label="ssm: heads not split")
                      for t in (z, xr, dtr))
        state = tuple(replicate_model(t, planned=False,
                                      label="ssm: heads not split")
                      for t in state)
    leaves = tuple(p) if split else tuple(
        replicate_model(t, planned=False, label="ssm: heads not split")
        for t in p)

    def local(zl, xl, bl, cl, dl, S, cx, cB, cC, *pl):
        pl = type(p)(*pl)
        outs = dict(wz=zl, wx=xl, wB=bl, wC=cl, wdt=dl)
        y, new = _decode_core(pl, cfg, outs.__getitem__, (S, cx, cB, cC))
        return (_gated_norm(y, pl.norm, cfg.norm_eps, mesh, split),) + new

    outs = (_out_like(xr, 3),) + tuple(t.placements for t in state)
    yn, *new = _local_multi(local, outs, mesh)(z, xr, Br, Cr, dtr, *state,
                                               *leaves)
    return _dot(yn, p.out_proj), tuple(new)


def _out_like(t, ndim: int):
    """Placements of a tensor of ``ndim`` dims laid out as DTensor ``t``
    on its batch and its last dim."""
    from torch.distributed.tensor import Shard
    return [Shard(ndim - 1) if pl.is_shard() and pl.dim == t.ndim - 1
            else pl for pl in t.placements]


def _local_multi(fn, outs, mesh):
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=tuple(list(o) for o in outs),
                     device_mesh=mesh)


def embed_mesh(table, tokens):
    """``table[tokens]`` of a DTensor table: where the vocabulary is split
    over ``model``, ``DTensor`` 's masked lookup (``F.embedding``: a
    partial sum over ``model``); else each rank looks its own rows up in
    its whole table, as one device does (the same gather and the same
    gradient scatter, so the host mesh keeps the one-device bits)."""
    import torch.nn.functional as F
    mesh = table.device_mesh
    if any(p.is_shard() and mesh.size(i) > 1
           for i, p in enumerate(table.placements)):
        return F.embedding(tokens.long(), table)
    tokens = batch_like(tokens, table) if not is_dtensor(tokens) else tokens
    batch = any(tokens.placements[i].is_shard() for i in _dp_dims(mesh))
    return _local(lambda t, i: t[i.long()], tokens.placements, mesh,
                  (_grad_layout(table, batch, False), tokens.placements)
                  )(table, tokens)
