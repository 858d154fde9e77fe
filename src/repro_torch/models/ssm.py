"""Mamba2 SSD blocks (counterpart of :mod:`repro.models.ssm`).

Shapes follow the paper: inner width ``din = expand * d_model`` split into
``H = din / P`` heads of dim ``P``; state size ``N`` (one shared B/C
group).  The projections (z, x, B, C, dt) are separate weights, as in the
reference.

A full sequence takes the chunked SSD algorithm: a quadratic intra-chunk
term (batched ``(Q, Q)`` products) plus an inter-chunk recurrence, a loop
over the ``T / Q`` chunks.  Decode is the exact O(1) recurrence on cached
state.

Numerics follow the reference: the projections are bf16 products with a
float32 result (:func:`~repro_torch.models.layers._dot_f32`); the
convolutions, the scan and the gating run in float32, on the float32
leaves ``conv_*``, ``a_log``, ``d_skip`` and ``dt_bias``; the causal
convolution adds its ``ck`` shifted products in the reference's order;
softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus``.  Sums whose
order cannot follow XLA's (``cumsum``, the einsums) part from the
reference by float32 rounding.

The chunked pass and the recurrence give the same state:

>>> import torch
>>> from repro_torch.configs.registry import get_reduced
>>> cfg = get_reduced("mamba2-780m")
>>> cpu = torch.device("cpu")
>>> p = init_ssm(torch.Generator().manual_seed(0), cfg, cpu)
>>> x = torch.randn((2, 16, cfg.d_model),
...                 generator=torch.Generator().manual_seed(1)).bfloat16()
>>> out, S = ssd_forward(p, cfg, x, chunk=8, return_state=True)
>>> state = init_ssm_state(cfg, 2, cpu)
>>> for t in range(16):
...     o, state = ssd_decode_step(p, cfg, x[:, t:t + 1], state)
>>> bool(torch.allclose(state[0], S, rtol=1e-4, atol=1e-6))
True
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..sharding.partition import is_dtensor
from .config import ModelConfig
from .layers import BF16, _dot, _dot_f32, normal_weight, rms_norm

__all__ = ["SsmParams", "SSM_STATES", "init_ssm", "ssd_forward",
           "ssd_decode_step", "init_ssm_state"]

# the four per-layer states, in ``init_ssm_state``'s order (cache keys)
SSM_STATES = ("ssd", "conv_x", "conv_B", "conv_C")


class SsmParams(NamedTuple):
    wz: torch.Tensor         # (d, din)   gate
    wx: torch.Tensor         # (d, din)   ssm input
    wB: torch.Tensor         # (d, N)     input matrix (shared group)
    wC: torch.Tensor         # (d, N)     output matrix
    wdt: torch.Tensor        # (d, H)     timestep
    conv_x: torch.Tensor     # (ck, din)  depthwise causal conv, float32
    conv_B: torch.Tensor     # (ck, N)
    conv_C: torch.Tensor     # (ck, N)
    conv_bx: torch.Tensor    # (din,)     float32
    conv_bB: torch.Tensor    # (N,)
    conv_bC: torch.Tensor    # (N,)
    a_log: torch.Tensor      # (H,)       float32
    d_skip: torch.Tensor     # (H,)       float32
    dt_bias: torch.Tensor    # (H,)       float32
    norm: torch.Tensor       # (din,)
    out_proj: torch.Tensor   # (din, d)


def init_ssm(generator: torch.Generator, cfg: ModelConfig,
             device: torch.device, dtype: torch.dtype = BF16) -> SsmParams:
    """Random parameters at the reference's scale: ``N(0, 0.02)``
    projections (``dtype``: bf16, or float32 masters for training) and
    convolutions (float32), zero conv biases and norm, ``a_log =
    log(linspace(1, 16, H))``, ``d_skip = 1``, ``dt_bias = -2``."""
    d, din, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, ck = cfg.ssm_heads, cfg.ssm_conv
    f32 = torch.float32

    def w(*shape, dtype=dtype):
        return normal_weight(generator, shape, device, dtype)

    def full(n, value):
        return torch.full((n,), value, dtype=f32, device=device)

    wz, wx, wB, wC, wdt = w(d, din), w(d, din), w(d, N), w(d, N), w(d, H)
    conv_x, conv_B, conv_C = (w(ck, din, dtype=f32), w(ck, N, dtype=f32),
                              w(ck, N, dtype=f32))
    return SsmParams(
        wz=wz, wx=wx, wB=wB, wC=wC, wdt=wdt,
        conv_x=conv_x, conv_B=conv_B, conv_C=conv_C,
        conv_bx=full(din, 0.0), conv_bB=full(N, 0.0), conv_bC=full(N, 0.0),
        a_log=torch.log(torch.linspace(1.0, 16.0, H, dtype=f32)).to(device),
        d_skip=full(H, 1.0), dt_bias=full(H, -2.0),
        norm=torch.zeros(din, dtype=dtype, device=device),
        out_proj=w(din, d))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches
    to ``x`` above a threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time: ``u (B, T, C)``, ``w (ck, C)``,
    float32: the ``ck`` shifted products added in order, then the bias,
    then silu (the reference's Python ``sum``)."""
    ck, T = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, ck - 1, 0))
    out = pad[:, 0:T, :] * w[0]
    for i in range(1, ck):
        out = out + pad[:, i:i + T, :] * w[i]
    return F.silu(out + b)


def _clip_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def ssd_forward(p: SsmParams, cfg: ModelConfig, x: torch.Tensor,
                chunk: int = 128,
                initial_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Chunked SSD over a full sequence: ``x (B, T, d)`` -> ``(B, T, d)``
    bf16 (and the final state ``(B, H, P, N)`` float32 with
    ``return_state``).  Chunks of ``Q = chunk`` positions if ``T`` is a
    multiple of ``chunk`` (and at least that), else one chunk of ``T``:
    then the ``(B, 1, T, T, H)`` float32 decay matrix is the largest
    transient.

    Recurrence (per head h, inclusive cumsum ``cum_j = sum_{l<=j} dt_l A_h``):
        S_j = exp(dt_j A) S_{j-1} + dt_j B_j x_j^T
        y_j = C_j . S_j + D x_j
    so  y_j = C_j exp(cum_j) S_prev                       [inter-chunk]
            + sum_{l<=j} exp(cum_j - cum_l) dt_l (C_j.B_l) x_l   [intra]
    """
    if is_dtensor(x):
        from .spmd import ssd_forward_mesh
        if initial_state is not None or return_state:
            raise NotImplementedError("ssd_forward on a mesh takes no "
                                      "initial state and returns none")
        return ssd_forward_mesh(p, cfg, x, chunk)
    y, S = _ssd_core(p, cfg, lambda w: _dot_f32(x, getattr(p, w)), chunk,
                     initial_state)
    out = _dot(rms_norm(y.to(BF16), p.norm, cfg.norm_eps), p.out_proj)
    if return_state:
        return out, S
    return out


def _ssd_core(p: SsmParams, cfg: ModelConfig, proj, chunk: int,
              initial_state: Optional[torch.Tensor]):
    """:func:`ssd_forward` between its input and its gated norm:
    ``proj(name)`` gives the float32 output of the projection by weight
    ``name`` (``wz``, ``wx`` ``(B, T, din)``, ``wB``, ``wC`` ``(B, T,
    N)``, ``wdt`` ``(B, T, H)``, taken in that order);
    then the convolutions, the chunked scan, the skip and the gate ->
    ``(y (B, T, din) float32, S (B, H, P, N))``.  Widths come from the
    projections, so a rank runs it on its own heads
    (``spmd.ssd_forward_mesh``)."""
    z = proj("wz")                                              # (B,T,din)
    xin = _causal_conv(proj("wx"), p.conv_x, p.conv_bx)
    Bm = _causal_conv(proj("wB"), p.conv_B, p.conv_bB)          # (B,T,N)
    Cm = _causal_conv(proj("wC"), p.conv_C, p.conv_bC)
    dt = _softplus(proj("wdt") + p.dt_bias)
    A = -torch.exp(p.a_log.float())                             # (H,)
    B, T, din = xin.shape
    N, H = Bm.shape[-1], dt.shape[-1]
    P = cfg.ssm_head_dim
    Q = chunk if (T % chunk == 0 and T >= chunk) else T
    nc = T // Q
    xh = xin.reshape(B, T, H, P)

    dtc = dt.reshape(B, nc, Q, H)
    cum = torch.cumsum(dtc * A, dim=2)                          # inclusive
    seg_end = cum[:, :, -1]                                     # (B,nc,H)
    Bc = Bm.reshape(B, nc, Q, N)
    Cc = Cm.reshape(B, nc, Q, N)
    xc = xh.reshape(B, nc, Q, H, P)

    # ---- intra-chunk (batched (Q, Q) products) ----
    G = torch.einsum("bciN,bcjN->bcij", Cc, Bc)                 # (B,nc,Q,Q)
    Lmat = _clip_exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xin.device))
    M = G[..., None] * torch.where(tri[None, None, :, :, None], Lmat, 0.0)
    del Lmat
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xc * dtc[..., None])
    del M

    # ---- inter-chunk recurrence ----
    decay_out = _clip_exp(seg_end[:, :, None, :] - cum)
    S_local = torch.einsum("bcjh,bcjhp,bcjn->bchpn", decay_out * dtc, xc, Bc)
    S = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xin.device)
         if initial_state is None else initial_state.float())
    y_inter = []
    for c in range(nc):
        dec = _clip_exp(cum[:, c])                              # (B,Q,H)
        y_inter.append(torch.einsum("bjn,bjh,bhpn->bjhp", Cc[:, c], dec, S))
        S = S * torch.exp(seg_end[:, c])[:, :, None, None] + S_local[:, c]

    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(B, T, H, P)
    y = y + p.d_skip[None, None, :, None] * xh
    return y.reshape(B, T, din) * F.silu(z), S


def init_ssm_state(cfg: ModelConfig, batch: int,
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(ssd_state, conv_x_state, conv_B_state, conv_C_state) zero float32
    states of one layer."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    din, ck = cfg.d_inner, cfg.ssm_conv

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return (zeros(batch, H, P, N), zeros(batch, ck - 1, din),
            zeros(batch, ck - 1, N), zeros(batch, ck - 1, N))


def _conv_step(state: torch.Tensor, u_new: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """One causal-conv step: ``state (B, ck-1, C)``, ``u_new (B, C)`` ->
    (silu output ``(B, C)``, the shifted state)."""
    window = torch.cat([state, u_new[:, None, :]], dim=1)      # (B, ck, C)
    out = (window * w).sum(dim=1) + b
    return F.silu(out), window[:, 1:, :]


def ssd_decode_step(p: SsmParams, cfg: ModelConfig, x: torch.Tensor, state):
    """Exact single-token recurrence: ``x (B, 1, d)`` -> (out ``(B, 1,
    d)`` bf16, the new ``(ssd, conv_x, conv_B, conv_C)`` states)."""
    if is_dtensor(x):
        from .spmd import ssd_decode_step_mesh
        return ssd_decode_step_mesh(p, cfg, x, state)
    y, new = _decode_core(p, cfg, lambda w: _dot_f32(x, getattr(p, w))[:, 0],
                          state)
    out = _dot(rms_norm(y.to(BF16), p.norm, cfg.norm_eps), p.out_proj)
    return out, new


def _decode_core(p: SsmParams, cfg: ModelConfig, proj, state):
    """:func:`ssd_decode_step` between its input and its gated norm:
    ``proj(name)`` as :func:`_ssd_core`'s, one position (``(B, din)``,
    ``(B, N)``, ``(B, H)``) -> ``(y (B, 1, din) float32, new states)``;
    widths from the projections."""
    S, cx, cB, cC = state
    z = proj("wz")                                              # (B, din)
    xin, cx = _conv_step(cx, proj("wx"), p.conv_x, p.conv_bx)
    Bm, cB = _conv_step(cB, proj("wB"), p.conv_B, p.conv_bB)
    Cm, cC = _conv_step(cC, proj("wC"), p.conv_C, p.conv_bC)
    dt = _softplus(proj("wdt") + p.dt_bias)
    A = -torch.exp(p.a_log.float())
    B, din = xin.shape
    H, P = dt.shape[-1], cfg.ssm_head_dim
    xhead = xin.reshape(B, H, P)

    dA = torch.exp(dt * A)                                      # (B, H)
    # the reference's einsums "bh,bhp,bn->bhpn" and "bhpn,bn->bhp" as
    # broadcast products and a batched product (no contraction-path
    # search on every step)
    S_new = (S * dA[:, :, None, None]
             + (dt[:, :, None] * xhead)[..., None] * Bm[:, None, None, :])
    y = torch.matmul(S_new, Cm[:, None, :, None])[..., 0]       # (B, H, P)
    y = y + p.d_skip[None, :, None] * xhead
    return y.reshape(B, 1, din) * F.silu(z)[:, None, :], (S_new, cx, cB, cC)
