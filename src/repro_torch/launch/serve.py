"""Serving launcher (counterpart of :mod:`repro.launch.serve`): prefill +
greedy decode, with an optional PQ-KV cache.

After the prompt is prefilled into an exact KV cache, ``--pqkv``
compresses a copy of it with product quantization (codebooks fit on the
observed keys), reports the memory ratio (paper §3.4 applied to the
cache) and generates beside the exact decode with ADC-approximated
attention plus an exact recent window, then reports how often the two
greedy outputs agree; ``--pq-quantize-v`` codes the values too.  The
dense (gemma2's local/global layers included), moe and vlm families
(text only, as the reference's launcher) prefill in one batched pass.
The ssm, hybrid and encdec families prefill one token at a time through
``serve_step``, as the reference's launcher does; encdec first encodes
``(B, n_frontend_tokens, d)`` random frames into its cross-attention
cache (``prefill_cache_encdec``).  ``--pqkv`` raises for these three,
naming the family.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \\
        --reduced --device cpu --pqkv

Without ``--device`` it runs on the card (and raises if there is none).
A ``--reduced`` config draws its weights, prompts and codebook samples
from a CPU generator, so that one ``--seed`` serves the same model on the
card and on the CPU; a full config draws them on its device.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.configs.registry import ARCH_IDS, get_config, get_reduced
from repro_torch.models.encdec import init_params_encdec
from repro_torch.models.lm import KV_FAMILIES, check_kv_family, init_params
from repro_torch.serve.cache import init_cache
from repro_torch.serve.decode import prefill_cache_encdec, serve_step
from repro_torch.serve.pqkv import (PQKVConfig, compress_cache,
                                    pq_serve_step, pqkv_memory)
from repro_torch.serve.prefill import prefill


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]


def margin(logits: torch.Tensor) -> torch.Tensor:
    """``(B, 1)``: the last position's largest logit less the second (how
    near the greedy pick is to a tie)."""
    top = torch.topk(logits[:, -1, :].float(), 2, dim=-1).values
    return (top[:, 0] - top[:, 1])[:, None]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def random_prompt(cfg, batch: int, length: int,
                  gen: torch.Generator) -> torch.Tensor:
    """``(batch, length)`` int32 token ids drawn from ``gen`` on its
    device."""
    return torch.randint(0, cfg.vocab_size, (batch, length), generator=gen,
                         device=gen.device, dtype=torch.int32)


def main(argv=None):
    """Serve one batch (module docstring); returns, on the host,
    ``{"tokens": (B, gen)`` exact greedy ids, ``"pq_tokens"``: the PQ-KV
    decode's (or None), ``"margins"``, ``"pq_margins"``: each step's
    top-2 logit gap (:func:`margin`)``}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pqkv", action="store_true",
                    help="compress the cache with PQ after prefill")
    ap.add_argument("--pq-sub", type=int, default=4)
    ap.add_argument("--pq-k", type=int, default=16)
    ap.add_argument("--pq-window", type=int, default=16)
    ap.add_argument("--pq-quantize-v", action="store_true",
                    help="PQ-code the values too")
    ap.add_argument("--production-mesh", action="store_true",
                    help="not ported (one card): raises")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise NotImplementedError("--production-mesh: the port runs on one "
                                  "card; no mesh is ported")
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    max_len = args.max_len or (args.prompt_len + args.gen)
    print(f"[serve] arch={cfg.name} family={cfg.family} "
          f"B={args.batch} prompt={args.prompt_len} gen={args.gen} "
          f"device={dev}")
    pqc = None
    if args.pqkv:
        check_kv_family(cfg, "--pqkv")
        pqc = PQKVConfig(n_sub=args.pq_sub, codebook_size=args.pq_k,
                         recent_window=args.pq_window,
                         quantize_v=args.pq_quantize_v)

    # a reduced config draws everything on the CPU, so one seed serves the
    # same model, prompts and codebooks on the card and on the CPU; a full
    # one draws on the device (billions of weights)
    gen = torch.Generator(device="cpu" if args.reduced else dev
                          ).manual_seed(args.seed)
    init = init_params_encdec if cfg.family == "encdec" else init_params
    params = init(cfg, gen, device=dev)
    cache = init_cache(cfg, args.batch, max_len, device=dev)
    prompt = random_prompt(cfg, args.batch, args.prompt_len, gen).to(dev)
    if cfg.family == "encdec":
        frames = torch.randn((args.batch, cfg.n_frontend_tokens,
                              cfg.d_model), generator=gen,
                             device=gen.device).to(dev)
        cache = prefill_cache_encdec(params, cfg, cache, frames)

    # ---- prefill: one batched cache-filling pass where supported ----
    t0 = time.perf_counter()
    with obs.span("serve.prefill") as sp:
        if cfg.family in KV_FAMILIES:
            logits, cache = prefill(params, cfg, cache, {"tokens": prompt})
        else:   # ssm / hybrid / encdec decoders prefill token by token
            for p in range(args.prompt_len):
                logits, cache = serve_step(params, cfg, cache,
                                           prompt[:, p:p + 1], p)
        sp.fence(logits)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    print(f"[serve] prefill {args.prompt_len} tokens in {t_prefill:.2f}s")

    # ---- optional PQ compression of the populated cache ----
    if pqc is not None:
        mem = pqkv_memory(cfg, pqc, args.batch, max_len)
        # copy: the exact cache goes on decoding in place, and the PQ
        # cache's values would otherwise be the same tensor
        pq_cache = compress_cache(
            {"k": cache["k"], "v": cache["v"].clone()}, cfg, pqc,
            pos=args.prompt_len, generator=gen)
        print(f"[serve] PQ-KV: exact {mem['exact_bytes']/1e6:.2f}MB -> "
              f"{mem['pq_bytes']/1e6:.2f}MB "
              f"({mem['compression']:.2f}x compression)")

    # ---- decode ----
    tok = greedy(logits)
    out_exact, out_pq = [tok], [tok]
    gap_exact, gap_pq = [margin(logits)], [margin(logits)]
    pq_tok = tok
    t0 = time.perf_counter()
    for g in range(args.gen - 1):
        pos = args.prompt_len + g
        # per-step span: with obs enabled the fence syncs each step so
        # p50/p99 step latency is real; disabled, the card runs ahead
        with obs.span("serve.decode_step") as sp:
            logits, cache = serve_step(params, cfg, cache, tok, pos)
            tok = greedy(logits)
            sp.fence(tok)
        out_exact.append(tok)
        gap_exact.append(margin(logits))
        if pqc is not None:
            pq_logits, pq_cache = pq_serve_step(params, cfg, pq_cache,
                                                pq_tok, pos, pqc=pqc)
            pq_tok = greedy(pq_logits)
            out_pq.append(pq_tok)
            gap_pq.append(margin(pq_logits))
    _sync(dev)
    t_dec = time.perf_counter() - t0
    toks = torch.cat(out_exact, dim=1).cpu()
    rate = args.batch * (args.gen - 1) / max(t_dec, 1e-9)
    print(f"[serve] decoded {args.gen - 1} steps x {args.batch} seqs in "
          f"{t_dec:.2f}s ({rate:.1f} tok/s)")
    if obs.enabled() and args.gen > 1:
        h = obs.histogram("stage_seconds", persistent=True,
                          stage="serve.decode_step")
        print(f"[serve] decode step p50/p99: "
              f"{h.percentile(50) * 1e3:.1f}ms / "
              f"{h.percentile(99) * 1e3:.1f}ms over {h.count} steps")
    print(f"[serve] sample output ids: {toks[0][:12].tolist()}")
    pq_toks = pq_gaps = None
    if pqc is not None:
        pq_toks = torch.cat(out_pq, dim=1).cpu()
        pq_gaps = torch.cat(gap_pq, dim=1).cpu()
        agree = float((pq_toks == toks).float().mean())
        print(f"[serve] PQ-KV greedy agreement with exact decode: "
              f"{agree:.1%}")
    return {"tokens": toks, "pq_tokens": pq_toks,
            "margins": torch.cat(gap_exact, dim=1).cpu(),
            "pq_margins": pq_gaps}


if __name__ == "__main__":
    main()
