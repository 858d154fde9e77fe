"""Where one training step's time goes on the card: ``make_train_step``
(the launcher's settings) on an architecture at full width, a few steps
to warm up, then one step under ``torch.profiler``: its wall ms, the
device's busy ms (kernel durations summed; one stream, so they do not
overlap), the idle share, the kernel count, the busy ms by kernel class
(bf16 and float32 GEMMs, elementwise, reductions, the rest) and the
kernels with the most device time.

    python src/repro_torch/bench/train_profile.py --arch internlm2-1.8b \\
        --batch 8 --seq 1024 [--layers N] [--out results.jsonl]

Each run prints one JSON line with the card's ``nvidia-smi`` name and
power limit.  It runs on the card only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.bench._writer import nvidia_smi_line
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.train import step_batch
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step

# seconds of idle profiler window on each side of the step: the profiler
# drops kernels whose converted timestamps fall outside its window
PAD_S = 0.05
# steps before the profiled one (the first builds cuBLAS plans and the
# allocator's pools)
WARMUP_STEPS = 2


def kernel_class(name: str) -> str:
    """A coarse class of a CUDA kernel by its name.  cuBLAS's Hopper
    tensor-core GEMMs are ``nvjet_*``; with TF32 off (the port's setting)
    only the bf16 products take the tensor cores, and the float32 ones
    run ``*sgemm*`` / ``*gemm_f32f32*`` kernels on the FMA units."""
    n = name.lower()
    if "nvjet" in n:
        return "gemm_bf16"
    if "gemm" in n or "cutlass" in n or "xmma" in n:
        return "gemm_bf16" if ("bf16" in n or "f16" in n) else "gemm_f32"
    if "reduce" in n or "softmax" in n or "norm" in n:
        return "reduction"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    if "index" in n or "scatter" in n or "gather" in n or "sort" in n:
        return "index"
    if "copy" in n or "memcpy" in n or "memset" in n or "fill" in n:
        return "copy"
    return "other"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: all)")
    ap.add_argument("--out", default=None,
                    help="append the JSON line to this file too")
    args = ap.parse_args(argv)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(None)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    steps = WARMUP_STEPS + 1
    step = make_train_step(cfg, AdamWConfig(
        total_steps=max(steps, 2), warmup_steps=max(2, steps // 10)),
        q_chunk=min(512, args.seq))
    state = init_train_state(torch.Generator(device=dev).manual_seed(0),
                             cfg, dev)
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch)
    for s in range(WARMUP_STEPS):
        state, m = step(state, step_batch(stream, cfg, s, args.batch, dev))
        float(m["loss"])
    batch = step_batch(stream, cfg, WARMUP_STEPS, args.batch, dev)
    # repro: ignore[RS101] the profiled window starts with an idle card
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        start = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        wall_ms = (time.perf_counter() - start) * 1e3
        time.sleep(PAD_S)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    classes = {}
    for name, (ms, n) in by_name.items():
        c = classes.setdefault(kernel_class(name), {"ms": 0.0, "kernels": 0})
        c["ms"] += ms
        c["kernels"] += n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "batch": args.batch,
           "seq": args.seq, "loss": loss, "wall_ms": wall_ms,
           "device_busy_ms": busy,
           "idle_share": 1.0 - busy / wall_ms if by_name else None,
           "kernels": sum(n for _, n in by_name.values()),
           "by_class": classes,
           "top": [{"name": k[:90], "ms": ms, "count": n}
                   for k, (ms, n) in top],
           "nvidia_smi": nvidia_smi_line(), "torch": torch.__version__}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
