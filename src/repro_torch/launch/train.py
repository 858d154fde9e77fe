"""Training launcher (counterpart of :mod:`repro.launch.train`).

Fault-tolerance contract, as the reference's:

  * checkpoint/restart: atomic step directories (write tmp + rename),
    keep-K GC, an async writer thread off the step path; on start the
    latest valid checkpoint is restored and the data stream is
    fast-forwarded (each batch is a pure function of the step index, so a
    restart is bit-deterministic);
  * preemption safety: SIGTERM/SIGINT checkpoint after the current step
    and exit;
  * straggler watchdog: a monitor thread flags steps exceeding
    ``--watchdog`` seconds (logs, and with ``--watchdog-abort`` sends
    SIGTERM to the process).

``--production-mesh`` trains on the 16 x 16 mesh (``--multi-pod``: 2 x 16
x 16), one rank a device under ``torchrun`` (``env://``): the state is laid
out by the partition rules (FSDP + TP), each step's batch over the DP
axes, the step runs inside the activation constraints, and checkpoints
are stored whole, restoring under any mesh.  Any other world size raises,
naming the ranks needed.  Without the flag the host mesh (1 x 1) is the
one card: no process group, no ``DTensor``.  The training state is
float32 masters and moments (12 bytes a parameter, 16 with the step's
float32 gradients).  Each step prints, and appends to
``--metrics-out``, one JSON record: ``step``, ``loss``, ``ce``, ``sec``.

Usage (CPU example scale; without ``--device`` it runs on the card and
raises if there is none):
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --reduced --device cpu --steps 30 --batch 8 --seq 128 \\
        --ckpt-dir /tmp/ck --ckpt-every 10
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.configs.registry import ARCH_IDS, get_config, get_reduced
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.cells import mesh_context, state_specs
from repro_torch.launch.mesh import (launch_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.sharding.partition import batch_specs, distribute
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step


class Watchdog:
    """Flags steps that exceed a wall-clock budget (straggler mitigation)."""

    def __init__(self, timeout_s: float, abort: bool = False):
        self.timeout = timeout_s
        self.abort = abort
        self._last_beat = time.monotonic()
        self._step = -1
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.stragglers = 0

    def beat(self, step: int):
        self._last_beat = time.monotonic()
        self._step = step

    def _run(self):
        while not self._stop.wait(min(self.timeout / 4, 5.0)):
            lag = time.monotonic() - self._last_beat
            if lag > self.timeout:
                self.stragglers += 1
                print(f"[watchdog] step {self._step + 1} exceeded "
                      f"{self.timeout:.0f}s (lag {lag:.0f}s) — straggler",
                      file=sys.stderr, flush=True)
                if self.abort:
                    os.kill(os.getpid(), signal.SIGTERM)
                self._last_beat = time.monotonic()

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)


def step_batch_keys(cfg) -> tuple:
    """The leaves of a step's batch (:func:`step_batch`)."""
    extra = {"encdec": ("frames",), "vlm": ("patches",)}.get(cfg.family, ())
    return ("tokens", "labels") + extra


def step_batch(stream: TokenStream, cfg, step: int, batch: int, dev):
    """The step's batch on ``dev``: the stream's tokens and labels, and the
    encdec frames or vlm patches the reference's launcher draws from
    ``np.random.default_rng(step)``."""
    out = stream.batch_at(step)
    extra = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
    if extra:
        out[extra] = np.random.default_rng(step).standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def main(argv=None):
    """Train; returns the final ``TrainState`` (on the run's device)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU/example scale)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--keep-last", type=int, default=3)
    ap.add_argument("--watchdog", type=float, default=0.0,
                    help="straggler threshold in seconds (0 = off)")
    ap.add_argument("--watchdog-abort", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (256 ranks under torchrun)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production-mesh: 2x16x16 (512 ranks)")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    desc = (make_production_mesh(multi_pod=args.multi_pod)
            if args.production_mesh else make_host_mesh())
    dev = resolve_device(args.device)
    mesh = launch_mesh(desc, dev)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    print(f"[train] arch={cfg.name} params={cfg.param_count():,} "
          f"mesh={desc.shape} device={dev}", flush=True)

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=max(args.steps, 2),
                          warmup_steps=max(2, args.steps // 10))
    mb_constraint = None
    if mesh is not None and args.microbatches > 1:
        rows = args.batch // args.microbatches
        mb_constraint = batch_specs(
            {k: torch.empty((rows, 1), device="meta")
             for k in step_batch_keys(cfg)}, mesh)
    train_step = make_train_step(cfg, opt_cfg, q_chunk=min(512, args.seq),
                                 microbatches=args.microbatches,
                                 mb_constraint=mb_constraint)
    state = init_train_state(torch.Generator(device=dev).manual_seed(
        args.seed), cfg, dev)
    specs = None
    if mesh is not None:
        specs = state_specs(state, mesh)
        state = distribute(state, specs, mesh)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir, keep_last=args.keep_last)
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore(args.ckpt_dir, last, state, mesh=mesh,
                            specs=specs)
            start_step = last
            print(f"[train] restored step {last} from {args.ckpt_dir}",
                  flush=True)

    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch=args.batch, seed=args.seed)
    dog = (Watchdog(args.watchdog, args.watchdog_abort).start()
           if args.watchdog else None)
    stop_requested = {"flag": False}

    def _graceful(signum, frame):                     # noqa: ARG001
        stop_requested["flag"] = True
        print(f"[train] signal {signum}: checkpoint + exit after this "
              "step", flush=True)

    old_handlers = [(s, signal.signal(s, _graceful))
                    for s in (signal.SIGTERM, signal.SIGINT)]
    metrics_f = open(args.metrics_out, "a") if args.metrics_out else None
    t_start = time.time()
    step = start_step
    try:
        for step in range(start_step, args.steps):
            if dog:
                dog.beat(step)
            batch = step_batch(stream, cfg, step, args.batch, dev)
            if mesh is not None:
                batch = distribute(batch, batch_specs(batch, mesh), mesh)
            t0 = time.perf_counter()
            with mesh_context(mesh):
                state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])            # waits for the step
            dt = time.perf_counter() - t0
            rec = {"step": step + 1, "loss": round(loss, 4),
                   "ce": round(float(metrics["ce"]), 4),
                   "sec": round(dt, 3)}
            print(f"[train] {json.dumps(rec)}", flush=True)
            if metrics_f:
                metrics_f.write(json.dumps(rec) + "\n")
                metrics_f.flush()
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step + 1}")
            done = step + 1
            if ckpt and (done % args.ckpt_every == 0
                         or done == args.steps or stop_requested["flag"]):
                ckpt.submit(done, state)
            if stop_requested["flag"]:
                break
    finally:
        if dog:
            dog.stop()
        if ckpt:
            ckpt.close()
        if metrics_f:
            metrics_f.close()
        for s, h in old_handlers:
            signal.signal(s, h)
    wall = time.time() - t_start
    print(f"[train] finished at step {step + 1} in {wall:.1f}s"
          + (" (preempted)" if stop_requested["flag"] else ""), flush=True)
    return state


if __name__ == "__main__":
    main()
