"""End-to-end training example of the port (the port of
``examples/train_lm.py``): a reduced architecture trained for a few
hundred steps with checkpoint and restart through the port's launcher.

    python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]

Exercises the deterministic token stream, gradient accumulation over
microbatches, AdamW with its cosine schedule, asynchronous checkpoints
and a preemption half-way: phase 1 trains to ``steps // 2`` and stops,
phase 2 restarts from its last checkpoint and trains to ``steps``.  The
loss must fall (last logged step below the first).
"""

import argparse
import json
import os
import shutil
import tempfile

from repro_torch._device import resolve_device
from repro_torch.launch.train import main as train_main


def main(argv=None):
    """Train both phases; returns the logged records (``step``, ``loss``,
    ``ce``, ``sec``) of both, in order."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm_ck"),
        help="checkpoints and metrics.jsonl (emptied first)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ckpt_dir = args.ckpt_dir
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    metrics = os.path.join(ckpt_dir, "metrics.jsonl")
    os.makedirs(ckpt_dir, exist_ok=True)

    half = args.steps // 2
    common = ["--arch", args.arch, "--reduced", "--batch", "8",
              "--seq", "128", "--microbatches", "2",
              "--ckpt-dir", ckpt_dir, "--ckpt-every", "25",
              "--metrics-out", metrics, "--device", str(dev)]

    print(f"=== phase 1: steps 0..{half} (then 'preempted') ===")
    train_main(common + ["--steps", str(half)])

    print(f"\n=== phase 2: restart from checkpoint, steps {half}.."
          f"{args.steps} ===")
    train_main(common + ["--steps", str(args.steps)])

    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    first, last = rows[0]["loss"], rows[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {len(rows)} logged steps "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    assert last < first, "training did not reduce the loss"
    return rows


if __name__ == "__main__":
    main()
