"""End-to-end serving example of the port (the port of
``examples/serve_pqkv.py``): batched requests against a small LM with a
PQ-compressed KV cache, the paper's compression idea inside the serving
stack.

    python -m repro_torch.examples.serve_pqkv [--device cpu]

Drives the port's launcher (:mod:`repro_torch.launch.serve`) with the
reference example's arguments: reduced internlm2-1.8b, 4 prompts of 32
tokens, 12 greedy steps with the exact cache and with a PQ-KV cache (M=4,
K=16, an exact ring of 8), and the memory report.  On the card the PQ
steps run the ``pq_attn`` kernel over the coded tail.
"""

import argparse

from repro_torch._device import resolve_device
from repro_torch.launch.serve import main as serve_main

ARGS = ("--arch", "internlm2-1.8b", "--reduced", "--batch", "4",
        "--prompt-len", "32", "--gen", "12", "--pqkv", "--pq-sub", "4",
        "--pq-k", "16", "--pq-window", "8")


def main(argv=None):
    """Serve; returns the launcher's ``{"tokens", "pq_tokens"}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return serve_main(list(ARGS) + ["--device", str(dev)])


if __name__ == "__main__":
    main()
