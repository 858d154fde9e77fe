"""The lower-precision control of a cell, at the cell's own size, on the
CUDA device: the plain reference computed in bfloat16 (the nearest
precision below the configuration's float32) put in the program's
place, and the numbers that decide ``correct`` read off its answers.
Each seed prints one JSON line; the control has to fail the cell's
limits on every seed.  It makes the cell's inputs from each seed as a
run does and needs no program.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

from portbench.harness import prepare_env  # noqa: E402
from portbench.manifest import load_cell, load_manifest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    prepare_env()
    import torch
    manifest = load_manifest()
    cell = load_cell(args.workload, manifest)
    mod = importlib.import_module(
        f"portbench.entries.{cell.traffic['entry']}")
    limits = cell.workload["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        entry = mod.Cell(cell.config, cell.traffic, seed, "cuda")
        entry.make_inputs()
        numbers = entry.check(entry.control_answers(torch.bfloat16))
        print(json.dumps({
            "workload": cell.name, "seed": seed, "dtype": "bfloat16",
            "numbers": numbers, "limits": limits,
            "fails": any(numbers[k] > limits[k] for k in limits),
            "seconds": time.perf_counter() - t}), flush=True)
        del entry
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
