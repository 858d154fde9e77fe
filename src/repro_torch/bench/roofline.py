"""The per-cell roofline table of the port (the torch leg of
``benchmarks/roofline.py``): the dry-run records of
:mod:`repro_torch.launch.dryrun` aggregated into rows (compute / memory /
collective terms, the bound, the useful-FLOP ratio, the peak) and a
markdown table, with the FLOPs split by operand type and, where a cell
took a real step on the card, its seconds and ``max_memory_allocated``.
The memory term is the fused floor's (arguments read once, what the
step writes written once); the eager step's own traffic stands beside
it (``memory_eager_s``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.bench.roofline [--device cpu]

Reads ``--records`` (default: the dry run's own directory); writes
``hw_<cuda|cpu>_roofline.json`` and ``roofline_table.md`` into ``--out``.
The terms come from the H100's rates, whichever device names the record.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

from .. import _device
from ..configs.registry import ARCH_IDS, SHAPES
from ..launch.dryrun import DRYRUN_DIR
from ._writer import OUT_DIR, Bench, device_args

__all__ = ["load_records", "markdown_table", "run", "main"]

_GIB = 2 ** 30


def load_records(records_dir: str = DRYRUN_DIR, tag: str = "") -> List[dict]:
    """The counted one-card records with ``tag``, in the registry's arch
    and shape order."""
    recs = []
    for path in glob.glob(os.path.join(records_dir, "*.json")):
        with open(path) as f:
            r = json.load(f)
        if r.get("mesh") == "single" and r.get("tag", "") == tag \
                and r.get("ok"):
            recs.append(r)
    shapes = tuple(SHAPES)
    recs.sort(key=lambda r: (ARCH_IDS.index(r["arch"]),
                             shapes.index(r["shape"])))
    return recs


def _run_cells(r: dict) -> tuple:
    run = r.get("run") or {}
    if "seconds" not in run:
        return "", ""
    return (f"{run['max_memory_allocated'] / _GIB:.2f} / "
            f"{run['meta_peak_bytes'] / _GIB:.2f}", f"{run['seconds']:.4g}")


def markdown_table(recs: List[dict]) -> str:
    lines = [
        "| arch | shape | fit | peak GiB (meta) | real / meta GiB | step s "
        "| bf16 TFLOP | f32 TFLOP | compute s | memory s (floor) "
        "| memory s (eager) | bound | useful/counted | roofline frac |",
        "|---|---|---|---:|---:|---:|---:|---:|---:|---:|---:|---|---:|---:|",
    ]
    for r in recs:
        ro, m = r["roofline"], r["memory"]
        real, secs = _run_cells(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {'yes' if r['fit'] else 'no'} "
            f"| {m['peak_bytes'] / _GIB:.2f} | {real} | {secs} "
            f"| {ro['flops_bf16'] / 1e12:.4g} | {ro['flops_f32'] / 1e12:.4g} "
            f"| {ro['compute_s']:.4g} | {ro['memory_s']:.4g} "
            f"| {ro['memory_eager_s']:.4g} | {ro['bound']} "
            f"| {ro['useful_ratio']:.3f} | {ro['roofline_frac']:.3f} |")
    return "\n".join(lines)


def run(quick: bool = True, device: _device.DeviceArg = None,
        out_dir: str = OUT_DIR, records_dir: str = DRYRUN_DIR) -> Bench:
    del quick
    b = Bench("roofline", device, out_dir)
    recs = load_records(records_dir)
    for r in recs:
        ro = r["roofline"]
        run_rec = r.get("run") or {}
        b.add(mesh="single", arch=r["arch"], shape=r["shape"],
              fit=r["fit"], bound=ro["bound"],
              compute_s=round(ro["compute_s"], 5),
              memory_s=round(ro["memory_s"], 5),
              memory_eager_s=round(ro["memory_eager_s"], 5),
              collective_s=round(ro["collective_s"], 5),
              peak_gb=round(r["memory"]["peak_bytes"] / 1e9, 2),
              flops_bf16=ro["flops_bf16"], flops_f32=ro["flops_f32"],
              useful_ratio=round(ro["useful_ratio"], 4),
              roofline_frac=round(ro["roofline_frac"], 4),
              step_s=run_rec.get("seconds"),
              max_memory_allocated=run_rec.get("max_memory_allocated"))
    b.save(headline={"records": len(recs)})
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "roofline_table.md"), "w") as f:
        if recs:
            f.write("### one card (H100 rates)\n\n")
            f.write(markdown_table(recs))
            f.write("\n")
    return b


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    device_args(ap)
    ap.add_argument("--records", default=DRYRUN_DIR,
                    help="directory of the dry-run records")
    args = ap.parse_args(argv)
    run(device=args.device, out_dir=args.out, records_dir=args.records)


if __name__ == "__main__":
    main()
