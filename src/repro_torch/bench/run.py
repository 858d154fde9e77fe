"""Benchmark entry point of the port (the counterpart of
``benchmarks/run.py``): one leg per paper table or figure that the port
has, the serving loop, the memory accounting and the roofline table.

    PYTHONPATH=src python -m repro_torch.bench.run [--full | --smoke] \\
        [--only NAME] [--device cuda|cpu]

As in the reference, the quick sizes are the default, ``--full`` the
paper's and ``--smoke`` the quick sizes with the serving loop at its
smoke size.  ``--device`` (the card unless ``cpu``) takes the place of
the reference's ``tpu|gpu``; every leg writes
``<out>/hw_<cuda|cpu>_<suite>.json`` through ``bench/_writer.py`` and
never a ``BENCH_*.json``.  ``roofline`` reads the records that
``python -m repro_torch.launch.dryrun --all`` wrote.  ``--measure`` is
checked against the measure registry; none of the ported suites is
measure-aware (the reference's ``lb_cascade``, ``ivf`` and ``index``
suites are not ported yet).
"""

from __future__ import annotations

import argparse
import time

from . import (fig5a_scaling, fig5b_params, fig5c_prealign, memory_cost,
               roofline, serving_qps, table1_accuracy)
from ._writer import device_args

__all__ = ["SUITES", "main"]


def _serving(quick: bool, smoke: bool, device, out_dir):
    size = "smoke" if smoke else "quick" if quick else "full"
    return serving_qps.run(size, device, out_dir)


SUITES = {
    "fig5a": lambda q, s, d, o: fig5a_scaling.run(q, d, o),
    "fig5b": lambda q, s, d, o: fig5b_params.run(q, d, o),
    "fig5c": lambda q, s, d, o: fig5c_prealign.run(q, d, o),
    "table1": lambda q, s, d, o: table1_accuracy.run(q, d, out_dir=o),
    "memory": lambda q, s, d, o: memory_cost.run(q, d, o),
    "serving": _serving,
    "roofline": lambda q, s, d, o: roofline.run(q, d, o),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="paper-scale sizes")
    ap.add_argument("--smoke", action="store_true",
                    help="quick sizes, the serving loop at its smoke size")
    ap.add_argument("--only", choices=tuple(SUITES), default=None)
    ap.add_argument("--measure", default=None,
                    help="an elastic measure, checked against the "
                         "registry (no ported suite is measure-aware)")
    device_args(ap)
    args = ap.parse_args(argv)
    if args.smoke and args.full:
        ap.error("--smoke and --full are mutually exclusive")
    if args.measure:
        from ..core import measures
        measures.resolve(args.measure)
    names = (args.only,) if args.only else tuple(SUITES)
    for name in names:
        print(f"== {name} ==", flush=True)
        t0 = time.time()
        SUITES[name](not args.full, args.smoke, args.device, args.out)
        print(f"== {name} done in {time.time() - t0:.1f}s ==\n", flush=True)


if __name__ == "__main__":
    main()
