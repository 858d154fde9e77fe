"""Paper §3.4's memory cost on the port (the torch leg of
``benchmarks/memory_cost.py``): the compression factor of PQ codes
against raw series with the auxiliary structures (codebook, LUT,
envelopes), the paper's worked example (D=140, K=256, M=7: 80x) among
them, and the same accounting on the full configs' KV caches (PQ-KV).

    PYTHONPATH=src python -m repro_torch.bench.memory_cost [--device cpu]

Pure arithmetic: the rows are the reference suite's, number for number;
the device only names the record (``hw_<cuda|cpu>_memory_cost.json``).
"""

from __future__ import annotations

import argparse

from .. import _device
from ..configs.registry import get_config
from ..core.pq import PQConfig, memory_cost
from ..serve.pqkv import PQKVConfig, pqkv_memory
from ._writer import OUT_DIR, Bench, device_args

__all__ = ["run", "main"]


def run(quick: bool = True, device: _device.DeviceArg = None,
        out_dir: str = OUT_DIR) -> Bench:
    del quick
    b = Bench("memory_cost", device, out_dir)
    cfg = PQConfig(n_sub=7, codebook_size=256, use_prealign=False)
    m = memory_cost(cfg, D=140, n_series=10_000)
    b.add(case="paper_example_D140_M7_K256",
          compression=m["compression"],
          aux_mb=m["aux_bytes"] / 1e6,
          code_bytes_per_series=m["code_bytes"] / 10_000)
    for D, M, K in ((256, 8, 256), (512, 8, 256), (1024, 16, 256),
                    (4096, 32, 256)):
        cfg = PQConfig(n_sub=M, codebook_size=K, use_prealign=False)
        m = memory_cost(cfg, D=D, n_series=100_000)
        b.add(case=f"D{D}_M{M}_K{K}", compression=m["compression"],
              aux_mb=m["aux_bytes"] / 1e6,
              code_bytes_per_series=m["code_bytes"] / 100_000)
    for arch, B, S in (("qwen2-72b", 128, 32768),
                       ("gemma2-27b", 128, 32768),
                       ("internlm2-1.8b", 128, 32768)):
        mc = get_config(arch)
        for qv in (False, True):
            pq = PQKVConfig(n_sub=8, codebook_size=256, recent_window=128,
                            quantize_v=qv)
            m = pqkv_memory(mc, pq, batch=B, seq_len=S)
            b.add(case=f"pqkv_{arch}{'_qv' if qv else ''}",
                  compression=m["compression"],
                  exact_gb=m["exact_bytes"] / 1e9,
                  pq_gb=m["pq_bytes"] / 1e9)
    b.save()
    return b


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    device_args(ap)
    args = ap.parse_args(argv)
    run(device=args.device, out_dir=args.out)


if __name__ == "__main__":
    main()
