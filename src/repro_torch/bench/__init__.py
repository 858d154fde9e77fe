"""Torch legs of the paper's benchmarks (counterparts of ``benchmarks/``):
Table 1 and Fig. 5a/b/c, run as ``python -m repro_torch.bench.<suite>``.

Each leg writes ``experiments/bench/hw_cuda_<suite>.json`` (or
``hw_cpu_<suite>.json`` under ``--device cpu``) through
:mod:`._writer`, with the card's ``nvidia-smi`` name and power limit
beside its rows; the repo-root ``BENCH_*.json`` summaries are the JAX
package's and are never written here.
"""
