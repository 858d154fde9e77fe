#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, drives
the paper's main path once through the user-facing entry points at a
FordA-scale collection (UCR FordA is 3601 x 500; here 6144 x 512 training
series and 768 queries with the default ``PQConfig``: M=8, K=256, S=74,
window 7), then the search paths beyond 1-NN on the same data:

- ``pruned_nn``: the exact LB-cascade 1-NN (``knn.nn_dtw_pruned``) of 128
  queries at window 51, whose predictions must equal ``nn_dtw_exact``'s;
- ``index_path``: a streaming IVF-PQDTW index (``IndexConfig(PQConfig(),
  n_lists=64, hot_capacity=2560)``) bootstrapped on the 6144 series, all of
  them inserted (2 sealed segments, 1024 rows hot), 5% deleted, the 768
  queries searched (``n_probe=8, topk=10``); the hot part must equal a
  dense scan, the compacted index ``ivf.search_batch`` over the live rows,
  and a snapshot must restore bit for bit;
- ``serving_path``: the serving core (``IndexServer``,
  ``ServeConfig(n_probe=8, topk=10)``, buckets 1-64) over a new index on
  the index path's quantizers holding the 6144 series: the warm-replay
  gate (``bench/warm_replay.py``: no build, the same launches per request
  size, no allocator growth), then 4 client threads sending 1-64 of the
  768 queries while a producer inserts 1536 more CBF series (one seal),
  deletes 5% of the ids, flushes and compacts through the server; every
  batch searched again on the view it reports equals its result bit for
  bit, each request's rows alone give the same ids and distances within
  1e-6, no deleted id comes back once its delete resolved, an insert is
  visible once it resolves; QPS, p50/p99 latency, the batches per bucket
  and the snapshot swaps printed; then ``search_sharded``'s ``"queries"``
  and ``"lists"`` plans for 1 and 4 devices against
  ``StreamingIndex.search`` (ids equal up to the order of exact ties);
- ``adaptive_path``: the same index state with ``band="adaptive"`` (the
  index path's quantizers, inserts and deletes), the 768 queries searched
  through ``StreamingIndex.search`` so that the hot scan refines inside
  per-pair corridors (width 32 at L=512, w=51); every refined pair is at
  or above its static cost; ``elastic_pairwise(band="adaptive")`` and
  ``certify_adaptive`` (the certified share printed, and how many
  certified pairs equal the static cost)
  on the 7680 pairs of each query and its static top 10, and the same
  sweep under wdtw, erp and msm in those corridors (at or above their
  static cost); recall@10 against the static search;
- ``quant_path``: ``pq.cdist_sym`` and ``dispatch.adc_lookup`` of the 768
  query codes / tables against the 6144 training codes with int8 and
  bfloat16 tables, each within 2% of the float32 maximum, with their 1-NN
  accuracy and agreement with float32;
- ``full_baseline``: the full-width DTW sweep (``dtw_band(mode="full")``,
  the reference's benchmark baseline, one warp a pair up to L = 1024) on
  the adaptive path's 7680 pairs, equal to the band-compressed sweep bit
  for bit;
- ``table1_path``: the paper's Table 1 through its torch leg
  (``repro_torch.bench.table1_accuracy``) at the reference benchmark's
  full grid (CBF, Trace and GunPoint surrogates, 40 series a class, L =
  192, seeds 0-4: PQDTW, PQ_ED, ED, full DTW, cDTW5/10, SBD, SAX); its
  rows, seconds and launches printed; for CBF seed 0 the card's LUTs and
  envelopes equal their rebuild on the CPU from the card's centroids, the
  CPU route on the card's codebooks gives the same codes, row 2's
  matrices (full DTW at w = 191, the band row in shared memory) and
  symmetric PQ matrices bit for bit, ED, SBD and the refined clustering
  distance within tolerance, and the same errors and Rand indices, and
  the CPU route's own fit from the same initial centroids gives centroids
  within tolerance and the same codes, errors and Rand indices; the
  card's float32 ``sqrt`` is correctly rounded; PQDTW's 1-NN error on CBF
  below 0.5;
- ``fig5_path``: the Fig. 5a / 5b / 5c legs at the reference's quick
  sizes (5a's DTW matrices on row 2, the PQ matrices on row 3, 5c's fused
  encode on row 5), rows and launches printed; every row's codes, DTW and
  PQ matrices equal the plain route's on the same inputs bit for bit;
- ``lm_path``: PQ-KV decode serving of internlm2-1.8b at full width (24
  layers, d_model 2048, vocab 92544) from seeded random weights: batched
  prefill of 8 prompts of 2048 random tokens, 31 exact greedy decode
  steps, ``compress_cache`` at position 2048 with ``PQKVConfig()`` (M=8,
  K=256, W=128), and the same 31 steps with the PQ cache, whose attention
  runs the ``pq_attn`` kernel over the coded tail in every layer of every
  step (24 x 31 launches).  On the first PQ step every layer's kernel
  route is held against its plain route; the exact decode's first step
  against ``forward`` over the prompt and its token; and on the reduced
  config the card against the CPU route (prefill, exact and PQ decode).
  One more step of each decode runs under ``torch.profiler`` (device
  busy time, idle share, top kernels);
- ``lm_local_global_path``, ``lm_moe_path``, ``lm_vlm_path``
  (``LM_FAMILY_PATHS``): the same serving, each through the same entry
  points, for gemma2-27b at full width (46 layers, d_model 4608, vocab
  256000, window 4096; 2 prompts of 4608 tokens, so the window cuts the
  coded tail of every local layer: row 11 starts at 513-543 there, 46 x
  31 launches, 23 x 31 of them from a window start, which count also as
  ``pq_attn[window]``), deepseek-moe-16b at full width (28 layers, 64
  routed and 2 shared experts, top 6; 4 prompts of 2048 tokens; the
  tokens routed to each expert and those dropped by capacity at prefill
  printed) and qwen2-vl-72b at full width but 8 of its 80 layers
  (``reduced`` in its line: 145 GB of weights do not fit one card; 2
  prompts of 256 patch embeddings and 768 tokens, 15 + 15 steps).  Each
  frees the previous phase's model first and prints its seconds, ms a
  step and peak memory; on its first PQ step every layer's kernel route
  is held against its plain route and row 11 against its plain version
  on that layer's own range; its first exact step against ``forward``
  (moe: with a capacity no expert fills and every token on the experts
  the prefill and the step gave it, since capacity drops depend on the
  batch and bf16 router logits an ulp apart pick other experts); and its
  reduced config on the card against the CPU route (prefill, exact
  decode, PQ decode with ``mode="softmax"``, ``"topk"`` and
  ``quantize_v=True``; the same cache's codes bit for bit);
- ``lm_ssm_path``, ``lm_hybrid_path``, ``lm_encdec_path``
  (``LM_SEQUENTIAL_PATHS``): the families the reference serves token by
  token, at full width and depth from seeded random weights: mamba2-780m
  (48 SSD layers, d_model 1536; 8 prompts of 512 tokens), zamba2-2.7b
  (54 SSD layers in 9 groups, each after the weight-tied attention + MLP
  block; 4 prompts of 512 tokens) and seamless-m4t-large-v2 (24 encoder
  and 24 decoder layers; 4 x 1024 frames through
  ``prefill_cache_encdec``, then 4 prompts of 128 tokens).  Each prompt
  goes through ``serve_step`` one token at a time, then 31 greedy steps;
  prefill seconds, ms a step, tokens a second, weights and peak memory
  printed.  They run last, after every kernel's profiler window: after a
  million or more eager launches a profiler session may lose its first
  few kernel records; so each family's decode step is profiled in a
  child process that has launched nothing else, on a fresh cache of the
  phase's shape, in two sessions whose kernel counts must agree.  The last prefill step's
  logits are held against ``forward`` / ``forward_encdec`` over the
  prompt (correlation); layer 0's SSD state after the prefill against
  ``ssd_forward(return_state=True)`` on the input the decode gave it
  (the hybrid's shared block through ``attention_decode``) and on
  ``forward``'s input, with every layer's state on ``forward``'s input
  printed (ssm, hybrid); the reduced config on the card against the CPU
  route (logits, greedy tokens); and the SSM projections' float32
  product against float64.  No kernel of the port launches on these
  paths.
- ``train_path``, ``train_ssm_path`` (``TRAIN_PATHS``) and
  ``train_family_paths`` (``TRAIN_FAMILY_PATHS``): LM training through
  ``repro_torch.launch.train.main`` itself, from seeded float32 masters
  at full width: internlm2-1.8b and mamba2-780m at full depth, 8 x 1024
  tokens, 4 steps; zamba2-2.7b and seamless-m4t-large-v2 at full depth
  and deepseek-moe-16b on 2 of its 28 layers (``reduced`` in its line:
  16.9 B parameters would need 270 GB of training state), 4 x 1024, 3
  steps.  Each prints every step's loss, ``ce`` and seconds, seconds a
  step over the steps after the first, tokens a second, model FLOPs a
  step (``_train_flops``) and TFLOP/s, peak memory and the state's GiB,
  and checks that every loss and the gradient norm are finite, every
  leaf moved, and step 1 run twice from the same state gives the same
  loss and state bit for bit; for internlm2 and mamba2 (through
  ``_dot_f32``'s backward and the tied embedding's two cotangents) layer
  0 on the batch's first row (1 x 1024), forward and backward against
  the CPU route, every gradient within ``BLOCK_GRAD_RTOL``.  Then
  ``train_reduced_path``: each reduced config's train step
  (``microbatches=2``) on the card against the CPU route from the same
  masters; and ``train_resume_path``: ``main`` at a reduced config in a
  temp dir, 6 steps against 3 (preempted by its own SIGTERM) plus a
  resume to 6, the step-6 checkpoints equal bit for bit.  These run
  after every other phase and open no profiler session; no kernel of the
  port launches on them.

- ``tune_path``, ``examples_lm_path`` and ``cell_path`` (last):
  ``REPRO_TUNE=auto`` on the main path's quantizer at full width (encode,
  the fused exact encode, ``cdist_sym``, ``cdist_asym``, ``dtw_band_cdist``
  of 128 queries at w = 51 and one ``lb_refine`` wave of ``pruned_nn``):
  every key's candidates with their ms and the winner printed, the table
  written to ``chiprun_out/tune`` and pinned for a second run, codes,
  distances and ids of both equal to the ``off`` run's bit for bit, the
  tuner's launches counted apart; the two LM examples at the reference
  example's arguments (``serve_pqkv``: row 11 launched, greedy tokens
  against the CPU route's on the same seed; ``train_lm``: 200 steps
  preempted half-way and restarted, the loss falls); and the cell layer:
  the meta pass of every applicable (arch x shape) cell
  (``launch/dryrun.py --all`` in ``CELL_JOBS`` processes, after every
  other phase, so that nothing timed runs beside it) printed, then one
  real step of mamba2-780m's ``train_4k`` (2 microbatches),
  ``decode_32k`` and ``prefill_32k`` at a batch of 4, each timed after a
  warm-up step, with ``max_memory_allocated`` beside its meta peak.
- ``mesh_path`` (after ``cell_path``): the multi-device rules on one card.
  A child process builds a ``(1, 1)`` ``DeviceMesh`` on an NCCL group of
  one and runs internlm2-1.8b at full width and depth twice, without a
  mesh and laid out as ``DTensor`` s by the partition rules: one train
  step at 8 x 1024, then 4 exact and 4 PQ-KV decode steps after a 4 x
  1024 prefill (row 11 inside ``local_map``, 24 x 4 launches, in this
  phase's record and added to row 11's record); each equal bit for bit.
  Then row 11 on one layer's cache split four ways along its sequence,
  each shard in a thread, equal to the one-device call within one bf16
  ulp (``split_pq_decode``).  Beside it the per-device dry runs (``launch/dryrun.py --mesh
  single`` and ``multi``, a process a record) of ``MESH_CELLS`` (16
  records: per-device peak, FLOPs,
  collective bytes by kind, roofline terms), every one ``ok``, a train
  cell's per-device bf16 FLOPs times its devices within
  ``MESH_FLOPS_RATIO`` of the card's count.
- ``static_gate``, ``sanitizer_path`` and ``routing_gate`` (last): the
  port's static analysis (``repro_torch.analysis``) clean on this
  checkout against its baseline; every dispatch op
  (``check_sanitizers.device_ops``, 16 legs, and the two 1-NN entry
  points over encoded codes) on tiny CUDA inputs under
  ``torch.cuda.set_sync_debug_mode("error")``, a seeded ``.item()``
  among them tripping under its own name and nothing else
  (``KNOWN_READS``, ROADMAP queue 3, is empty: the ADC wrappers read
  nothing back since their range check moved to where codes enter the
  program); then an msm index on the index path's quantizers (fused exact
  encode, a two-level coarse quantizer of one DBA round,
  the 6144 series inserted, 768 queries searched, ``search_sharded``,
  flush and compaction, obs on: ``routing_leg``), and the routing gate
  (``check_routing``) on the whole run's obs snapshot, with and without
  the sanitizer's dispatches: every op of ``EXPECTED_OPS`` through route
  ``cuda``, a non-DTW measure for each of ``MEASURED_OPS``, every stage
  of ``EXPECTED_STAGES`` recorded.
  Their seconds are printed together (``new_phase_seconds``), with the
  card's name and power limit.

Then it holds every kernel against its plain PyTorch version on the paths'
own tensors and times both.  ``lb_refine`` is checked twice over: on every
wave of three searches (``pruned_nn``, the index's hot scan and a padded
serving batch; a second, untimed run of each) its flags and unrefined
outputs are held against the plain bound, and on the first wave and the
first mixed wave (refined and pruned pairs; the serving batch's first
wave with filler) of each search its whole output is held against the
plain version, its refined distances
against ``dtw_band``'s bit for bit, and the thread-per-pair form (the
wrapper's choice beyond ``w = 255``) is timed beside the warp form on the
same wave.  ``lb_refine_adaptive``
is held the same way on the adaptive hot scan, its refined distances bit
for bit, its thread form and its clamped warp sweep timed beside its
padded warp sweep, the latter equal to it bit for bit; ``dtw_band_adaptive``
(dtw, and wdtw, erp and msm as ``dtw_band_adaptive[wdtw]``, ``[erp]``,
``[msm]``) and the quantised ADC kernels must equal their plain versions
exactly, and ``dtw_band_adaptive``'s warp form its thread form, timed
beside it.  ``lb_filter`` (the encode's LB filter, row 6) runs on the
training set's segments: ``next_lb`` within ``S * 2**-23`` relative of the
plain version's, the candidates equal at every rank the plain bounds
decide (neighbours farther apart, or the same bound in float64), under 1%
of ranks left undecided.  ``dtw_band``'s register form is timed beside its
shared-memory form on the encode's refine pairs, equal bit for bit.
``dtw_band_cdist`` is timed in both its forms (the band row in registers,
the wrapper's choice at these shapes, and in shared memory) at ``fit``'s
shape and at the exact search's, equal bit for bit, and so are
``prealign_encode`` (registers, shared memory) on the training set and
under every measure, and ``dtw_band_full`` (a warp a pair, a thread a
pair) on the baseline's pairs; ``pq_attn`` is
launched on two streams at once, each launch equal to its single-stream
result, every stream's ticket counters back at 0, and is held and timed
again with a window start on gemma2's first local layer
(``pq_attn[window]``), equal to the shifted prefix bit for bit.

    python3 chip_smoke.py

It takes no arguments: the sizes above are fixed.  If the run ever nears
its time limit, cut ``EXACT_QUERIES`` first, never the PQ geometry.

Each phase prints one JSON line (the whole record also goes to
``chiprun_out/chip_smoke.jsonl``).
Then, before the last line, the kernel table ``{"kernels": [...]}`` and the
card's name and power limit as ``nvidia-smi`` gives them.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, so the exit code is non-zero and that line is
never printed.  Without a CUDA device the script exits non-zero at once.

``ms`` is the kernel's launch alone (mean of ``REPS`` back-to-back
launches, CUDA events, so a launch shorter than the host's launch overhead
reads that overhead); ``wrapper_ms`` in the phase line is the whole
wrapper call, checks included.  Rows whose launch is not timed apart
(``dtw_band``, ``dtw_band_cdist``, ``prealign_encode``) take their ``ms``
from the wrapper call: for ``prealign_encode`` that includes the per-call
transpose of the codebook to ``(M, S, K)`` that its register form needs
(``transpose_ms`` in its phase line).  ``prev_ms`` of a redesigned row is its
earlier form launched on the same inputs in the same run: for
``lb_refine`` and ``lb_refine_adaptive`` the thread-per-pair form (the
wrapper's choice beyond ``w = 255`` / width 256), for ``dtw_band_cdist``
the band row in shared memory (the wrapper's choice for wider bands), for
``dtw_band_full`` the thread-per-pair form (the wrapper's choice beyond
``L = 1024``), for ``prealign_encode`` and ``dtw_band`` the band rows in
shared memory (the wrapper's choice for wider bands; ``dtw_band``'s timed
as the launch alone, its ``ms`` as the wrapper call), for
``dtw_band_adaptive`` under each measure the thread-per-pair form (the
wrapper's choice beyond width 256), for ``adc_sym`` and ``adc_sym_quant``
the thread-per-output form (the wrapper's choice where a tile of 8
queries' table rows does not fit in shared memory; ``prev_device_ms``
beside it, and the row-staged form at the other tiles that fit as
``other_tiles_device_ms``), for ``adc_lookup`` and ``adc_lookup_quant``
the table form (an output a thread, a query's table a block: the
wrapper's choice where no tile fits or under ``LOOKUP_ROWS_MIN_NQ``
queries; the same fields, and both forms' device ms on the first ``Nq``
queries for each of ``LOOKUP_CROSSOVER_NQ`` as
``crossover_device_ms``), each equal to the new form bit for bit;
``lb_refine_adaptive``'s phase line also times its warp form with the
clamped sweep for every pair (``clamped_warp_form_ms``).  Bounds (``bound_ms``) use the H100 SXM's
published rates: 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the
tensor cores.  ``library_ms`` of ``pq_attn`` is
``scaled_dot_product_attention`` over the keys reconstructed from the
codes (exact attention over a cache of the same length), timed only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per DP cell of the dtw kernel: x - y, the fused
# multiply-add (2), two mins and the +inf clamp
DTW_OPS_PER_CELL = 6
RTOL, ATOL = 1e-5, 1e-4
FLAG_TIE_REL = 1e-5      # lb_refine: a flag may flip this near its threshold
TRAIN_PER_CLASS = 2048    # CBF series per class in the training set (x3)
QUERIES_PER_CLASS = 256   # CBF series per class in the query set (x3)
EXACT_QUERIES = 128       # queries for the exact elastic 1-NN
EXACT_CHECK_QUERIES = 16  # of those, held against the plain version
REPS = 5                  # timed repetitions per kernel
# torch.profiler keeps only the device records whose converted timestamps
# fall inside its window, and on the H100 those timestamps wander from the
# host's clock by ms (the ``profiler`` phase line's ``launch_to_kernel_ms``
# has read -15 ms): a window of a few short launches then loses some or all
# of its kernels.  Each window is padded by this much host time on both
# sides of what it profiles
PROFILE_PAD_S = 0.05
# a window that still holds no kernel record at all is profiled again, up to
# this many times, before the kernel count is checked
PROFILE_ATTEMPTS = 3
# launches of the kernel in one ``_device_ms`` window: after millions of
# eager launches a profiler session drops its first few kernel records
# (3.1 of 5 a window on average in PR 24's final smoke; all 5 of a window,
# three windows in a row, in one run of PR 25's tree), so a window
# launches more than those; the device time is the mean over the records
# it keeps
PROFILE_LAUNCHES = 16
PRUNED_QUERIES = 128      # queries for the LB-cascade 1-NN
SEARCH_WINDOW = 51        # the exact searches' band: round(0.1 * 512)
INDEX_LISTS = 64
HOT_CAPACITY = 2560
N_PROBE, TOPK = 8, 10
SERVING_CLIENTS = 4       # client threads of the serving path
SERVING_EXTRA_PER_CLASS = 512   # CBF series a class the producer inserts (x3)
SERVING_REQUESTS = 64    # requests a client sends at least
SERVING_AFTER = 4         # requests a client sends after the producer ends
SHARDED_QUERIES = 256     # queries of the planner checks
DELETE_FRAC = 0.05
ADAPTIVE_WIDTH = 32       # tune.adaptive_width(512, 51) at lane 8
WARPED_PAIRS = 512        # time-warped pairs for the certificate's check
QUANT_MAX_REL = 0.02      # quantised ADC: the reference's bound against f32
LM_ARCH = "internlm2-1.8b"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 2048, 32
PQ_ROUTE_TOL = 2e-2       # pq_attention_decode kernel vs plain route (bf16)
PQ_ATTN_TOL = 2e-4        # pq_attn vs its plain version / the oracle
LOGIT_ATOL = 2e-2         # LM logits, reduced config: card vs CPU route
LOGIT_CORR = 0.999        # full width: decode step vs forward
# the other families at full width: (phase, arch, batch, prompt, generated,
# patch embeddings, layers or None for the config's own depth)
LM_FAMILY_PATHS = (
    ("lm_local_global_path", "gemma2-27b", 2, 4608, 32, 0, None),
    ("lm_moe_path", "deepseek-moe-16b", 4, 2048, 32, 0, None),
    ("lm_vlm_path", "qwen2-vl-72b", 2, 1024, 16, 256, 8),
)
# the families served token by token (no batched prefill, no PQ-KV, as in
# the reference), at full width and depth: (phase, arch, batch, prompt,
# generated); encdec first encodes its config's 1024 frames
LM_SEQUENTIAL_PATHS = (
    ("lm_ssm_path", "mamba2-780m", 8, 512, 32),
    ("lm_hybrid_path", "zamba2-2.7b", 4, 512, 32),
    ("lm_encdec_path", "seamless-m4t-large-v2", 4, 128, 32),
)
# the most the child process that profiles their decode steps may take
SEQ_PROFILE_TIMEOUT_S = 300
# layer 0's SSD state after the prefill against ssd_forward's, norm-wise:
# on the input the decode gave layer 0 (the embedding; for the hybrid the
# shared block run through attention_decode), which leaves only the chunked
# scan against the recurrence (1.8e-6 read for mamba2), and on forward's
# own input (the hybrid's shared block parts by bf16 ulps there: 2.7e-3)
SSD_STATE_RTOL = {"decode_input": 1e-4, "forward_input": 1e-2}
DOT_F32_RTOL = 1e-5       # the SSM projections keep float32 sums
# training through launch/train.main at full width: (phase, arch, batch,
# seq, steps, layers or None for the config's depth)
TRAIN_PATHS = (
    ("train_path", "internlm2-1.8b", 8, 1024, 4, None),
    ("train_ssm_path", "mamba2-780m", 8, 1024, 4, None),
)
TRAIN_FAMILY_PATHS = (
    ("train_family_paths", "zamba2-2.7b", 4, 1024, 3, None),
    ("train_family_paths", "seamless-m4t-large-v2", 4, 1024, 3, None),
    # 16.9 B parameters would need 270 GB of training state
    ("train_family_paths", "deepseek-moe-16b", 4, 1024, 3, 2),
)
TRAIN_SEED = 0
BLOCK_GRAD_RTOL = 2e-2    # layer 0's gradients, card vs CPU route (bf16)
TRAIN_LOSS_RTOL = 1e-3    # a reduced train step, card vs CPU route
TRAIN_UPDATE_COS = 0.3    # ... each leaf's update against the CPU's
TRAIN_UPDATE_RTOL = 0.1   # ... all weights' update, in norm
RESUME_ARCH = "zamba2-2.7b"
BF16_PEAK_FLOPS = 989e12  # H100 SXM, dense bf16, at 700 W
# the slice-1 main path's kernels (each must launch there)
TRAIN_LM_STEPS = 200      # examples/train_lm.py's default
CELL_JOBS = 7             # processes of the meta pass (+1 for the batch cut)
CELL_WAIT_S = 300         # the most cell_path waits for the meta pass
# the one prefill cell the card takes a real step of: mamba2-780m's
# prefill_32k at a batch of 4 of its 32 (the whole cell needs 119 GiB)
CELL_PREFILL = ("mamba2-780m", "prefill_32k", 4)
CELL_RUNS = (("mamba2-780m", "train_4k", None, ""),
             ("mamba2-780m", "decode_32k", None, ""),
             (CELL_PREFILL[0], CELL_PREFILL[1],
              {"global_batch": CELL_PREFILL[2]}, f"b{CELL_PREFILL[2]}"))
# mesh_path: the host mesh on the card (internlm2-1.8b at full width and
# depth) and the per-device dry runs of one cell of each family and kind
MESH_ARCH = "internlm2-1.8b"
MESH_TRAIN = (8, 1024)            # batch x sequence of the train step
MESH_DECODE = (4, 1024, 4)        # batch, prompt, decode steps a route
MESH_CHILD_TIMEOUT_S = 420
# row 11 on a cache split along its sequence (split_pq_decode): shards,
# decode positions (of MESH_DECODE's 1028), and the bound: the merge
# reorders the tail's float32 softmax sums before the one rounding to
# bf16, so an element moves by at most one bf16 ulp (2**-7 relative)
MESH_SPLIT = 4
MESH_SPLIT_POS = (1024, 300)
MESH_SPLIT_TOL = {"rtol": 2 ** -7, "atol": 2 ** -12}
MESH_CELLS = (("internlm2-1.8b", "train_4k"), ("internlm2-1.8b", "decode_32k"),
              ("qwen2-72b", "train_4k"), ("qwen2-72b", "prefill_32k"),
              ("deepseek-moe-16b", "train_4k"), ("mamba2-780m", "train_4k"),
              ("mamba2-780m", "long_500k"),
              ("seamless-m4t-large-v2", "decode_32k"))
MESH_CELL_WAIT_S = 420
MESH_FLOPS_RATIO = 1.10   # a train cell: per-device bf16 FLOPs x devices
MAIN_PATH_KERNELS = ("dtw_band", "dtw_band_cdist", "adc_sym", "adc_lookup",
                     "prealign_encode", "lb_filter")
TPU_SITES = {
    "lb_filter": "none (XLA fuses the step at src/repro/core/pq.py:252-256)",
    "dtw_band": "src/repro/kernels/dtw_band/kernel.py:384",
    "dtw_band_cdist": "src/repro/kernels/dtw_band/kernel.py:411",
    "adc_sym": "src/repro/kernels/pq_adc/kernel.py:118",
    "adc_lookup": "src/repro/kernels/pq_adc/kernel.py:135",
    "prealign_encode": "src/repro/kernels/prealign_encode/kernel.py:133",
    "lb_refine": "src/repro/kernels/lb_cascade/kernel.py:138",
    "dtw_band_adaptive": "src/repro/kernels/dtw_band/kernel.py:384",
    "lb_refine_adaptive": "src/repro/kernels/lb_cascade/kernel.py:138",
    "adc_sym_quant": "src/repro/kernels/pq_adc/kernel.py:151",
    "adc_lookup_quant": "src/repro/kernels/pq_adc/kernel.py:170",
    "pq_attn": "src/repro/kernels/pq_attn/kernel.py:97",
    "dtw_band_full": "src/repro/kernels/dtw_band/kernel.py:384",
    "dtw_band_adaptive[erp]": "src/repro/kernels/dtw_band/kernel.py:384",
    "dtw_band_adaptive[msm]": "src/repro/kernels/dtw_band/kernel.py:384",
    "dtw_band_adaptive[wdtw]": "src/repro/kernels/dtw_band/kernel.py:384",
}
# rows redesigned for the H100 after their first port
DESIGNS = {
    "lb_refine": "one warp per pair, band anti-diagonals across the lanes "
                 "(thread per pair beyond w = 255)",
    "pq_attn": "split-K flash-decoding over the tail, merged in the same "
               "launch by the last CTA of each (row, group)",
    "lb_refine_adaptive": "one warp per pair, corridor slots across the "
                          "lanes (thread per pair beyond width 256)",
    "dtw_band_cdist": "the band row in registers, the B row staged in "
                      "shared memory (the row in shared memory where 2w+2 "
                      "exceeds 32 slots, 128 for dtw)",
    "dtw_band_full": "one warp per pair, each lane C = ceil(L/32) rows of "
                     "every full diagonal in registers (thread per pair "
                     "beyond L = 1024)",
    "prealign_encode": "the band row in registers against the segment "
                       "staged edge-padded, the codebook read as (M, S, K), "
                       "a shuffle argmin (the row in shared memory where "
                       "2w+2 exceeds 32 slots, 128 for dtw)",
    "dtw_band": "the band row in registers, each warp staging its 32 pairs' "
                "B columns 32 rows at a time (the row in shared memory where "
                "2w+2 exceeds 32 slots, 128 for dtw)",
    "dtw_band_adaptive": "one warp per pair, corridor slots across the lanes "
                         "on rows staged in shared memory, erp's border sums "
                         "formed there (thread per pair beyond width 256)",
    "adc_sym": "each query's table rows staged in shared memory, a lane per "
               "query, each warp walking groups of 16 codes_b rows, the "
               "outputs stored through the warp's tile (an output a thread "
               "where 8 queries' rows do not fit)",
    "lb_filter": "a CTA per 8 warps' series and a subspace, segments and "
                 "envelopes streamed through shared memory by cp.async, a "
                 "lane's bounds in registers, a warp radix select of the "
                 "stable top-(T+1)",
}
DESIGNS["adc_sym_quant"] = DESIGNS["adc_sym"]
DESIGNS["adc_lookup"] = (
    "adc_sym's row-staged body: each query's M table rows staged in shared "
    "memory, a lane per query, each warp walking groups of 16 code rows (an "
    "output a thread, a query's table a block, where 8 queries' rows do not "
    "fit or under LOOKUP_ROWS_MIN_NQ queries)")
DESIGNS["adc_lookup_quant"] = DESIGNS["adc_lookup"]
# query counts at which the lookup's two forms are timed (its crossover)
LOOKUP_CROSSOVER_NQ = (1, 4, 8, 16, 64, 96, 128, 192, 224, 256, 384, 768)
# the adaptive sweep's other measures on the card (row 7's op[measure])
ADAPTIVE_MEASURES = {"wdtw": "wdtw:g=0.1", "erp": "erp:g=0.3",
                     "msm": "msm:c=0.5"}
# float32 operations per DP cell of the other measures (wdtw: dtw's 6 and
# the weight's product; erp, msm: three moves, two mins and the clamp;
# msm's split/merge cost is 10 a move)
MEASURE_OPS_PER_CELL = {"wdtw": 7, "erp": 12, "msm": 28}
SOURCES = {
    "lb_filter": "src/repro_torch/kernels/csrc/lb_cascade.cu",
    "dtw_band": "src/repro_torch/kernels/csrc/dtw_band.cu",
    "dtw_band_cdist": "src/repro_torch/kernels/csrc/dtw_band.cu",
    "adc_sym": "src/repro_torch/kernels/csrc/pq_adc.cu",
    "adc_lookup": "src/repro_torch/kernels/csrc/pq_adc.cu",
    "prealign_encode": "src/repro_torch/kernels/csrc/prealign_encode.cu",
    "lb_refine": "src/repro_torch/kernels/csrc/lb_cascade.cu",
    "dtw_band_adaptive": "src/repro_torch/kernels/csrc/dtw_band.cu",
    "lb_refine_adaptive": "src/repro_torch/kernels/csrc/lb_cascade.cu",
    "adc_sym_quant": "src/repro_torch/kernels/csrc/pq_adc.cu",
    "adc_lookup_quant": "src/repro_torch/kernels/csrc/pq_adc.cu",
    "pq_attn": "src/repro_torch/kernels/csrc/pq_attn.cu",
    "dtw_band_full": "src/repro_torch/kernels/csrc/dtw_band.cu",
    "dtw_band_adaptive[erp]": "src/repro_torch/kernels/csrc/dtw_band.cu",
    "dtw_band_adaptive[msm]": "src/repro_torch/kernels/csrc/dtw_band.cu",
    "dtw_band_adaptive[wdtw]": "src/repro_torch/kernels/csrc/dtw_band.cu",
}

_records = []
# (kernels recorded, least launch-to-kernel ms) of each _device_ms window
_windows = []


def profiler_phase() -> None:
    """How the ``_device_ms`` windows fared: kernels lost against
    ``PROFILE_LAUNCHES``
    a window, and the range of the windows' least offsets of a kernel's
    start from its launch's (negative: the kernel's converted timestamp
    lies before its launch, by that much)."""
    offsets = [o for _, o in _windows if o is not None]
    emit({"phase": "profiler", "windows": len(_windows),
          "pad_s": PROFILE_PAD_S, "launches_a_window": PROFILE_LAUNCHES,
          "kernels_lost": sum(PROFILE_LAUNCHES - n for n, _ in _windows),
          "empty_windows": sum(1 for n, _ in _windows if n == 0),
          "launch_to_kernel_ms": ([min(offsets), max(offsets)]
                                  if offsets else None)})


def emit(record: dict) -> None:
    line = json.dumps(record)
    _records.append(line)
    print(line, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def band_cells(L: int, w: int) -> int:
    """DP cells inside a Sakoe-Chiba band of half-width w (w <= L-1)."""
    return L * (2 * w + 1) - w * (w + 1)


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _build.lib()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0})
    return run_phases(torch, _build, smi)


def run_phases(torch, _build, smi: str) -> int:
    """Every phase in order (module docstring)."""
    phase_s = {}
    ctx = main_path(torch, _build)
    waves = {}
    ctx["pruned_launches"] = pruned_nn(torch, _build, ctx, waves)
    ctx["index_launches"] = index_path(torch, _build, ctx, waves)
    ctx["serving_launches"] = serving_path(torch, _build, ctx, waves)
    ctx["adaptive_launches"] = adaptive_path(torch, _build, ctx, waves)
    ctx["quant_launches"] = quant_path(torch, _build, ctx)
    ctx["full_launches"] = full_baseline(torch, _build, ctx)
    ctx["eval_launches"] = {"table1_path": table1_path(torch, _build),
                            "fig5_path": fig5_path(torch, _build)}
    ctx["lm"] = lm_path(torch, _build)
    ctx["lm_families"] = {spec[0]: lm_family_path(torch, _build, *spec)
                          for spec in LM_FAMILY_PATHS}
    small_reference(torch)
    small_lm_reference(torch)
    kernels = kernel_phases(torch, ctx)
    kernels.append(lb_refine_phases(torch, ctx, waves))
    kernels += adaptive_kernel_phases(torch, ctx, waves)
    kernels += quant_kernel_phases(torch, ctx)
    lm_launches = [ctx["lm"]["launches"]] + [
        f["launches"] for f in ctx["lm_families"].values()]
    kernels.append(pq_attn_phase(torch, ctx["lm"], lm_launches))
    kernels.append(pq_attn_window_phase(
        torch, ctx["lm_families"]["lm_local_global_path"], lm_launches))
    kernels.append(full_kernel_phase(torch, ctx))
    measure_sweep(torch)
    profiler_phase()
    # last: after millions of eager launches a torch.profiler session
    # loses its first few kernel records, which would empty the kernel
    # rows' windows above; their own steps are profiled in a child process
    seq_profiles = profile_sequential_steps(torch)
    for spec in LM_SEQUENTIAL_PATHS:
        lm_sequential_path(torch, _build, *spec, seq_profiles[spec[0]])
    for spec in TRAIN_PATHS:
        train_full_path(torch, _build, *spec, block_check=True)
    for spec in TRAIN_FAMILY_PATHS:
        train_full_path(torch, _build, *spec, block_check=False)
    train_reduced_path(torch)
    train_resume_path(torch)
    for name, fn in (
            ("tune_path", lambda: tune_path(torch, _build, ctx, waves)),
            ("examples_lm_path",
             lambda: examples_lm_path(torch, _build, kernels)),
            ("cell_path", lambda: cell_path(torch)),
            ("mesh_path", lambda: mesh_path(torch, _build, kernels))):
        t0 = time.perf_counter()
        fn()
        phase_s[name] = time.perf_counter() - t0
    # the port's gates: the static analysis, every dispatch op under the
    # sync debug mode, and last the routing gate over the whole run
    gates = {}
    for name, fn in (
            ("static_gate", static_gate),
            ("sanitizer_path",
             lambda: gates.update(sanitized=sanitizer_path(torch, _build))),
            ("routing_gate",
             lambda: routing_gate(torch, _build, ctx, gates["sanitized"]))):
        t0 = time.perf_counter()
        fn()
        phase_s[name] = time.perf_counter() - t0
    emit({"phase": "new_phase_seconds", "nvidia_smi": nvidia_smi_line(),
          "seconds": phase_s})
    emit({"kernels": kernels})

    out = ROOT / "chiprun_out" / "chip_smoke.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(_records) + "\n")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# The main path, through the entry points a user calls
# ---------------------------------------------------------------------------

def main_path(torch, _build) -> dict:
    from repro_torch.core import dispatch, knn, metrics, pq
    from repro_torch.data.timeseries import make_dataset
    from repro_torch.kernels.pq_adc.ops import lookup_geometry, sym_geometry

    X, y = make_dataset("cbf", TRAIN_PER_CLASS, 512, seed=0)
    Q, yq = make_dataset("cbf", QUERIES_PER_CLASS, 512, seed=100)
    dev = torch.device("cuda")
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    Qd = torch.from_numpy(Q).to(dev)
    cfg = pq.PQConfig()
    cfg_exact = dataclasses.replace(cfg, exact_encode=True)
    D = X.shape[1]
    nq = EXACT_QUERIES
    w_exact = round(0.1 * D)
    seconds = {}

    def run(name, fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        return result

    _build.reset_launches()
    dispatch.reset_stats()
    cb = run("fit", lambda: pq.fit(Xd, cfg, torch.Generator().manual_seed(0)))
    codes = run("encode", lambda: pq.encode(Xd, cb, cfg))
    q_codes = run("encode_queries", lambda: pq.encode(Qd, cb, cfg))
    d_sym = run("cdist_sym", lambda: pq.cdist_sym(q_codes, codes, cb.lut))
    pred_sym = run("knn_classify_sym",
                   lambda: knn.knn_classify_sym(codes, yd, Qd, cb, cfg))
    d_asym = run("cdist_asym", lambda: pq.cdist_asym(Qd, codes, cb, cfg))
    pred_asym = run("knn_classify_asym",
                    lambda: knn.knn_classify_asym(codes, yd, Qd, cb, cfg))
    codes_fused = run("encode_exact_fused",
                      lambda: pq.encode(Xd, cb, cfg_exact))
    pred_nn = run("nn_dtw_exact", lambda: knn.nn_dtw_exact(
        Xd, yd, Qd[:nq], window=w_exact))
    launches = dict(_build.LAUNCHES)
    routes = sorted({route for _, route in dispatch.stats})

    M, K, S = cb.centroids.shape
    N, Nq = X.shape[0], Q.shape[0]
    check(tuple(cb.centroids.shape) == (cfg.n_sub, cfg.codebook_size,
                                        cfg.subseq_len(D)), "codebook shape")
    check(tuple(cb.lut.shape) == (M, K, K), "LUT shape")
    for name, t in (("centroids", cb.centroids), ("lut", cb.lut),
                    ("d_sym", d_sym), ("d_asym", d_asym)):
        check(bool(torch.isfinite(t).all()), f"{name} finite")
    check(bool((cb.lut >= 0).all()), "LUT non-negative")
    for name, c, n in (("codes", codes, N), ("q_codes", q_codes, Nq),
                       ("codes_fused", codes_fused, N)):
        check(tuple(c.shape) == (n, M) and c.dtype == torch.int32,
              f"{name} shape/dtype")
        check(int(c.min()) >= 0 and int(c.max()) < K, f"{name} range")
    check(tuple(d_sym.shape) == (Nq, N) and tuple(d_asym.shape) == (Nq, N),
          "distance shapes")
    check(torch.equal(pred_sym, yd[torch.argmin(d_sym, 1)]),
          "symmetric 1-NN = argmin of cdist_sym")
    check(routes == ["cuda"], f"main path routes {routes}")
    check(all(launches[k] > 0 for k in MAIN_PATH_KERNELS),
          f"every kernel launched on the main path: {launches}")
    check(sym_geometry(Nq, N, M, K, 4).form == "rows",
          "the main path's symmetric scans take the row-staged form")
    check(lookup_geometry(Nq, N, M, K, 4).form == "rows",
          "the main path's lookups take the row-staged form")
    acc = {
        "sym": 1.0 - metrics.error_rate(yq, pred_sym),
        "asym": 1.0 - metrics.error_rate(yq, pred_asym),
        "exact_dtw": 1.0 - metrics.error_rate(yq[:nq], pred_nn),
    }
    for name, a in acc.items():
        check(a > 0.5, f"{name} 1-NN accuracy {a} above chance")
    fused_equal_lb = float((codes_fused == codes).float().mean())
    emit({"phase": "main_path", "train": list(X.shape),
          "queries": list(Q.shape), "M": M, "K": K, "S": S,
          "window": cfg.window(D), "tail": cfg.tail(D),
          "refine_t": cfg.refine_t(), "exact_queries": nq,
          "exact_window": w_exact, "seconds": seconds,
          "total_s": sum(seconds.values()), "accuracy": acc,
          "lb_codes_equal_exact_codes": fused_equal_lb,
          "launches": launches, "routes": routes,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return dict(cfg=cfg, X=X, Xd=Xd, yd=yd, Qd=Qd, yq=yq, cb=cb, codes=codes,
                q_codes=q_codes, codes_fused=codes_fused, launches=launches,
                D=D, w_exact=w_exact)


# ---------------------------------------------------------------------------
# The search paths beyond 1-NN: exact LB-cascade search and the index
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def checked_waves(torch, lb_search, log: dict, extra=None):
    """Hook ``filtered_topk``'s ``lb_refine`` while the block runs.  Each
    wave still goes through the kernel once, as without the hook; then its
    pruning side is held against the plain bound (``lb.cascade_bound``):
    every flag equals ``bound < thresh`` apart from counted bound ties
    (within ``FLAG_TIE_REL`` of a finite threshold), a filler pair
    (``thresh = -inf``) never refines, and every unrefined pair returns its
    bound within ``rtol, atol``.  ``log`` gathers the counts over all waves
    and keeps the arguments of the first wave and of the first mixed wave
    (pairs refined and pairs pruned at their threshold; one that also
    carries filler where a wave does), and of the first wave with filler.
    ``extra(args, d, f, kw)`` runs
    more checks on each wave."""
    from repro_torch.core.lb import cascade_bound
    original = lb_search.lb_refine
    totals = log.setdefault("totals", dict.fromkeys(
        ("waves", "pairs", "refined", "pruned", "filler", "flag_ties"), 0))
    worst = log.setdefault("unrefined_max_abs_err", [0.0])

    def hook(A, B, upper, lower, thresh, window, **kw):
        d, f = original(A, B, upper, lower, thresh, window, **kw)
        lb = cascade_bound(B, A, upper, lower)
        filler = thresh == -float("inf")
        flips, _ = _flag_flips(torch, f, lb, thresh, "lb_refine wave")
        check(not bool((f & filler).any()),
              "lb_refine wave: no filler pair refines")
        kept = ~f & ~flips
        if bool(kept.any()):
            max_abs, _, ok = _errors(torch, d[kept], lb[kept])
            check(ok, "lb_refine wave: an unrefined pair returns its bound")
            worst[0] = max(worst[0], max_abs)
        n_ref = int(f.sum())
        n_filler = int(filler.sum())
        n_pruned = int((~f & ~filler).sum())
        for key, v in (("waves", 1), ("pairs", f.numel()), ("refined", n_ref),
                       ("pruned", n_pruned), ("filler", n_filler),
                       ("flag_ties", int(flips.sum()))):
            totals[key] += v
        args = (A, B, upper, lower, thresh, window)
        if extra is not None:
            extra(args, d, f, kw)
        log.setdefault("first", args)
        if n_filler > 0:
            log.setdefault("filler", args)
        if n_ref > 0 and n_pruned > 0:
            log.setdefault("mixed", args)
            if n_filler > 0:
                log.setdefault("mixed_filler", args)
        return d, f

    lb_search.lb_refine = hook
    try:
        yield log
    finally:
        lb_search.lb_refine = original


def _flag_flips(torch, f, lb, thresh, what):
    """The kernel's flags ``f`` against the plain ``lb < thresh``: they may
    differ only at bound ties, where the bound lies within
    ``FLAG_TIE_REL`` (relative) of a finite threshold.  Returns the flips
    and the pairs near their threshold."""
    near = torch.isfinite(thresh) & (
        (lb - thresh).abs() <= FLAG_TIE_REL * thresh.abs())
    flips = f != (lb < thresh)
    check(not bool((flips & ~near).any()),
          f"{what}: flags differ from the plain bound's only at bound ties")
    return flips, near


def _timed(torch, fn):
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - start


def pruned_nn(torch, _build, ctx, waves) -> dict:
    """``knn.nn_dtw_pruned`` on the first queries: predictions equal the
    exact 1-NN's, the top-1 distance equals the exact row minimum."""
    from repro_torch.core import dispatch, knn, lb_search
    Xd, yd = ctx["Xd"], ctx["yd"]
    Qn = ctx["Qd"][:PRUNED_QUERIES].contiguous()
    w = SEARCH_WINDOW
    _build.reset_launches()
    dispatch.reset_stats()
    (pred, pruned), secs = _timed(
        torch, lambda: knn.nn_dtw_pruned(Xd, yd, Qn, window=w))
    launches = dict(_build.LAUNCHES)
    check(launches["lb_refine"] > 0, f"pruned_nn launched lb_refine: "
          f"{launches}")
    check(sorted({r for _, r in dispatch.stats}) == ["cuda"],
          "pruned_nn routes")
    exact = knn.nn_dtw_exact(Xd, yd, Qn, window=w)
    check(torch.equal(pred, exact), "nn_dtw_pruned predictions equal "
          "nn_dtw_exact's")
    # the same search again, untimed, with every wave checked
    with checked_waves(torch, lb_search, waves.setdefault("pruned_nn", {})):
        d, idx, st = lb_search.filtered_topk(Qn, Xd, w, 1, with_stats=True)
    log = waves["pruned_nn"]["totals"]
    check(int(st["n_waves"]) == launches["lb_refine"] == log["waves"],
          "filtered_topk's wave count equals pruned_nn's lb_refine launches")
    n_pairs = float(Qn.shape[0] * Xd.shape[0])
    check(int(st["n_refined"]) == log["refined"]
          and 1.0 - log["refined"] / n_pairs == pruned,
          "the checked waves' refined pairs equal pruned_nn's count")
    d_all = dispatch.elastic_cdist(Qn, Xd, w)
    _, max_rel, ok = _errors(torch, d[:, 0], d_all.min(dim=1).values)
    check(ok, "pruned top-1 distance equals the exact row minimum")
    emit({"phase": "pruned_nn", "queries": list(Qn.shape),
          "train": list(Xd.shape), "window": w, "seconds": secs,
          "pruned": pruned, "n_waves": int(st["n_waves"]),
          "n_refined": int(st["n_refined"]),
          "n_bounded": int(st["n_bounded"]),
          "top1_max_rel_err": max_rel, "launches": launches})
    return launches


def index_path(torch, _build, ctx, waves) -> dict:
    """The streaming IVF-PQDTW index through its lifecycle at full size."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core import dispatch, ivf, pq
    from repro_torch.core.topk import smallest_k
    from repro_torch.index import (IndexConfig, StreamingIndex,
                                   restore_snapshot, save_snapshot)
    from repro_torch.index.streaming import search_impl
    from repro_torch.core import lb_search

    X, Xd, Qd, D = ctx["X"], ctx["Xd"], ctx["Qd"], ctx["D"]
    N, Nq = X.shape[0], Qd.shape[0]
    cfg = IndexConfig(pq.PQConfig(), n_lists=INDEX_LISTS,
                      hot_capacity=HOT_CAPACITY)
    w = cfg.coarse_window(D)
    check(w == SEARCH_WINDOW, f"hot-scan window {w}")
    seconds = {}
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    dispatch.reset_stats()
    idx, seconds["bootstrap"] = _timed(torch, lambda: StreamingIndex.bootstrap(
        torch.Generator().manual_seed(0), Xd, cfg))
    ids, seconds["insert"] = _timed(torch, lambda: idx.insert(X))
    check(idx.n_segments == 2 and idx.hot.count == N - 2 * HOT_CAPACITY,
          f"insert: {idx.stats()}")
    rng = np.random.default_rng(1)
    dead = np.sort(rng.choice(ids, int(DELETE_FRAC * N), replace=False))
    hot_dead = int((dead >= 2 * HOT_CAPACITY).sum())
    check(0 < hot_dead < len(dead), "deletes hit hot and sealed rows")
    hit, seconds["delete"] = _timed(torch, lambda: idx.delete(dead))
    check(hit == len(dead), f"delete hit {hit} of {len(dead)}")
    (d, i), seconds["search"] = _timed(torch, lambda: idx.search(
        Qd, n_probe=N_PROBE, topk=TOPK))
    check(np.array_equal(ids, np.arange(N)), "insert ids are row numbers")
    ctx["index_state"] = dict(cfg=cfg, coarse=idx.coarse, cb=idx.cb,
                              two_level=idx.two_level, dead=dead,
                              static_d=d, static_i=i)
    stage_names = ("coarse", "lut", "fine", "hot", "merge")
    before = {s: _stage_sum(obs, s) for s in stage_names}
    counters0 = _lb_counters(obs)
    with obs.override(True):
        (d_on, i_on), seconds["search_obs_on"] = _timed(
            torch, lambda: idx.search(Qd, n_probe=N_PROBE, topk=TOPK))
    launches = dict(_build.LAUNCHES)
    stages = {s: _stage_sum(obs, s) - before[s] for s in stage_names}
    counters = {k: v - counters0[k] for k, v in _lb_counters(obs).items()}
    check(torch.equal(i, i_on) and torch.equal(d, d_on),
          "search identical with obs on and off")
    for k in ("lb_refine", "dtw_band", "dtw_band_cdist"):
        check(launches[k] > 0, f"index path launched {k}: {launches}")
    check(sorted({r for _, r in dispatch.stats}) == ["cuda"],
          "index path routes")
    check(tuple(d.shape) == (Nq, TOPK) and bool(torch.isfinite(d).all()),
          "index search: finite (Nq, topk) distances")
    check(not bool(torch.isin(i, torch.from_numpy(dead).to(i.device)).any()),
          "no deleted id is returned")

    # the hot part alone equals a dense scan over the live hot rows
    # (the hot scan again, untimed, with every wave checked)
    hot = idx._hot_arrays()
    with checked_waves(torch, lb_search, waves.setdefault("hot_scan", {})):
        hd, hi = search_impl(idx.coarse, idx.cb, (), hot, Qd, icfg=cfg,
                             n_probe=N_PROBE, topk=TOPK, dim=D)
    data, hids, live = hot
    dense = dispatch.elastic_cdist(Qd, data, w)
    dense = torch.sqrt(torch.where(live[None, :], dense, float("inf")))
    wd, wi = smallest_k(dense, TOPK)
    wi = torch.where(torch.isfinite(wd), hids[wi], -1)
    _, hot_rel, ok = _errors(torch, hd, wd)
    check(ok and torch.equal(hi, wi.to(hi.dtype)),
          "hot scan equals the dense scan (ids and distances)")

    _, seconds["flush_compact"] = _timed(
        torch, lambda: (idx.flush(), idx.compact()))
    live_ids = idx.live_ids()
    check(idx.n_segments == 1 and len(live_ids) == N - len(dead),
          f"compacted: {idx.stats()}")
    (cd, ci), seconds["search_compacted"] = _timed(
        torch, lambda: idx.search(Qd, n_probe=N_PROBE, topk=TOPK))
    ref, seconds["build_index_ref"] = _timed(torch, lambda: ivf.build_index(
        None, X[live_ids], cfg.pq, n_lists=INDEX_LISTS, coarse=idx.coarse,
        cb=idx.cb))
    rd, ri = ivf.search_batch(ref, Qd, cfg.pq, n_probe=N_PROBE, topk=TOPK)
    lid = torch.from_numpy(live_ids).to(ri.device)
    ri = torch.where(ri >= 0, lid[ri.long().clamp(min=0)].to(ri.dtype), -1)
    _, ivf_rel, ok = _errors(torch, cd, rd)
    check(ok and torch.equal(ci, ri),
          "compacted index equals ivf.search_batch over the live rows")

    snap_dir = ROOT / "build" / "chip_smoke_snapshots"
    shutil.rmtree(snap_dir, ignore_errors=True)
    _, seconds["snapshot_save"] = _timed(
        torch, lambda: save_snapshot(str(snap_dir), idx))
    back, seconds["snapshot_restore"] = _timed(
        torch, lambda: restore_snapshot(str(snap_dir)))
    bd, bi = back.search(Qd, n_probe=N_PROBE, topk=TOPK)
    shutil.rmtree(snap_dir, ignore_errors=True)
    check(torch.equal(bi, ci) and torch.equal(bd, cd),
          "snapshot round-trips bit for bit")

    emit({"phase": "index_path", "train": list(X.shape),
          "queries": list(Qd.shape), "n_lists": INDEX_LISTS,
          "hot_capacity": HOT_CAPACITY, "n_probe": N_PROBE, "topk": TOPK,
          "hot_window": w, "deleted": len(dead), "deleted_hot": hot_dead,
          "seconds": seconds, "stage_seconds_obs_on": stages,
          "lb_counters": counters, "hot_max_rel_err": hot_rel,
          "ivf_max_rel_err": ivf_rel, "memory_cost": idx.memory_cost(),
          "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return launches


def serving_path(torch, _build, ctx, waves) -> dict:
    """The serving core (``IndexServer``) at the index path's size: the
    index path's quantizers, the 6144 series inserted (2 sealed + 1024
    hot), ``ServeConfig(n_probe=8, topk=10)`` with the buckets 1-64.  The
    warm-replay gate first; then ``SERVING_CLIENTS`` client threads send
    ``SERVING_REQUESTS`` requests or more of 1-64 of the 768 queries
    while a producer inserts 1536 more CBF series (one seal), deletes 5%
    of the ids, flushes and compacts, all through the server.  A search
    launches rows 2 (coarse stage, query tables) and 6 (hot scan); row 1
    runs in the seal's encode.  Every batch searched again on the
    view it reports, in its bucket, equals its result bit for bit; every
    request's rows searched alone on that view give the same ids and
    distances within 1e-6; no deleted id comes back after its delete
    resolves; an insert is visible once it resolves.  A padded batch
    from before the seal and one from after it are held against the
    plain route on the card, and rows 1, 2 and 6 against their plain
    versions at this path's shapes (:func:`_serving_plain`).  Then
    ``search_sharded``'s plans on the quiesced state, against
    ``StreamingIndex.search``, for 1 and 4 devices."""
    import threading
    import numpy as np
    from repro_torch import obs
    from repro_torch.bench.warm_replay import warm_replay
    from repro_torch.core import dispatch
    from repro_torch.data.timeseries import make_dataset
    from repro_torch.index import StreamingIndex, search_sharded
    from repro_torch.serve_index import IndexServer, ServeConfig

    t_phase = time.perf_counter()
    st = ctx["index_state"]
    X, D = ctx["X"], ctx["D"]
    Q = ctx["Qd"].cpu().numpy()
    N, Nq = X.shape[0], Q.shape[0]
    X2, _ = make_dataset("cbf", SERVING_EXTRA_PER_CLASS, D, seed=200)
    n_extra = X2.shape[0]
    cfg = st["cfg"]
    seconds = {}

    def fresh(icfg):
        return StreamingIndex.from_parts(icfg, st["coarse"], st["cb"], D,
                                         two_level=st["two_level"])

    idx = fresh(cfg)
    _, seconds["insert"] = _timed(torch, lambda: idx.insert(X))
    check(idx.n_segments == 2 and idx.hot.count == N - 2 * HOT_CAPACITY,
          f"serving index: {idx.stats()}")
    check(idx.hot.count + n_extra == HOT_CAPACITY,
          "the producer's inserts fill the hot buffer: one seal")
    scfg = ServeConfig(n_probe=N_PROBE, topk=TOPK)
    views, batches, requests, errors, writes = {}, [], [], [], []
    lock = threading.Lock()
    srv = IndexServer(idx, scfg, on_publish=lambda v:
                      views.setdefault(v.version, v))
    views[0] = srv.view
    run_batch = srv._coalescer._run_batch

    def recording(Qp, q_valid, n_real):
        r = run_batch(Qp, q_valid, n_real)
        with lock:
            batches.append((Qp, q_valid, n_real, r))
        return r

    srv._coalescer._run_batch = recording
    srv.start()
    try:
        t0 = time.perf_counter()
        replay = warm_replay(srv, Q, sizes=range(1, scfg.max_batch + 1))
        seconds["warm_replay"] = time.perf_counter() - t0
        check(replay["ok"], f"warm replay: {replay['failures']}")
        batches.clear()

        rng = np.random.default_rng(3)
        dead = np.sort(rng.choice(N + n_extra, int(DELETE_FRAC *
                                                   (N + n_extra)),
                                  replace=False)).astype(np.int32)
        done = threading.Event()
        marks = {}

        def client(seed):
            crng = np.random.default_rng(seed)
            n, n_after = 0, 0
            while n < SERVING_REQUESTS or n_after < SERVING_AFTER:
                after = done.is_set()
                rows = crng.integers(0, Nq, size=int(crng.integers(1, 65)))
                t_sub = time.monotonic()
                r = srv.submit_search(Q[rows]).result(timeout=300)
                lat = time.monotonic() - t_sub
                with lock:
                    requests.append((rows, r, t_sub, lat))
                n += 1
                n_after += after

        def producer():
            half = n_extra // 3

            def write(op, submit):
                # the write's window on the host clock: submit to resolve
                t_w = time.monotonic()
                out = submit().result(timeout=300)
                writes.append((op, t_w, time.monotonic()))
                return out

            ids_a = write("insert", lambda: srv.insert(X2[:half]))
            probe = min(8, half)
            marks["visible"] = (ids_a[:probe],
                                srv.search(X2[:probe], timeout=300))
            marks["ids_b"] = write("insert_seal",
                                   lambda: srv.insert(X2[half:]))
            marks["sealed_version"] = srv.quiesce(timeout=300)
            check(write("delete", lambda: srv.delete(dead)) == len(dead),
                  "every deleted id hit")
            marks["deleted_at"] = time.monotonic()
            write("flush", srv.flush)
            write("compact", srv.compact)

        def guarded(fn, *args):
            try:
                fn(*args)
            except BaseException as e:                # noqa: BLE001
                errors.append(e)
            finally:
                if fn is producer:
                    done.set()

        _build.reset_launches()
        dispatch.reset_stats()
        swaps0 = len(obs.histogram("serving_snapshot_swap_seconds",
                                   persistent=True).samples)
        stages0 = _stage_seconds(obs)
        with obs.override(True):
            threads = [threading.Thread(target=guarded, args=(client, s))
                       for s in range(SERVING_CLIENTS)]
            threads.append(threading.Thread(target=guarded,
                                            args=(producer,)))
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            version = srv.quiesce(timeout=300)
            torch.cuda.synchronize()
            seconds["traffic"] = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        routes = sorted({r for _, r in dispatch.stats})
        stages = {k: v - stages0.get(k, 0.0)
                  for k, v in sorted(_stage_seconds(obs).items())
                  if v > stages0.get(k, 0.0)}
        swap_s = obs.histogram("serving_snapshot_swap_seconds",
                               persistent=True).samples[swaps0:]
        for e in errors:
            raise e
    finally:
        srv.stop()

    for k in ("lb_refine", "dtw_band", "dtw_band_cdist"):
        check(launches[k] > 0, f"serving path launched {k}: {launches}")
    check(routes == ["cuda"], f"serving path routes {routes}")
    check(version >= 5 and idx.n_segments == 1 and idx.hot.count == 0,
          f"the writes were applied: version {version}, {idx.stats()}")

    # an insert is visible once it resolves: the rows themselves are their
    # own nearest neighbours in the exact hot scan
    ids_a, (vd, vi) = marks["visible"]
    check(torch.equal(vi[:, 0].cpu(), torch.from_numpy(ids_a)) and
          bool((vd[:, 0] == 0).all()),
          "a search after insert(...).result() sees the inserted rows")
    check(views[marks["sealed_version"]].n_live() == N + n_extra
          and len(views[marks["sealed_version"]].segments) == 3,
          "the second insert sealed the hot buffer")

    # every batch again on its view, in its bucket: the same bits; every
    # request's rows alone: the same ids, distances within 1e-6
    t0 = time.perf_counter()
    buckets = {}
    for Qp, q_valid, n_real, r in batches:
        buckets[Qp.shape[0]] = buckets.get(Qp.shape[0], 0) + 1
        d, i = views[r.version].search(Qp, n_probe=N_PROBE, topk=TOPK,
                                       q_valid=q_valid)
        check(torch.equal(d, r.dist) and torch.equal(i, r.ids),
              f"batch of {n_real} in bucket {Qp.shape[0]} (version "
              f"{r.version}) equals its re-run bit for bit")
        check(bool(torch.isinf(r.dist[n_real:]).all())
              and bool((r.ids[n_real:] == -1).all()),
              "padded rows are inf / -1")
    dead_t = torch.from_numpy(dead).cuda()
    unpadded_bits, after_delete = 0, 0
    for rows, r, t_sub, _ in requests:
        d, i = views[r.version].search(Q[rows], n_probe=N_PROBE, topk=TOPK)
        check(torch.equal(i, r.ids) and torch.allclose(
            d, r.dist, rtol=1e-6, atol=1e-6),
            f"request of {len(rows)} equals its rows' search on version "
            f"{r.version}")
        unpadded_bits += bool(torch.equal(d, r.dist))
        if t_sub > marks["deleted_at"]:
            after_delete += 1
            check(not bool(torch.isin(r.ids, dead_t).any()),
                  "no deleted id after its delete resolved")
    check(after_delete > 0, "requests were made after the delete")
    seconds["rerun_checks"] = time.perf_counter() - t0

    # the kernel route against the plain route at this path's shapes
    t0 = time.perf_counter()
    plain = _serving_plain(torch, views, batches, marks["sealed_version"],
                           np.concatenate([X, X2]), cfg, Q,
                           waves.setdefault("serving", {}))
    seconds["plain_checks"] = time.perf_counter() - t0

    # the planner on the quiesced state: one device (the served index) and
    # four (the same rows sealed for n_shards=4)
    t0 = time.perf_counter()
    Qs = Q[:SHARDED_QUERIES]
    idx4 = fresh(dataclasses.replace(cfg, n_shards=4))
    idx4.insert(X)
    idx4.delete(dead[dead < N])
    planner = {}
    for name, index, n_dev in (("1", idx, 1), ("4", idx4, 4)):
        want = index.search(Qs, n_probe=N_PROBE, topk=TOPK)
        for part in ("queries", "lists"):
            got = search_sharded(index, Qs, n_probe=N_PROBE, topk=TOPK,
                                 partition=part, n_devices=n_dev)
            planner[f"{part}/{name}"] = _same_up_to_ties(
                torch, got, want, f"search_sharded {part} on {name}")
    seconds["planner"] = time.perf_counter() - t0

    lat = [l for _, _, _, l in requests]
    n_queries = sum(len(rows) for rows, _, _, _ in requests)
    slow = _slow_requests(np, requests, writes)
    real = [n for _, _, n, _ in batches]
    launch_counts = {k: v for k, v in launches.items() if v}
    emit({"phase": "serving_path", "nvidia_smi": nvidia_smi_line(),
          "train": list(X.shape), "extra": list(X2.shape),
          "queries": list(Q.shape), "n_lists": INDEX_LISTS,
          "hot_capacity": HOT_CAPACITY, "n_probe": N_PROBE, "topk": TOPK,
          "q_buckets": list(scfg.q_buckets), "clients": SERVING_CLIENTS,
          "obs": True, "requests": len(requests), "queries_served": n_queries,
          "qps": n_queries / seconds["traffic"],
          "p50_ms": 1e3 * float(np.percentile(lat, 50)),
          "p99_ms": 1e3 * float(np.percentile(lat, 99)),
          "slow_requests": slow, "batches": len(batches), "mean_batch": float(np.mean(real)),
          "batches_per_bucket": dict(sorted(buckets.items())),
          "view_swaps": len(swap_s), "final_version": version,
          "snapshot_swap_p50_ms": 1e3 * float(np.median(swap_s)),
          "deleted": len(dead), "requests_after_delete": after_delete,
          "unpadded_bit_identical": unpadded_bits,
          "warm_replay": {k: replay[k] for k in ("lib_loaded",
                                                 "reserved_bytes")},
          "warm_replay_launches_64": replay["launches"][scfg.max_batch],
          "planner_tie_reorders": planner, "plain": plain,
          "seconds": seconds,
          "stage_seconds_obs_on": stages,
          "wall_s": time.perf_counter() - t_phase,
          "launches": launch_counts})
    return launches


def _slow_requests(np, requests, writes) -> dict:
    """Which writes the slowest 1% of requests overlapped, on the host
    clock: a request's window is submit to answer, a write's is submit to
    resolve (``writes``: ``(op, start, end)``).  ``clear_*`` are the
    latencies of the requests that overlapped no write."""
    lat = np.array([l for _, _, _, l in requests])
    cut = float(np.percentile(lat, 99))
    over = {op: 0 for op, _, _ in writes}
    n_slow, clear = 0, []
    for _, _, t_sub, l in requests:
        hit = [op for op, a, b in writes if t_sub < b and a < t_sub + l]
        if l >= cut:
            n_slow += 1
            for op in hit:
                over[op] += 1
        if not hit:
            clear.append(l)
    return {"p99_cut_ms": 1e3 * cut, "slow": n_slow,
            "slow_overlapping": over,
            "writes_ms": {op: 1e3 * (b - a) for op, a, b in writes},
            "clear": len(clear),
            "clear_p50_ms": 1e3 * float(np.percentile(clear, 50))
            if clear else None,
            "clear_p99_ms": 1e3 * float(np.percentile(clear, 99))
            if clear else None}


@contextlib.contextmanager
def _recording(module, name: str, calls: list):
    """Record the arguments of every call of ``module.name`` while the
    block runs; the call itself still goes through."""
    original = getattr(module, name)

    def hook(*args, **kw):
        calls.append((args, kw))
        return original(*args, **kw)

    setattr(module, name, hook)
    try:
        yield calls
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def _plain_kernels():
    """Rows 1, 2 and 6 (``dtw_band``, ``dtw_band_cdist``, ``lb_refine``)
    replaced by their plain PyTorch versions while the block runs: the
    dispatch layer then computes on the card's tensors without a kernel
    (the plain route on the card)."""
    from repro_torch.kernels.dtw_band import ops as band_ops
    from repro_torch.kernels.dtw_band.ref import (dtw_band_cdist_ref,
                                                  dtw_band_ref)
    from repro_torch.kernels.lb_cascade import ops as lb_ops
    from repro_torch.kernels.lb_cascade.ref import lb_refine_ref
    swaps = ((band_ops, "dtw_band", dtw_band_ref),
             (band_ops, "dtw_band_cdist", dtw_band_cdist_ref),
             (lb_ops, "lb_refine", lb_refine_ref))
    originals = [getattr(m, n) for m, n, _ in swaps]
    for m, n, ref in swaps:
        setattr(m, n, ref)
    try:
        yield
    finally:
        for (m, n, _), fn in zip(swaps, originals):
            setattr(m, n, fn)


def _serving_plain(torch, views, batches, sealed_version, X_all, cfg, Q,
                   log) -> dict:
    """The serving path's kernels against their plain versions on the same
    inputs.  Two padded bucket batches are searched again on the views
    they report: the last recorded one from before the seal (hot rows:
    every ``lb_refine`` wave checked and logged in ``log`` for
    :func:`lb_refine_phases`) and the last from after it (three sealed
    segments, one encoded by the seal); a batch of 37 queries in bucket 64
    stands in on the first or the last view where no recorded batch
    exists.  Each re-run equals the recorded result bit for bit, and the
    same search with rows 1, 2 and 6 in their plain versions
    (:func:`_plain_kernels`) gives the same distances bit for bit and the
    same ids up to the order of exact ties.  Every ``dtw_band_cdist``
    call of the re-runs (the coarse stage, 64 x 64 centroids at L=512,
    and the per-subspace query tables) equals ``dtw_band_cdist_ref`` on
    its inputs, bit for bit.  The seal's segment: its rows encoded
    and lists equal its codes and list ids, the plain route's encode and
    assignment equal them, and each ``dtw_band`` call of that encode (row
    1 at the seal's shape) and ``dtw_band_cdist`` call of the assignment
    (row 2, 2560 x 64 at L=512) equals its plain version, bit for bit."""
    from repro_torch.core import lb_search, pq
    from repro_torch.core.ivf import coarse_assign
    from repro_torch.kernels.dtw_band import ops as band_ops
    from repro_torch.kernels.dtw_band.ref import (dtw_band_cdist_ref,
                                                  dtw_band_ref)
    padded = [b for b in batches if b[2] < b[0].shape[0]]
    chosen = []
    for before, fallback in ((True, 0), (False, max(views))):
        mine = [b for b in padded if (b[3].version < sealed_version)
                == before]
        if mine:
            Qp, q_valid, n_real, r = mine[-1]
            chosen.append((Qp, q_valid, n_real, r.version, r.dist, r.ids,
                           True))
            continue
        n_real, bucket = 37, 64
        Qp = torch.zeros((bucket, Q.shape[1]), device="cuda")
        Qp[:n_real] = torch.from_numpy(Q[:n_real]).cuda()
        q_valid = torch.arange(bucket, device="cuda") < n_real
        d, i = views[fallback].search(Qp, n_probe=N_PROBE, topk=TOPK,
                                      q_valid=q_valid)
        chosen.append((Qp, q_valid, n_real, fallback, d, i, False))
    out = {"batches": [], "row2_calls": 0, "row2_shapes": []}
    secs = out["seconds"] = {}
    t0 = time.perf_counter()
    cdist_calls = []
    for Qp, q_valid, n_real, version, rd, ri, recorded in chosen:
        view = views[version]
        what = (f"batch of {n_real} in bucket {Qp.shape[0]} on version "
                f"{version}")
        with _recording(band_ops, "dtw_band_cdist", cdist_calls), \
                checked_waves(torch, lb_search, log):
            d, i = view.search(Qp, n_probe=N_PROBE, topk=TOPK,
                               q_valid=q_valid)
        check(torch.equal(d, rd) and torch.equal(i, ri),
              f"{what}: the re-run equals the recorded result")
        with _plain_kernels():
            want = view.search(Qp, n_probe=N_PROBE, topk=TOPK,
                               q_valid=q_valid)
        reorders = _same_up_to_ties(torch, (d, i), want,
                                    f"{what} against the plain route")
        out["batches"].append({
            "version": version, "bucket": Qp.shape[0], "real": n_real,
            "recorded": recorded, "before_seal": version < sealed_version,
            "hot_rows": 0 if view.hot is None else int(view.hot[2].sum()),
            "segments": len(view.segments), "tie_reorders": reorders})
    check(any(b["hot_rows"] for b in out["batches"]),
          "a held batch scanned hot rows")
    secs["batches"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shapes = set()
    for args, kw in cdist_calls:
        A, B = args[0], args[1]
        check(torch.equal(band_ops.dtw_band_cdist(*args, **kw),
                          dtw_band_cdist_ref(*args, **kw)),
              f"dtw_band_cdist at {tuple(A.shape)} x {tuple(B.shape)}: "
              "equals its plain version bit for bit")
        shapes.add((tuple(A.shape), tuple(B.shape), args[2]))
    out["row2_calls"] = len(cdist_calls)
    out["row2_shapes"] = sorted(shapes)
    secs["row2"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # the seal: its segment's rows encoded again, on both routes
    sealed = views[sealed_version]
    seg = sealed.segments[-1]
    keep = seg.ids >= 0
    rows = torch.from_numpy(X_all).cuda()[seg.ids[keep].long()]
    pair_calls, assign_calls = [], []
    with _recording(band_ops, "dtw_band", pair_calls):
        codes = pq.encode(rows, sealed.cb, cfg.pq)
    w = cfg.coarse_window(X_all.shape[1])
    with _recording(band_ops, "dtw_band_cdist", assign_calls):
        assign = coarse_assign(rows, sealed.coarse, w, cfg.pq.measure())
    check(torch.equal(codes, seg.codes[keep]) and
          torch.equal(assign.to(seg.assign.dtype), seg.assign[keep]),
          "the seal's codes and lists equal its rows encoded again")
    with _plain_kernels():
        plain_codes = pq.encode(rows, sealed.cb, cfg.pq)
        plain_assign = coarse_assign(rows, sealed.coarse, w,
                                     cfg.pq.measure())
    check(torch.equal(plain_codes, codes) and
          torch.equal(plain_assign, assign),
          "the seal's encode and list assignment equal the plain route's")
    for args, kw in assign_calls:
        check(torch.equal(band_ops.dtw_band_cdist(*args, **kw),
                          dtw_band_cdist_ref(*args, **kw)),
              f"dtw_band_cdist at the seal's {tuple(args[0].shape)} x "
              f"{tuple(args[1].shape)}: equals its plain version bit for "
              "bit")
    check(len(pair_calls) > 0, "the seal's encode ran row 1")
    row1 = []
    for args, kw in pair_calls:
        check(torch.equal(band_ops.dtw_band(*args, **kw),
                          dtw_band_ref(*args, **kw)),
              f"dtw_band at {tuple(args[0].shape)}: equals its plain "
              "version bit for bit")
        row1.append([list(args[0].shape), args[2]])
    secs["seal"] = time.perf_counter() - t0
    out["seal"] = {"rows": int(keep.sum()), "row1_calls": row1,
                   "row2_calls": [[list(a[0].shape), list(a[1].shape),
                                   a[2]] for a, _ in assign_calls]}
    return out


def _stage_seconds(obs) -> dict:
    """Seconds recorded so far by every obs stage span.  Under concurrent
    traffic a span's fence waits for the whole card, so a stage's seconds
    also hold the other threads' work in flight."""
    return {h["labels"]["stage"]: h["sum"]
            for h in obs.snapshot()["histograms"]
            if h["name"] == "stage_seconds"}


def _same_up_to_ties(torch, got, want, what) -> int:
    """Equal distances bit for bit and equal ids, apart from ids reordered
    inside a run of equal distances (the merge order of exact ties);
    returns how many positions differ so."""
    (gd, gi), (wd, wi) = got, want
    check(torch.equal(gd, wd), f"{what}: distances equal bit for bit")
    diff = gi != wi
    if not bool(diff.any()):
        return 0
    tie = torch.zeros_like(diff)
    tie[:, 1:] |= wd[:, 1:] == wd[:, :-1]
    tie[:, :-1] |= wd[:, :-1] == wd[:, 1:]
    check(bool(tie[diff].all()), f"{what}: ids differ only inside ties")
    return int(diff.sum())


def _stage_sum(obs, stage: str) -> float:
    h = obs.REGISTRY.histogram("stage_seconds", persistent=True,
                               stage=f"index.search.{stage}")
    return h.sum


def _lb_counters(obs) -> dict:
    snap = obs.snapshot()
    return {name: obs.counter_value(snap, f"lb_{name}_total")
            for name in ("candidates_bounded", "candidates_refined",
                         "candidates_pruned", "refine_waves")}


# ---------------------------------------------------------------------------
# The opt-in layer: adaptive corridors and quantised ADC tables
# ---------------------------------------------------------------------------

def _warped_pairs(torch, n, L, drift=3, seed=0):
    """Random walks and their copies under small monotone time warps plus
    noise (the reference's own generator for converging corridors)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    A = np.cumsum(rng.normal(size=(n, L)), axis=1).astype(np.float32)
    B = np.empty_like(A)
    for i in range(n):
        off = np.clip(np.cumsum(rng.integers(-1, 2, size=L)), -drift, drift)
        B[i] = A[i, np.clip(np.arange(L) + off, 0, L - 1)]
    B = (B + rng.normal(scale=0.05, size=B.shape)).astype(np.float32)
    return torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda()


def adaptive_path(torch, _build, ctx, waves) -> dict:
    """``IndexConfig(band="adaptive")``: the index of ``index_path`` (its
    quantizers, the same inserts and deletes: 2 sealed segments and the
    hot buffer) searched with the 768 queries, so the hot scan refines
    inside per-pair corridors (``lb_refine_adaptive``); then
    ``elastic_pairwise(band="adaptive")`` and ``certify_adaptive`` on the
    7680 zipped pairs of each query and its static top 10.

    Checks: every adaptive wave's pruning side against the plain bound (as
    for ``lb_refine``); on every refined pair of the hot scan, on the 7680
    pairs and on time-warped pairs, adaptive >= static (``dtw_band`` on the
    same pairs, row 1); on the warped pairs the card's certificates equal
    the plain sweeps'.  Printed: recall@10 against the static search, and
    per pair set the certified share and how many certified pairs equal
    the static cost.  That count is not checked: the certificate (a
    re-sweep one cell wider) is the reference's heuristic, and it flags
    some pairs whose adaptive cost exceeds the static one, in the JAX
    package alike."""
    import numpy as np
    from repro_torch.core import corridor, dispatch, lb_search
    from repro_torch.index import StreamingIndex
    from repro_torch.kernels import tune
    from repro_torch.kernels.dtw_band.ops import dtw_band
    from repro_torch.kernels.dtw_band.ref import dtw_band_adaptive_ref

    X, Xd, Qd, D = ctx["X"], ctx["Xd"], ctx["Qd"], ctx["D"]
    st = ctx["index_state"]
    cfg = dataclasses.replace(st["cfg"], band="adaptive")
    w = cfg.coarse_window(D)
    width = tune.adaptive_width(D, w)
    check(width == ADAPTIVE_WIDTH, f"adaptive width {width} at L={D}, w={w}")
    seconds = {}
    _build.reset_launches()
    dispatch.reset_stats()
    idx = StreamingIndex.from_parts(cfg, st["coarse"], st["cb"], D,
                                    st["two_level"])
    ids, seconds["insert"] = _timed(torch, lambda: idx.insert(X))
    check(np.array_equal(ids, np.arange(len(X))), "insert ids")
    idx.delete(st["dead"])
    (d, i), seconds["search"] = _timed(torch, lambda: idx.search(
        Qd, n_probe=N_PROBE, topk=TOPK))
    si = st["static_i"]
    check(bool((si >= 0).all()), "static top-10 complete")
    qq = Qd.repeat_interleave(TOPK, dim=0).contiguous()
    xx = Xd[si.reshape(-1).long()].contiguous()
    (lo, hi), seconds["build_corridor"] = _timed(
        torch, lambda: corridor.build_corridor(qq, xx, w))
    d_pairs, seconds["elastic_pairwise_adaptive"] = _timed(
        torch, lambda: dispatch.elastic_pairwise(qq, xx, w, band="adaptive"))
    cert, seconds["certify_adaptive"] = _timed(
        torch, lambda: corridor.certify_adaptive(qq, xx, lo, hi, window=w,
                                                 width=width))
    # the other measures' adaptive sweep on the same pairs and corridors
    other = {}
    for key, measure in ADAPTIVE_MEASURES.items():
        other[key], seconds[f"elastic_pairwise_adaptive_{key}"] = _timed(
            torch, lambda: dispatch.elastic_pairwise(
                qq, xx, w, band="adaptive", measure=measure,
                corridor=(lo, hi)))
    launches = dict(_build.LAUNCHES)
    routes = sorted({r for _, r in dispatch.stats})
    for k in ("dtw_band_adaptive", "lb_refine_adaptive",
              *(f"dtw_band_adaptive[{m}]" for m in ADAPTIVE_MEASURES)):
        check(launches[k] > 0, f"adaptive path launched {k}: {launches}")
    check(launches["lb_refine"] == 0, "the adaptive search never ran the "
          "static cascade")
    check(routes == ["cuda"], f"adaptive path routes {routes}")
    check(tuple(d.shape) == (Qd.shape[0], TOPK)
          and bool(torch.isfinite(d).all()), "adaptive search: finite "
          "(Nq, topk) distances")
    check(not bool(torch.isin(i, torch.from_numpy(st["dead"]).to(
        i.device)).any()), "no deleted id is returned")
    recall = float(np.mean([len(set(a) & set(b)) / TOPK for a, b in zip(
        i.tolist(), si.tolist())]))

    # the 7680 pairs: adaptive >= static (row 1), certified share
    static = dtw_band(qq, xx, w)
    check(bool((d_pairs >= static).all()), "adaptive >= static on the "
          "7680 pairs")
    pairs = {"n": int(qq.shape[0]), "certified": int(cert.sum()),
             "certified_equal": int((d_pairs[cert] == static[cert]).sum()),
             "equal": int((d_pairs == static).sum()),
             "median_ratio": float((d_pairs / static).median()),
             "mean_corridor_width": float(corridor.corridor_width(
                 lo, hi).float().mean())}

    # wdtw, erp and msm: finite, and at or above the static sweep (within the
    # tolerance of erp's border sums, log-depth here and sequential there)
    for key, measure in ADAPTIVE_MEASURES.items():
        st_m = dtw_band(qq, xx, w, measure)
        got = other[key]
        check(bool(torch.isfinite(got).all()), f"adaptive {key} finite")
        check(bool((got >= st_m - (ATOL + RTOL * st_m.abs())).all()),
              f"adaptive {key} >= static on the 7680 pairs")
        pairs[key] = {"equal": int((got == st_m).sum()),
                      "median_ratio": float((got / st_m).median())}
    ctx["adaptive_other"] = other

    # the search again, untimed, with every wave checked
    hot = {"refined": 0, "certified": 0, "certified_equal": 0, "equal": 0}

    def per_wave(args, dw, fw, kw):
        A, B, _, _, _, win = args
        check(kw.get("band") == "adaptive", "the hot scan's band")
        if not bool(fw.any()):
            return
        A, B, dr = A[fw], B[fw], dw[fw]
        static_w = dtw_band(A, B, win)
        check(bool((dr >= static_w).all()), "hot scan: adaptive >= static "
              "on every refined pair")
        c = corridor.certify_adaptive(A, B, *corridor.build_corridor(
            A, B, win), window=win, width=width)
        for key, v in (("refined", int(fw.sum())), ("certified",
                       int(c.sum())), ("certified_equal",
                       int((dr[c] == static_w[c]).sum())),
                       ("equal", int((dr == static_w).sum()))):
            hot[key] += v

    with checked_waves(torch, lb_search, waves.setdefault("adaptive_hot", {}),
                       per_wave):
        d2, i2 = idx.search(Qd, n_probe=N_PROBE, topk=TOPK)
    check(torch.equal(d2, d) and torch.equal(i2, i), "the checked adaptive "
          "search equals the timed one")
    check(waves["adaptive_hot"]["totals"]["waves"]
          == launches["lb_refine_adaptive"], "one lb_refine_adaptive "
          "launch per wave")

    # the certificate on time-warped pairs, the reference tests' data: the
    # card's verdicts are the plain sweeps' (base == one cell wider)
    A, B = _warped_pairs(torch, WARPED_PAIRS, D)
    wl, wh = corridor.build_corridor(A, B, w)
    wa = dispatch.elastic_pairwise(A, B, w, band="adaptive",
                                   corridor=(wl, wh))
    ws = dtw_band(A, B, w)
    wc = corridor.certify_adaptive(A, B, wl, wh, window=w, width=width)
    check(bool((wa >= ws).all()), "warped: adaptive >= static")
    dl, dh = corridor.dilate(wl, wh, D, w)
    plain_wc = (dtw_band_adaptive_ref(A, B, *corridor.clip_to_width(
        wl, wh, width), w, width) == dtw_band_adaptive_ref(
        A, B, dl, dh, w, width + 2))
    check(torch.equal(wc, plain_wc), "warped: the card's certificates are "
          "the plain sweeps'")
    warped = {"n": WARPED_PAIRS, "certified": int(wc.sum()),
              "certified_equal": int((wa[wc] == ws[wc]).sum()),
              "equal": int((wa == ws).sum())}
    emit({"phase": "adaptive_path", "queries": list(Qd.shape),
          "hot_window": w, "width": width, "seconds": seconds,
          "recall_at_10_vs_static": recall, "pairs": pairs,
          "hot_refined": hot, "warped": warped, "launches": launches,
          "routes": routes})
    ctx["adaptive_pairs"] = (qq, xx, lo, hi, w, width)
    return launches


def quant_path(torch, _build, ctx) -> dict:
    """Quantised ADC tables on the main path's codes: ``pq.cdist_sym`` and
    ``dispatch.adc_lookup`` of the 768 queries against the 6144 training
    codes with ``lut_dtype`` int8 and bfloat16, each within the
    reference's bound against float32 (max error under 2% of the float32
    maximum), and the 1-NN predictions they give."""
    from repro_torch.core import dispatch, metrics, pq
    from repro_torch.kernels.pq_adc.ops import lookup_geometry, sym_geometry
    cfg, cb, D = ctx["cfg"], ctx["cb"], ctx["D"]
    q_codes, codes, yd, yq = (ctx["q_codes"], ctx["codes"], ctx["yd"],
                              ctx["yq"])
    luts = pq.query_lut_batch(pq.segment(ctx["Qd"], cfg), cb, cfg.window(D),
                              False, cfg.measure()).contiguous()
    ctx["query_luts"] = luts
    _build.reset_launches()
    dispatch.reset_stats()
    out, seconds = {}, {}
    for dt in ("int8", "bfloat16"):
        out[dt, "sym"], seconds[f"cdist_sym_{dt}"] = _timed(
            torch, lambda: pq.cdist_sym(q_codes, codes, cb.lut, lut_dtype=dt))
        out[dt, "lookup"], seconds[f"adc_lookup_{dt}"] = _timed(
            torch, lambda: dispatch.adc_lookup(codes, luts, lut_dtype=dt))
    launches = dict(_build.LAUNCHES)
    routes = sorted({r for _, r in dispatch.stats})
    check(launches["adc_sym_quant"] == 2 and launches["adc_lookup_quant"] == 2,
          f"quant path launched both quantised kernels: {launches}")
    (Nq, M), N, K = q_codes.shape, codes.shape[0], cb.lut.shape[1]
    check(all(sym_geometry(Nq, N, M, K, size).form == "rows"
              and lookup_geometry(Nq, N, M, K, size).form == "rows"
              for size in (1, 2)),
          "the quant path's scans take the row-staged form")
    check(routes == ["cuda"], f"quant path routes {routes}")
    full = {"sym": pq.cdist_sym(q_codes, codes, cb.lut),
            "lookup": dispatch.adc_lookup(codes, luts)}
    pred_f = yd[torch.argmin(full["sym"], 1)]
    result = {}
    for (dt, form), got in out.items():
        ref = full[form]
        rel = float((got - ref).abs().max() / (ref.abs().max() + 1e-6))
        check(tuple(got.shape) == tuple(ref.shape)
              and bool(torch.isfinite(got).all()), f"{dt} {form} shape")
        check(rel < QUANT_MAX_REL, f"{dt} {form}: max error {rel} of the "
              f"float32 maximum (bound {QUANT_MAX_REL})")
        pred = yd[torch.argmin(got, 1)]
        pred_full = yd[torch.argmin(ref, 1)] if form == "lookup" else pred_f
        result[f"{dt}_{form}"] = {
            "max_err_of_f32_max": rel,
            "accuracy": 1.0 - metrics.error_rate(yq, pred),
            "f32_accuracy": 1.0 - metrics.error_rate(yq, pred_full),
            "agreement_with_f32": float((pred == pred_full).float().mean())}
    emit({"phase": "quant_path", "codes": [list(q_codes.shape),
                                           list(codes.shape)],
          "lut": list(cb.lut.shape), "qluts": list(luts.shape),
          "seconds": seconds, "results": result, "launches": launches,
          "routes": routes})
    return launches


def _live_cells(torch, lo, hi) -> int:
    """DP cells a sweep of clipped corridors computes."""
    return int((hi - lo + 1).clamp(min=0).sum())


def adaptive_kernel_phases(torch, ctx, waves) -> list:
    """Rows 7-8 against their plain versions: ``dtw_band_adaptive`` on the
    7680 zipped pairs (timed beside ``dtw_band``, row 1, on the same
    pairs), ``lb_refine_adaptive`` on the adaptive hot scan's first wave
    and first mixed wave.  Both bit-identical where they refine; the
    flags of row 8 as for ``lb_refine`` (flips only at bound ties)."""
    from repro_torch.core import corridor, measures
    from repro_torch.core.lb import cascade_bound
    from repro_torch.kernels.dtw_band.ops import (adaptive_warp_geometry,
                                                  dtw_band, dtw_band_adaptive,
                                                  launch_dtw_band_adaptive)
    from repro_torch.kernels.dtw_band.ref import dtw_band_adaptive_ref
    from repro_torch.kernels.lb_cascade.ops import (adaptive_variant,
                                                    launch_lb_refine_adaptive,
                                                    lb_refine)
    from repro_torch.kernels.lb_cascade.ref import lb_refine_ref
    launches = ctx["adaptive_launches"]
    rows = []
    qq, xx, lo, hi, w, width = ctx["adaptive_pairs"]
    clo, chi = corridor.clip_to_width(lo, hi, width)
    clo, chi = clo.contiguous(), chi.contiguous()
    n, L = qq.shape
    out = torch.empty(n, dtype=torch.float32, device=qq.device)
    static_ms = _mean_ms(torch, lambda: dtw_band(qq, xx, w), REPS)
    geo = adaptive_warp_geometry(n, L, width, 0)
    check(geo is not None, f"row 7 takes the warp form at width {width}")
    variant = f"warp ({geo[0]} warps a block)"
    got = dtw_band_adaptive(qq, xx, (clo, chi), width, w)
    kernel_row(
        torch, launches, rows, "dtw_band_adaptive",
        {"pairs": [n, L], "window": w, "width": width,
         "static_dtw_band_ms": static_ms},
        lambda: dtw_band_adaptive(qq, xx, (clo, chi), width, w),
        lambda: dtw_band_adaptive_ref(qq, xx, clo, chi, w, width), None,
        n * (2 * L * 4 + 2 * (2 * L - 1) * 4 + 4),
        _live_cells(torch, clo, chi) * DTW_OPS_PER_CELL,
        launch_fn=lambda: (launch_dtw_band_adaptive(
            qq, xx, clo, chi, width, 0, None, out), out)[1], exact=True,
        extra={"design": DESIGNS["dtw_band_adaptive"], "variant": variant,
               "prev_ms": _adaptive_sweep_thread_ms(
                   torch, qq, xx, clo, chi, width, "dtw", got)})
    # wdtw, erp and msm through the same sweep (dtw_band_adaptive[wdtw],
    # [erp], [msm]): bit for bit against the plain version and the thread
    # form on the same pairs
    for key, measure in ADAPTIVE_MEASURES.items():
        spec = measures.resolve(measure)
        kid, param = (measures.kernel_measure_id(spec),
                      measures.kernel_param(spec))
        wt = measures.wdtw_weights(spec, L, qq.device) if key == "wdtw" \
            else None
        name = f"dtw_band_adaptive[{key}]"
        want = dtw_band_adaptive(qq, xx, (clo, chi), width, w, measure)
        got = kernel_row(
            torch, launches, rows, name,
            {"pairs": [n, L], "window": w, "width": width,
             "measure": measure},
            lambda: dtw_band_adaptive(qq, xx, (clo, chi), width, w, measure),
            lambda: dtw_band_adaptive_ref(qq, xx, clo, chi, w, width,
                                          measure), None,
            n * (2 * L * 4 + 2 * (2 * L - 1) * 4 + 4)
            + (L * 4 if key == "wdtw" else 0),
            _live_cells(torch, clo, chi) * MEASURE_OPS_PER_CELL[key]
            + (n * 2 * L * (1 + (L - 1).bit_length()) if key == "erp"
               else 0),
            launch_fn=lambda: (launch_dtw_band_adaptive(
                qq, xx, clo, chi, width, kid, wt, out, param), out)[1],
            exact=True,
            extra={"design": DESIGNS["dtw_band_adaptive"],
                   "variant": variant,
                   "prev_ms": _adaptive_sweep_thread_ms(
                       torch, qq, xx, clo, chi, width, measure, want)})
        check(torch.equal(got, ctx["adaptive_other"][key]),
              f"{name}: the launch equals adaptive_path's "
              "elastic_pairwise(band='adaptive') result")

    log = waves["adaptive_hot"]
    check(log["totals"]["pruned"] > 0, "adaptive hot scan: some wave "
          "pruned pairs at their threshold")
    emit({"phase": "lb_refine_waves", "search": "adaptive_hot",
          **log["totals"],
          "unrefined_max_abs_err": log["unrefined_max_abs_err"][0]})
    mixed = log.get("mixed_filler", log.get("mixed"))
    check(mixed is not None, "adaptive hot scan: a wave both refined and "
          "pruned")
    for which, args in (("first", log["first"]), ("mixed", mixed)):
        A, B, up, lo_e, th, win = args
        n, L = A.shape
        cl, ch = corridor.clip_to_width(*corridor.build_corridor(A, B, win),
                                        width)
        cl, ch = cl.contiguous(), ch.contiguous()
        d, f = lb_refine(A, B, up, lo_e, th, win, corridor=(cl, ch),
                         width=width)
        torch.cuda.synchronize()
        (want_d, want_f), plain_ms = _sync_ms(torch, lambda: lb_refine_ref(
            A, B, up, lo_e, th, win, corridor=(cl, ch), width=width))
        lb = cascade_bound(B, A, up, lo_e)
        flips, near = _flag_flips(torch, f, lb, th,
                                  f"lb_refine_adaptive {which}")
        both = f & want_f
        check(torch.equal(d[both], want_d[both]), f"lb_refine_adaptive "
              f"{which}: refined distances bit-identical")
        agree = ~flips
        max_abs, max_rel, ok = _errors(torch, d[agree], want_d[agree])
        check(ok, f"lb_refine_adaptive {which}: distances agree where "
              "flags agree")
        filler = th == -float("inf")
        n_refined, n_filler = int(f.sum()), int(filler.sum())
        n_pruned = n - n_refined - n_filler
        if which == "mixed":
            check(0 < n_refined < n and n_pruned > 0,
                  "lb_refine_adaptive: the mixed wave refines and prunes")
        d_out = torch.empty_like(d)
        flag = torch.empty(n, dtype=torch.int32, device=A.device)
        ms = _mean_ms(torch, lambda: launch_lb_refine_adaptive(
            A, B, up, lo_e, th, cl, ch, width, d_out, flag), REPS)
        check(torch.equal(flag.bool(), f) and torch.equal(d_out, d),
              f"lb_refine_adaptive {which}: the launch alone equals the "
              "wrapper")
        wrapper_ms = _mean_ms(torch, lambda: lb_refine(
            A, B, up, lo_e, th, win, corridor=(cl, ch), width=width), REPS)
        thread_ms = _adaptive_thread_form_ms(torch, A, B, up, lo_e, th, cl,
                                             ch, width, d, f)
        clamped_ms = _adaptive_clamped_warp_ms(torch, A, B, up, lo_e, th,
                                               cl, ch, width, d, f)
        bound_ms, bound_by = bound(
            n * (16 * L + 12 + 2 * (2 * L - 1) * 4),
            n * 5 * L + _live_cells(torch, cl[f], ch[f]) * DTW_OPS_PER_CELL)
        row = {"name": "lb_refine_adaptive", "route": "cuda",
               "source": SOURCES["lb_refine_adaptive"],
               "replaces": TPU_SITES["lb_refine_adaptive"],
               "launches": launches["lb_refine_adaptive"],
               "max_abs_err": max_abs, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": None,
               "design": DESIGNS["lb_refine_adaptive"],
               "variant": adaptive_variant(width), "prev_ms": thread_ms}
        emit({"phase": "kernel", **row, "wave": f"adaptive_hot {which}",
              "shapes": {"pairs": [n, L], "window": win, "width": width},
              "n_refined": n_refined, "n_pruned": n_pruned,
              "n_filler": n_filler, "flag_ties": int(flips.sum()),
              "near_threshold": int(near.sum()), "wrapper_ms": wrapper_ms,
              "thread_form_ms": thread_ms,
              "clamped_warp_form_ms": clamped_ms,
              "max_rel_err": max_rel, "agrees": ok,
              "in_table": which == "first",
              "tolerance": {"refined": "identical", "rtol": RTOL,
                            "atol": ATOL, "flag_tie_rel": FLAG_TIE_REL}})
        if which == "first":
            rows.append(row)
    return rows


def _adaptive_sweep_thread_ms(torch, A, B, lo, hi, width, measure,
                              want) -> float:
    """``dtw_band_adaptive``'s thread form (the wrapper's choice beyond
    width 256, and row 7's design before the warp form) launched directly
    on the same pairs and corridors: its ms (``REPS`` launches, the launch
    alone; erp's gaps buffer made once, outside), its output equal to
    ``want`` (the warp form's) bit for bit.  Not launches of the path."""
    from repro_torch.core import measures
    from repro_torch.kernels import _build
    from repro_torch.kernels.dtw_band.ops import row_geometry
    spec = measures.resolve(measure)
    n, L = A.shape
    kid = measures.kernel_measure_id(spec)
    wt = (measures.wdtw_weights(spec, L, A.device) if spec.uses_position
          else None)
    threads, blocks, scratch = row_geometry(n, 3 * width, A.device)
    if kid == 2:
        blocks = max(1, min(blocks, (1 << 30) // (8 * L * threads)))
    gaps = (torch.empty(2 * L * threads * blocks, dtype=torch.float32,
                        device=A.device) if kid == 2 else None)
    out = torch.empty(n, dtype=torch.float32, device=A.device)

    def launch():
        _build.check(_build.lib().pq_dtw_band_adaptive(
            A.data_ptr(), B.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            out.data_ptr(), _build.ptr(wt), _build.ptr(scratch),
            _build.ptr(gaps), n, L, width, kid,
            float(measures.kernel_param(spec)), threads, blocks, 0,
            _build.stream(A.device)), "dtw_band_adaptive (thread form)")

    ms = _mean_ms(torch, launch, REPS)
    check(torch.equal(out, want), f"dtw_band_adaptive {measure}: the warp "
          "form equals the thread form bit for bit")
    return ms


def _adaptive_thread_form_ms(torch, A, B, up, lo, th, clo, chi, width, d,
                             f):
    """The thread-per-pair form of ``lb_refine_adaptive`` (the wrapper's
    choice beyond width 256, and its first design at every width) launched
    directly on the same wave: timed for comparison within this run; its
    flags differ from the plain bound's only at bound ties, and its
    refined distances equal the warp form's.  Not a launch of the path."""
    from repro_torch.core.lb import cascade_bound
    from repro_torch.kernels import _build
    from repro_torch.kernels.dtw_band.ops import row_geometry
    n, L = A.shape
    threads, blocks, scratch = row_geometry(n, 3 * width, A.device)
    d_out = torch.empty_like(d)
    flag = torch.empty(n, dtype=torch.int32, device=A.device)

    def launch():
        _build.check(_build.lib().pq_lb_refine_adaptive(
            A.data_ptr(), B.data_ptr(), up.data_ptr(), lo.data_ptr(),
            th.data_ptr(), clo.data_ptr(), chi.data_ptr(), d_out.data_ptr(),
            flag.data_ptr(), _build.ptr(scratch), n, L, width, threads,
            blocks, _build.stream(A.device)),
            "lb_refine_adaptive (thread form)")

    ms = _mean_ms(torch, launch, REPS)
    _flag_flips(torch, flag.bool(), cascade_bound(B, A, up, lo), th,
                "lb_refine_adaptive (thread form)")
    both = flag.bool() & f
    check(torch.equal(d_out[both], d[both]), "lb_refine_adaptive: the "
          "thread form's refined distances equal the warp form's")
    return ms


def _adaptive_clamped_warp_ms(torch, A, B, up, lo, th, clo, chi, width, d,
                              f):
    """The warp form of ``lb_refine_adaptive`` with the clamped sweep for
    every pair (its first design, and its fallback for a corridor that
    breaks the invariants) launched directly on the same wave: timed for
    comparison within this run, and its output equal to the padded
    sweep's bit for bit, flags included.  Not a launch of the path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.lb_cascade.ops import corridor_warp_geometry
    n, L = A.shape
    d_out = torch.empty_like(d)
    flag = torch.empty(n, dtype=torch.int32, device=A.device)

    def launch():
        _build.check(_build.lib().pq_lb_refine_adaptive_warp(
            A.data_ptr(), B.data_ptr(), up.data_ptr(), lo.data_ptr(),
            th.data_ptr(), clo.data_ptr(), chi.data_ptr(), d_out.data_ptr(),
            flag.data_ptr(), n, L, width,
            *corridor_warp_geometry(n, L, width), 0,
            _build.stream(A.device)), "lb_refine_adaptive (clamped warp)")

    ms = _mean_ms(torch, launch, REPS)
    check(torch.equal(flag.bool(), f) and torch.equal(d_out, d),
          "lb_refine_adaptive: the clamped warp sweep equals the padded "
          "sweep bit for bit")
    return ms


def quant_kernel_phases(torch, ctx) -> list:
    """Rows 9-10 against their plain versions (dequantise, then gather) on
    the quant path's tensors, int8 (the table's record) and bfloat16:
    identical outputs.  ``library_ms``: one PyTorch gather-and-sum on the
    dequantised table."""
    from repro_torch.kernels.pq_adc.ops import (
        adc_lookup_quant, adc_sym_cdist_quant, launch_adc_lookup_quant,
        launch_adc_sym_quant, quantize_lut)
    from repro_torch.kernels.pq_adc.ref import (
        adc_lookup_quant_ref, adc_sym_cdist_quant_ref, dequantize)
    launches = ctx["quant_launches"]
    cb, luts = ctx["cb"], ctx["query_luts"]
    q_codes, codes = ctx["q_codes"].contiguous(), ctx["codes"].contiguous()
    (Nq, M), N, K = q_codes.shape, codes.shape[0], cb.lut.shape[1]
    dev = codes.device
    m_idx = torch.arange(M, device=dev)[:, None, None]
    qa, tb = q_codes.long().T[:, :, None], codes.long().T[:, None, :]
    m_row = torch.arange(M, device=dev)[None, :]
    codes_l = codes.long()
    rows = []
    for dt in ("int8", "bfloat16"):
        table = dt == "int8"
        q, sc, zp = quantize_lut(cb.lut, dt)
        scv, zpv = sc.reshape(M).contiguous(), zp.reshape(M).contiguous()
        deq = dequantize(q, sc, zp)
        size = q.element_size()
        sym_out = torch.empty((Nq, N), dtype=torch.float32, device=dev)
        kernel_row(
            torch, launches, rows if table else [], "adc_sym_quant",
            {"codes_a": [Nq, M], "codes_b": [N, M], "lut": [M, K, K],
             "dtype": dt},
            lambda: adc_sym_cdist_quant(q_codes, codes, q, sc, zp),
            lambda: adc_sym_cdist_quant_ref(q_codes, codes, q, sc, zp),
            lambda: torch.sqrt(deq[m_idx, qa, tb].sum(0).clamp_min(0.0)),
            (Nq + N) * M * 4 + M * K * K * size + 2 * M * 4 + Nq * N * 4,
            Nq * N * (3 * M + 2),
            launch_fn=lambda: (launch_adc_sym_quant(
                q_codes, codes, q, scv, zpv, sym_out), sym_out)[1],
            table=table, exact=True, profiled=True,
            extra=_sym_forms(torch, f"adc_sym_quant {dt}", q_codes, codes, q,
                             scv, zpv,
                             adc_sym_cdist_quant(q_codes, codes, q, sc, zp)))
        qq, qs, qz = quantize_lut(luts.reshape(Nq * M, K), dt)
        qq = qq.reshape(Nq, M, K).contiguous()
        qs, qz = qs.reshape(Nq, M, 1), qz.reshape(Nq, M, 1)
        qsv, qzv = qs.reshape(-1).contiguous(), qz.reshape(-1).contiguous()
        qdeq = dequantize(qq, qs, qz)
        lookup_out = torch.empty((Nq, N), dtype=torch.float32, device=dev)
        kernel_row(
            torch, launches, rows if table else [], "adc_lookup_quant",
            {"qlut": [Nq, M, K], "codes": [N, M], "dtype": dt},
            lambda: adc_lookup_quant(codes, qq, qs, qz),
            lambda: adc_lookup_quant_ref(codes, qq, qs, qz),
            lambda: torch.sqrt(qdeq[:, m_row, codes_l].sum(-1).clamp_min(
                0.0)),
            Nq * M * K * size + 2 * Nq * M * 4 + N * M * 4 + Nq * N * 4,
            Nq * N * (3 * M + 2),
            launch_fn=lambda: (launch_adc_lookup_quant(
                codes, qq, qsv, qzv, lookup_out), lookup_out)[1],
            table=table, exact=True, profiled=True,
            extra=_lookup_forms(torch, f"adc_lookup_quant {dt}", codes, qq,
                                qsv, qzv, adc_lookup_quant(codes, qq, qs,
                                                           qz)))
    return rows


# ---------------------------------------------------------------------------
# The full-width DTW baseline and PQ-KV decode serving of the LM stack
# ---------------------------------------------------------------------------

def full_baseline(torch, _build, ctx) -> dict:
    """The reference's benchmark baseline through its entry point, the
    ops wrapper (``benchmarks/dtw_kernel_bench.py`` calls
    ``dtw_band(mode="full")`` beside the default sweep): the adaptive
    path's 7680 pairs at L=512, w=51, both sweeps, equal bit for bit."""
    from repro_torch.kernels.dtw_band.ops import dtw_band
    qq, xx, _, _, w, _ = ctx["adaptive_pairs"]
    seconds = {}
    _build.reset_launches()
    for mode in ("full", "compressed"):
        torch.cuda.synchronize()
        start = time.perf_counter()
        d = dtw_band(qq, xx, w, mode=mode)
        torch.cuda.synchronize()
        seconds[mode] = time.perf_counter() - start
        ctx[f"baseline_{mode}"] = d
    launches = dict(_build.LAUNCHES)
    equal = bool(torch.equal(ctx["baseline_full"], ctx["baseline_compressed"]))
    check(equal, "full-width sweep equals the band-compressed sweep")
    check(launches["dtw_band_full"] == 1 and launches["dtw_band"] == 1,
          f"the baseline path launched both sweeps: {launches}")
    emit({"phase": "full_baseline", "pairs": list(qq.shape), "window": w,
          "seconds": seconds, "identical": equal, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# The paper's evaluation: Table 1 and Fig. 5 through their torch legs
# ---------------------------------------------------------------------------

def table1_path(torch, _build) -> dict:
    """The Table 1 leg's full grid (cbf / trace / gunpoint, 40 series a
    class, L = 192, seeds 0-4) on the card, through its entry point; then
    one (dataset, seed) against the CPU route.  (1) The card's codebooks:
    their LUTs (row 2 at the subspace window for PQDTW) and envelopes
    rebuilt on the CPU from the card's centroids, bit for bit (PQ_ED's
    product within ``RTOL`` of the norms).  (2) The CPU route on the card's
    codebooks: codes, row 2's matrices (cDTW5, cDTW10, full DTW at w = 191;
    row 2 itself against its plain version) and the symmetric PQ matrices
    bit for bit, ED (``ed_close``), SBD and the refined clustering
    distance within ``RTOL``/``ATOL``, equal errors and Rand indices.
    (3) The CPU route's own fit from the same initial centroids:
    centroids within ``ATOL`` (DBA's sums part by ulps), equal codes,
    errors and Rand indices.  Decisions between candidates within
    ``TIE_REL`` are counted, not failed."""
    import numpy as np
    from repro_torch.bench import table1_accuracy as leg
    from repro_torch.core import dispatch, pq
    from repro_torch.data.timeseries import make_dataset
    from repro_torch.kernels.dtw_band.ops import cdist_form
    from repro_torch.kernels.dtw_band.ref import dtw_band_cdist_ref

    g = leg.grid(False)
    out_dir = str(ROOT / "chiprun_out" / "bench")
    _build.reset_launches()
    dispatch.reset_stats()
    torch.cuda.synchronize()
    start = time.perf_counter()
    bench, runs, leg_s = leg.run(quick=False, out_dir=out_dir)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = dict(_build.LAUNCHES)
    routes = sorted({route for _, route in dispatch.stats})
    check(routes == ["cuda"], f"table1 routes {routes}")
    for k in ("dtw_band_cdist", "adc_sym", "dtw_band"):
        check(launches[k] > 0, f"table1_path launched {k}: {launches}")
    check(len(runs) == len(leg.DATASETS) * len(g["seeds"]),
          "the full grid ran")
    cbf_err = [r["err"]["PQDTW"] for r in runs if r["dataset"] == "cbf"]
    check(max(cbf_err) < 0.5, f"PQDTW 1-NN error on cbf {cbf_err}")
    for r in runs:
        for m in leg.MEASURES:
            check(np.isfinite(r["d"][m]).all() and np.isfinite(
                r["dtt"][m]).all(), f"{r['dataset']}/{r['seed']} {m} finite")

    # full DTW at L = 192 is row 2 at w = 191, whose 2w+2 floats a thread
    # fill a 32-thread block's 48 KB exactly: the band row in shared
    # memory (the scratch form starts at w = 192); held against the plain
    # version bit for bit on CBF seed 0's test x train series
    L, n_te = g["length"], 3 * g["n_per_class"]
    w_full = L - 1
    form = cdist_form(w_full, 0, L)
    ds, seed = "cbf", 0
    Xtr, _ = make_dataset(ds, g["n_per_class"], L, seed=seed)
    Xte, _ = make_dataset(ds, g["n_per_class"], L, seed=seed + 100)
    te, tr = torch.from_numpy(Xte), torch.from_numpy(Xtr)
    row2 = dispatch.elastic_cdist(te.cuda(), tr.cuda(), None)
    row2_cpu = dtw_band_cdist_ref(te, tr, w_full)
    row2_equal = bool(torch.equal(row2.cpu(), row2_cpu))
    check(row2_equal, f"row 2 at w = {w_full} ({form} form) equals its "
          "plain version bit for bit")
    # float32 torch.sqrt against the once-rounded root on each device:
    # measures.sqrt_rn takes the card's as it is, so it must be IEEE's
    def root64(x):
        return torch.sqrt(x.double()).float()
    sqrt_off = {"cuda": int((torch.sqrt(row2) != root64(row2)).sum()),
                "cpu": int((torch.sqrt(row2_cpu) != root64(row2_cpu)).sum()),
                "of": row2.numel()}
    check(sqrt_off["cuda"] == 0, f"the card's float32 sqrt is correctly "
          f"rounded: {sqrt_off}")
    card = next(r for r in runs if (r["dataset"], r["seed"]) == (ds, seed))
    tables = _fit_tables(torch, card, L)
    for name, t in tables.items():
        check(t["lut"] and t["envelopes"], f"table1 {ds}/{seed}: {name}'s "
              f"LUT and envelopes rebuilt on the CPU from the card's "
              f"centroids: {t}")

    books = tuple(pq.codebook_to_numpy(b) for b in card["books"])
    t0 = time.perf_counter()
    cpu = leg.one_run(ds, seed, g["n_per_class"], L, "cpu", books=books)
    cpu_s = time.perf_counter() - t0
    same = {}
    for name in ("PQDTW", "PQ_ED"):
        same[f"codes_{name}"] = all(
            torch.equal(a.cpu(), b)
            for a, b in zip(card["codes"][name], cpu["codes"][name]))
    for name in ("DTW", "cDTW5", "cDTW10", "PQ_ED", "SAX"):
        same[name] = bool(np.array_equal(card["d"][name], cpu["d"][name])
                          and np.array_equal(card["dtt"][name],
                                             cpu["dtt"][name]))
    same["PQDTW"] = bool(np.array_equal(card["d"]["PQDTW"],
                                        cpu["d"]["PQDTW"]))
    close = {
        "ED": (leg.ed_close(card["d"]["ED"], cpu["d"]["ED"], Xte, Xtr)
               and leg.ed_close(card["dtt"]["ED"], cpu["dtt"]["ED"], Xte,
                                Xte)),
        "SBD": bool(np.allclose(card["d"]["SBD"], cpu["d"]["SBD"],
                                rtol=RTOL, atol=ATOL)
                    and np.allclose(card["dtt"]["SBD"], cpu["dtt"]["SBD"],
                                    rtol=RTOL, atol=ATOL)),
        "PQDTW_refined": bool(np.allclose(card["dtt"]["PQDTW"],
                                          cpu["dtt"]["PQDTW"], rtol=RTOL,
                                          atol=ATOL)),
    }
    cmp = leg.compare_runs(card, cpu)
    for k, v in {**same, **close}.items():
        check(v, f"table1 {ds}/{seed}: {k}, card against the CPU route")
    check(cmp["faults"] == [], f"table1 {ds}/{seed}: errors and Rand "
          f"indices, card against the CPU route: {cmp}")

    # the CPU route's own fit from the same initial centroids
    t0 = time.perf_counter()
    cpu_fit = leg.one_run(ds, seed, g["n_per_class"], L, "cpu")
    cpu_fit_s = time.perf_counter() - t0
    fit_cmp = leg.compare_runs(card, cpu_fit)
    fit = {"ties": fit_cmp["ties"], "cpu_fit_s": cpu_fit_s}
    for i, name in enumerate(("PQDTW", "PQ_ED")):
        a, b = card["books"][i], cpu_fit["books"][i]
        codes_a = torch.cat([c.cpu().flatten() for c in card["codes"][name]])
        codes_b = torch.cat([c.flatten() for c in cpu_fit["codes"][name]])
        fit[name] = {
            "centroids_max_abs": float((a.centroids.cpu()
                                        - b.centroids).abs().max()),
            "codes_differ": int((codes_a != codes_b).sum()),
            "codes": codes_a.numel()}
    for name in ("PQDTW", "PQ_ED"):
        check(fit[name]["centroids_max_abs"] <= ATOL
              and fit[name]["codes_differ"] == 0,
              f"table1 {ds}/{seed}: {name}, the card's fit against the CPU "
              f"route's: centroids within {ATOL}, equal codes: {fit[name]}")
    check(fit_cmp["faults"] == [], f"table1 {ds}/{seed}: errors and Rand "
          f"indices, the card's fit against the CPU route's: {fit_cmp}")
    emit({"phase": "table1_path", "grid": {
              "datasets": list(leg.DATASETS), "seeds": list(g["seeds"]),
              "n_per_class": g["n_per_class"], "length": L},
          "rows": bench.rows, "seconds": seconds, "leg_s": leg_s,
          "pq_train_s": [r["pq_train_s"] for r in runs],
          "per_run": [{"dataset": r["dataset"], "seed": r["seed"],
                       "err": r["err"], "ri": r["ri"],
                       "seconds": r["seconds"]} for r in runs],
          "launches": launches, "routes": routes,
          "check": {"dataset": ds, "seed": seed, "tables": tables,
                    "identical": same, "close": close, "ties": cmp["ties"],
                    "cpu_route_s": cpu_s, "fit": fit},
          "row2_full": {"window": w_full, "form": form,
                        "equals_plain": row2_equal,
                        "torch_sqrt_differs": sqrt_off},
          "phase_s": time.perf_counter() - start})
    return launches


def _fit_tables(torch, run: dict, D: int) -> dict:
    """Each of a Table 1 run's codebooks against its LUT and envelopes
    rebuilt on the CPU route from its own centroids: the elastic LUT and
    the envelopes bit for bit, the squared-ED LUT within ``RTOL`` of the
    norms plus ``ATOL`` (``sq_close``; a product in another order)."""
    from repro_torch.bench import table1_accuracy as leg
    from repro_torch.core import pq
    out = {}
    cfgs = leg.pq_configs(len(run["ytr"]))
    for name, cfg, cb in zip(("PQDTW", "PQ_ED"), cfgs, run["books"]):
        cpu = pq.codebook_from_centroids(cb.centroids.cpu(), cfg, D)
        env = all(torch.equal(a.cpu(), b) for a, b in zip(cb[2:], cpu[2:]))
        if cfg.is_elastic:
            lut = bool(torch.equal(cb.lut.cpu(), cpu.lut))
        else:
            c = cpu.centroids.numpy()
            lut = all(leg.sq_close(cb.lut[m].cpu().numpy(),
                                   cpu.lut[m].numpy(), c[m], c[m],
                                   RTOL, ATOL) for m in range(len(c)))
        out[name] = {"lut": lut, "envelopes": env}
    return out


def fig5_path(torch, _build) -> dict:
    """The Fig. 5a / 5b / 5c legs at the reference's quick sizes on the
    card, their rows printed; 5a's DTW matrices run row 2, every PQ
    distance row 3, the encodes row 1, and 5c's fused encode row 5.  Every
    row's card outputs are then held against the plain route on the same
    inputs, bit for bit (``_fig5_check``)."""
    from repro_torch.bench import fig5a_scaling, fig5b_params, fig5c_prealign
    out_dir = str(ROOT / "chiprun_out" / "bench")
    suites, total = {}, {}
    phase_start = time.perf_counter()
    for mod in (fig5a_scaling, fig5b_params, fig5c_prealign):
        _build.reset_launches()
        kept = []
        torch.cuda.synchronize()
        start = time.perf_counter()
        b = mod.run(quick=True, out_dir=out_dir, keep=kept)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        suites[b.name] = {"rows": b.rows, "seconds": seconds,
                          "launches": launches,
                          "check": _fig5_check(torch, b.name, kept)}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    check(suites["fig5a_scaling"]["launches"].get("dtw_band_cdist", 0) > 0
          and suites["fig5a_scaling"]["launches"].get("adc_sym", 0) > 0,
          "fig5a ran rows 2 and 3")
    check(suites["fig5c_prealign"]["launches"].get("prealign_encode", 0) > 0,
          "fig5c's fused encode ran row 5")
    emit({"phase": "fig5_path", "quick": True, "suites": suites,
          "launches": total, "phase_s": time.perf_counter() - phase_start})
    return total


def _fig5_check(torch, suite: str, kept: list) -> dict:
    """A Fig. 5 leg's rows (``keep``) against the plain route on the same
    inputs, bit for bit: the codes against ``encode`` on the CPU with the
    card's codebook (5c's fused rows: the plain ``prealign_encode``), 5a's
    DTW matrix against ``dtw_band_cdist_ref`` (row 2), and the symmetric
    PQ matrix against ``adc_sym_cdist_ref`` on the card's codes and LUT
    (row 3)."""
    from repro_torch.core import pq
    from repro_torch.kernels.dtw_band.ref import dtw_band_cdist_ref
    from repro_torch.kernels.pq_adc.ref import adc_sym_cdist_ref
    t0 = time.perf_counter()
    held = {"codes": 0, "dtw": 0, "sym": 0}
    for row in kept:
        what = {k: v for k, v in row.items()
                if isinstance(v, (int, str))}
        X = row["X"].cpu()
        cb = pq.PQCodebook(*(t.cpu() for t in row["cb"]))
        codes = row["codes"].cpu()
        want = pq.encode(X, cb, row["cfg"], device="cpu")
        check(torch.equal(codes, want),
              f"{suite} {what}: the card's codes equal the plain route's")
        held["codes"] += 1
        if "dtw" in row:
            check(torch.equal(row["dtw"].cpu(),
                              dtw_band_cdist_ref(X, X, row["window"])),
                  f"{suite} {what}: row 2 equals its plain version")
            held["dtw"] += 1
        if "sym" in row:
            check(torch.equal(row["sym"].cpu(),
                              adc_sym_cdist_ref(codes, codes, cb.lut)),
                  f"{suite} {what}: row 3 equals its plain version")
            held["sym"] += 1
    return {"rows": len(kept), "held": held,
            "seconds": time.perf_counter() - t0}


def _profile(torch, fn, names: bool = False) -> dict:
    """One call under ``torch.profiler``: its wall time, the device's busy
    time (kernel durations; one stream, so they do not overlap), the idle
    share, and the five kernels with the most device time (``names``:
    also every kernel name's count).  The window is padded by
    ``PROFILE_PAD_S`` on both sides, outside the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
        time.sleep(PROFILE_PAD_S)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    kernel_starts = sorted(e.time_range.start for e in prof.events()
                           if e.device_type == DeviceType.CUDA)
    launch_starts = sorted(e.time_range.start for e in prof.events()
                           if e.device_type == DeviceType.CPU
                           and "LaunchKernel" in e.name)
    offsets = ([(k - c) / 1e3 for k, c in zip(kernel_starts, launch_starts)]
               if len(kernel_starts) == len(launch_starts) else [])
    record = {"wall_ms": wall_ms,
              "launch_to_kernel_ms": min(offsets) if offsets else None,
              "device_busy_ms": busy if by_name else None,
              "idle_share": 1.0 - busy / wall_ms if by_name else None,
              "kernels": sum(n for _, n in by_name.values()),
              "top": [{"name": k[:80], "ms": ms, "count": n}
                      for k, (ms, n) in top]}
    if names:
        record["by_name"] = {k: n for k, (_, n) in by_name.items()}
    return record


def _corr(torch, a, b) -> float:
    return float(torch.corrcoef(torch.stack([a.flatten().double(),
                                             b.flatten().double()]))[0, 1])


def _greedy(torch, logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def lm_path(torch, _build) -> dict:
    """PQ-KV serving of internlm2-1.8b at full width (module docstring).
    Returns the launch counts and the first PQ step's layer-0 tensors for
    the kernel record."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.serve import pqkv
    from repro_torch.serve.cache import init_cache
    from repro_torch.serve.decode import serve_step
    from repro_torch.serve.prefill import prefill

    cfg = get_config(LM_ARCH)
    check(cfg.n_layers == 24 and cfg.d_model == 2048, "full width")
    B, S, n_steps = LM_BATCH, LM_PROMPT, LM_GEN - 1
    pqc = pqkv.PQKVConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, gen)
    cache = init_cache(cfg, B, S + LM_GEN)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    seconds, step_ms = {}, {"exact": [], "pq": []}

    def timed(name, fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        return out

    _build.reset_launches()
    logits, cache = timed("prefill", lambda: prefill(
        params, cfg, cache, {"tokens": prompt}))
    check(bool(torch.isfinite(logits).all()), "prefill logits finite")
    first = _greedy(torch, logits)
    exact_toks, tok, exact_first = [first], first, None
    for g in range(n_steps):
        logits, cache = timed("step", lambda: serve_step(
            params, cfg, cache, tok, S + g))
        step_ms["exact"].append(seconds.pop("step") * 1e3)
        check(bool(torch.isfinite(logits).all()), f"exact step {g} finite")
        if g == 0:
            exact_first = logits.clone()
        tok = _greedy(torch, logits)
        exact_toks.append(tok)
    # the exact decode is over: the PQ cache may take its value tensor
    pq_cache = timed("compress", lambda: pqkv.compress_cache(
        cache, cfg, pqc, pos=S, generator=torch.Generator().manual_seed(1)))

    # every pq_attention_decode call is counted; on the first PQ step each
    # layer's kernel route is held against its plain route
    inner = pqkv.pq_attention_decode
    calls, route_err, captured = [0], [], {}

    def hooked(q, layer_cache, pos, **kw):
        out = inner(q, layer_cache, pos, **kw)
        calls[0] += 1
        if pos == S:
            plain = inner(q, layer_cache, pos, route="plain", **kw)
            diff = (out.float() - plain.float()).abs()
            route_err.append(float(diff.max()))
            check(bool((diff <= PQ_ROUTE_TOL
                        + PQ_ROUTE_TOL * plain.float().abs()).all()),
                  f"pq_attention_decode layer {len(route_err) - 1}: kernel "
                  "route within the tolerance of the plain route")
            if not captured:
                captured.update(q=q.clone(), pos=pos, layer=_clone_layer(
                    torch, pqkv, layer_cache))
                # layer 0 sees the exact decode's input: exact attention
                # over its keys measures what the PQ keys cost
                keys = cache["k"][0, :, :pos + 1].float()
                p = torch.softmax(torch.einsum(
                    "bgrh,bsgh->bgrs", q.float(), keys) * q.shape[-1] ** -0.5,
                    dim=-1)
                exact = torch.einsum("bgrs,bsgh->bgrh", p,
                                     layer_cache.v[:, :pos + 1].float())
                captured["layer0_rel_err"] = float(
                    (out.float() - exact).norm() / exact.norm())
        return out

    pqkv.pq_attention_decode = hooked
    try:
        pq_toks, tok, pq_first = [first], first, None
        for g in range(n_steps):
            logits, pq_cache = timed("step", lambda: pqkv.pq_serve_step(
                params, cfg, pq_cache, tok, S + g, pqc=pqc))
            step_ms["pq"].append(seconds.pop("step") * 1e3)
            check(bool(torch.isfinite(logits).all()), f"PQ step {g} finite")
            if g == 0:
                pq_first = logits.clone()
            tok = _greedy(torch, logits)
            pq_toks.append(tok)
    finally:
        pqkv.pq_attention_decode = inner
    launches = dict(_build.LAUNCHES)
    # one more step of each, profiled: where the device time goes
    pos = S + n_steps
    profiles = {
        "exact": _profile(torch, lambda: serve_step(params, cfg, cache,
                                                    exact_toks[-1], pos)),
        "pq": _profile(torch, lambda: pqkv.pq_serve_step(
            params, cfg, pq_cache, pq_toks[-1], pos, pqc=pqc))}
    check(len(route_err) == cfg.n_layers, "every layer checked on step 1")
    check(launches["pq_attn"] == cfg.n_layers * n_steps == calls[0],
          f"pq_attn launched in every layer of every PQ step: {launches}")
    check(all(v == 0 for k, v in launches.items() if k != "pq_attn"),
          f"no other kernel on the LM path: {launches}")

    # exact decode's first step against one forward pass over prompt +
    # token.  cuBLAS sums an 8-row product in another order than a
    # 16392-row one, so some bf16 products differ by an ulp, and 24 random
    # layers amplify that (on the CPU the two are bit-identical): the check
    # is the logits' correlation, the max difference is printed.
    full = torch.cat([prompt, first], dim=1)
    fwd = lm.forward(params, cfg, {"tokens": full}, return_hidden=True)
    fwd_last = lm.logits_from_hidden(params, cfg, fwd[:, -1:])
    del fwd
    fwd_err = float((fwd_last - exact_first).abs().max())
    fwd_corr = _corr(torch, fwd_last, exact_first)
    fwd_top1 = float((_greedy(torch, fwd_last)
                      == _greedy(torch, exact_first)).float().mean())
    check(fwd_corr >= LOGIT_CORR, f"decode step agrees with forward "
          f"(logit correlation {fwd_corr})")

    exact_t, pq_t = torch.cat(exact_toks, 1), torch.cat(pq_toks, 1)
    corr = _corr(torch, pq_first, exact_first)
    ms = {k: sum(v[1:]) / len(v[1:]) for k, v in step_ms.items()}
    mem = pqkv.pqkv_memory(cfg, pqc, B, S + LM_GEN)
    emit({"phase": "lm_path", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "batch": B, "prompt": S,
          "generated": LM_GEN, "pqkv": dataclasses.asdict(pqc),
          "seconds": seconds, "decode_ms_per_step": ms,
          "first_step_ms": {k: v[0] for k, v in step_ms.items()},
          "decode_tok_per_s": {k: B * 1e3 / v for k, v in ms.items()},
          "pqkv_memory": mem, "greedy_agreement":
              float((pq_t == exact_t).float().mean()),
          "first_step_logit_corr": corr,
          "decode_vs_forward": {"max_abs_err": fwd_err, "corr": fwd_corr,
                                "top1_agreement": fwd_top1},
          "route_max_abs_err": max(route_err),
          "layer0_pq_attention_rel_err": captured["layer0_rel_err"],
          "profiled_step": profiles,
          "routes": {"pq_attention_decode_calls": calls[0],
                     "pq_attn_launches": launches["pq_attn"]},
          "launches": launches, "tolerance": {
              "route": {"rtol": PQ_ROUTE_TOL, "atol": PQ_ROUTE_TOL},
              "decode_vs_forward": {"corr": LOGIT_CORR}},
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return dict(launches=launches, **captured)


def _clone_layer(torch, pqkv, layer_cache):
    """A copy of one layer's PQ cache (its absent fields stay None)."""
    return pqkv.PQKVCache(*(None if t is None else t.clone()
                            for t in layer_cache))


def _uncounted(_build, fn):
    """``fn()`` with the launch counters restored after it: launches made
    to hold a kernel against its plain version inside a path's run do not
    count as the path's."""
    saved = dict(_build.LAUNCHES)
    try:
        return fn()
    finally:
        _build.LAUNCHES.update(saved)


def _forward_chunk(n: int) -> int:
    """A query chunk for ``forward`` over ``n`` positions: the largest
    divisor of ``n`` up to 512 if it is at least 64 (gemma2's 4609 = 11 x
    419), else ``n`` (one chunk)."""
    best = max(d for d in range(1, min(n, 512) + 1) if n % d == 0)
    return best if best >= 64 else n


def lm_family_path(torch, _build, phase, arch, B, S, n_gen, n_patches,
                   layers) -> dict:
    """One family's serving at full width (module docstring): seeded
    random weights, prefill of ``B`` prompts of ``S`` tokens (the first
    ``n_patches`` positions patch embeddings), ``n_gen - 1`` exact greedy
    steps, ``compress_cache`` with ``PQKVConfig()`` and the same steps
    with the PQ cache.  ``layers`` cuts the depth (listed as ``reduced``).
    Returns the path's launch counts and, for a local/global model, its
    first local layer's tensors at the first PQ step."""
    import gc
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.pq_attn.ops import pq_attn
    from repro_torch.kernels.pq_attn.ref import pq_attn_lut_ref
    from repro_torch.models import lm
    from repro_torch.serve import pqkv
    from repro_torch.serve.cache import init_cache
    from repro_torch.serve.decode import serve_step
    from repro_torch.serve.prefill import prefill

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                         n_layers=layers)
    L, n_steps = cfg.n_layers, n_gen - 1
    pqc = pqkv.PQKVConfig()
    W = pqc.recent_window
    seconds, step_ms = {}, {"exact": [], "pq": []}

    def timed(name, fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = timed("init", lambda: lm.init_params(cfg, gen))
    cache = init_cache(cfg, B, S + n_gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    if n_patches:
        batch["patches"] = torch.randn((B, n_patches, cfg.d_model),
                                       generator=gen, device="cuda")
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30

    # the experts' routing at prefill, layer by layer
    routing, inner_moe = [], lm.moe

    def moe_hook(p, cfg_, x, *a, **kw):
        st = {}
        out = inner_moe(p, cfg_, x, *a, stats=st, **kw)
        routing.append(st)
        return out

    _build.reset_launches()
    lm.moe = moe_hook
    try:
        logits, cache = timed("prefill", lambda: prefill(params, cfg, cache,
                                                         batch))
    finally:
        lm.moe = inner_moe
    check(bool(torch.isfinite(logits).all()), f"{phase}: prefill finite")
    first = _greedy(torch, logits)
    exact_toks, tok, exact_first = [first], first, None
    for g in range(n_steps):
        logits, cache = timed("step", lambda: serve_step(
            params, cfg, cache, tok, S + g))
        step_ms["exact"].append(seconds.pop("step") * 1e3)
        check(bool(torch.isfinite(logits).all()),
              f"{phase}: exact step {g} finite")
        if g == 0:
            exact_first = logits.clone()
        tok = _greedy(torch, logits)
        exact_toks.append(tok)
    # the exact decode is over: the PQ cache takes its value tensor
    pq_cache = timed("compress", lambda: pqkv.compress_cache(
        cache, cfg, pqc, pos=S, generator=torch.Generator().manual_seed(1)))
    del cache

    inner = pqkv.pq_attention_decode
    calls, windowed, route_err, attn_err, captured = [0], [0], [], [], {}

    def hooked(q, layer_cache, pos, **kw):
        out = inner(q, layer_cache, pos, **kw)
        calls[0] += 1
        window = kw.get("window", 0)
        start, stop = pqkv.tail_range(pos, W, window)
        windowed[0] += start > 0
        if pos == S:
            plain = inner(q, layer_cache, pos, route="plain", **kw)
            diff = (out.float() - plain.float()).abs()
            route_err.append(float(diff.max()))
            check(bool((diff <= PQ_ROUTE_TOL
                        + PQ_ROUTE_TOL * plain.float().abs()).all()),
                  f"{phase} layer {len(route_err) - 1}: kernel route within "
                  "the tolerance of the plain route")
            Bq, G, R, hd = q.shape
            M, K = layer_cache.k_books.shape[1:3]
            qlut = pqkv._query_table(q, layer_cache.k_books).reshape(
                Bq, G * R, M, K)
            got = _uncounted(_build, lambda: pq_attn(
                qlut, layer_cache.k_codes, layer_cache.v, stop, hd ** -0.5,
                start))
            want = pq_attn_lut_ref(qlut, layer_cache.k_codes, layer_cache.v,
                                   stop, hd ** -0.5, start)
            attn_err.append(max(float((a - b).abs().max())
                                for a, b in zip(got, want)))
            check(all(bool(torch.allclose(a, b, rtol=PQ_ATTN_TOL,
                                          atol=PQ_ATTN_TOL))
                      for a, b in zip(got, want)),
                  f"{phase} layer {len(attn_err) - 1}: pq_attn over "
                  f"[{start}, {stop}) within PQ_ATTN_TOL of its plain version")
            if 0 < start < stop and "window" not in captured:
                captured.update(window=window, q=q.clone(), pos=pos,
                                layer=_clone_layer(torch, pqkv, layer_cache))
        return out

    pqkv.pq_attention_decode = hooked
    try:
        pq_toks, tok, pq_first = [first], first, None
        for g in range(n_steps):
            logits, pq_cache = timed("step", lambda: pqkv.pq_serve_step(
                params, cfg, pq_cache, tok, S + g, pqc=pqc))
            step_ms["pq"].append(seconds.pop("step") * 1e3)
            check(bool(torch.isfinite(logits).all()),
                  f"{phase}: PQ step {g} finite")
            if g == 0:
                pq_first = logits.clone()
            tok = _greedy(torch, logits)
            pq_toks.append(tok)
    finally:
        pqkv.pq_attention_decode = inner
    launches = dict(_build.LAUNCHES)
    want_windowed = sum(pqkv.tail_range(S + g, W, lm.layer_window(cfg, i))[0]
                        > 0 for g in range(n_steps) for i in range(L))
    check(len(route_err) == len(attn_err) == L,
          f"{phase}: every layer checked on the first PQ step")
    check(launches["pq_attn"] == L * n_steps == calls[0],
          f"{phase}: pq_attn launched in every layer of every PQ step: "
          f"{launches}")
    check(launches["pq_attn[window]"] == windowed[0] == want_windowed,
          f"{phase}: {want_windowed} launches with a window start: "
          f"{launches}")
    check(all(v == 0 for k, v in launches.items()
              if k not in ("pq_attn", "pq_attn[window]")),
          f"{phase}: no other kernel on the LM path: {launches}")

    # the exact decode's first step against one forward pass over prompt +
    # token (logit correlation, as lm_path: cuBLAS sums by shape)
    fwd_batch = dict(batch, tokens=torch.cat([batch["tokens"], first], 1))

    def forward_last():
        h = lm.forward(params, cfg, fwd_batch, q_chunk=_forward_chunk(S + 1),
                       return_hidden=True)[:, -1:]
        return lm.logits_from_hidden(params, cfg, h)

    fwd_last = timed("forward_check", forward_last)
    fwd_corr = _corr(torch, fwd_last, exact_first)
    fwd_top1 = float((_greedy(torch, fwd_last)
                      == _greedy(torch, exact_first)).float().mean())
    vs_forward = {"max_abs_err": float((fwd_last - exact_first).abs().max()),
                  "corr": fwd_corr, "top1_agreement": fwd_top1}
    if cfg.family == "moe":
        # Capacity drops depend on the batch's other tokens: a decode step
        # (T = B, nothing dropped) is not forward's last position where
        # capacity binds, in the reference too.  And the router's logits
        # are bf16: products of other shapes round them an ulp apart now
        # and then, and the k-th and (k+1)-th expert trade places.  So the
        # step is held against forward with a capacity no expert can fill
        # and every token on the experts it took in the prefill and the
        # step that built the cache.
        taken = {"prefill": [], "step": []}
        where = ["prefill"]

        def no_drop(p, cfg_, x, *a, **kw):
            st = {}
            pinned = None
            if where[0] == "forward":
                layer = len(taken["forward"])
                pinned = torch.cat([taken["prefill"][layer],
                                    taken["step"][layer]], dim=1)
            out = inner_moe(p, cfg_, x, 2.0 * cfg_.n_experts
                            / cfg_.n_active_experts, stats=st,
                            routing=pinned)
            taken[where[0]].append(st["top_i"].reshape(*x.shape[:2], -1))
            return out

        lm.moe = no_drop
        try:
            cache2 = init_cache(cfg, B, S + 1)
            prefill(params, cfg, cache2, batch)
            where[0] = "step"
            step_nd = serve_step(params, cfg, cache2, first, S)[0]
            del cache2
            where[0] = "forward"
            taken["forward"] = []
            fwd_nd = forward_last()
        finally:
            lm.moe = inner_moe
        corr_nd = _corr(torch, fwd_nd, step_nd)
        vs_forward["pinned_routing_no_drop"] = {
            "max_abs_err": float((fwd_nd - step_nd).abs().max()),
            "corr": corr_nd, "top1_agreement": float(
                (_greedy(torch, fwd_nd) == _greedy(torch, step_nd))
                .float().mean())}
        check(corr_nd >= LOGIT_CORR, f"{phase}: decode step agrees with "
              f"forward on the same experts without drops: {vs_forward}")
    else:
        check(fwd_corr >= LOGIT_CORR, f"{phase}: decode step agrees with "
              f"forward (logit correlation {fwd_corr})")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    exact_t, pq_t = torch.cat(exact_toks, 1), torch.cat(pq_toks, 1)
    ms = {k: sum(v[1:]) / len(v[1:]) for k, v in step_ms.items()}
    record = {
        "phase": phase, "arch": cfg.name, "family": cfg.family,
        "layers": L, "d_model": cfg.d_model, "batch": B, "prompt": S,
        "patches": n_patches, "generated": n_gen,
        "reduced": ([] if layers is None else
                    [f"n_layers {full.n_layers} -> {layers}"]),
        "pqkv": dataclasses.asdict(pqc), "seconds": seconds,
        "decode_ms_per_step": ms,
        "first_step_ms": {k: v[0] for k, v in step_ms.items()},
        "decode_tok_per_s": {k: B * 1e3 / v for k, v in ms.items()},
        "pqkv_memory": pqkv.pqkv_memory(cfg, pqc, B, S + n_gen),
        "greedy_agreement": float((pq_t == exact_t).float().mean()),
        "first_step_logit_corr": _corr(torch, pq_first, exact_first),
        "decode_vs_forward": vs_forward,
        "route_max_abs_err": max(route_err),
        "pq_attn_max_abs_err": max(attn_err),
        "routes": {"pq_attention_decode_calls": calls[0],
                   "pq_attn_launches": launches["pq_attn"],
                   "window_start_launches": launches["pq_attn[window]"]},
        "launches": launches, "weights_gib": weights_gib,
        "peak_mem_gib": peak_gib, "tolerance": {
            "route": {"rtol": PQ_ROUTE_TOL, "atol": PQ_ROUTE_TOL},
            "pq_attn": {"rtol": PQ_ATTN_TOL, "atol": PQ_ATTN_TOL},
            "decode_vs_forward": {"corr": LOGIT_CORR}}}
    if routing:
        routed = torch.stack([st["routed"] for st in routing])   # (L, E)
        record["moe_prefill"] = {
            "tokens": B * S, "capacity": int(routing[0]["tok_ec"].shape[1]),
            "routed_per_expert": routed.sum(0).tolist(),
            "dropped_per_layer": [st["dropped"] for st in routing],
            "dropped": sum(st["dropped"] for st in routing)}
        check(len(routing) == L and all(
            int(r.sum()) == B * S * cfg.n_active_experts for r in routed),
            f"{phase}: every layer routed k experts a token at prefill")
    del params, pq_cache, fwd_batch, batch
    gc.collect()
    torch.cuda.empty_cache()
    record["small_reference"] = small_family_reference(torch, arch,
                                                       n_patches > 0)
    emit(record)
    return dict(launches=launches, **captured)


def profile_sequential_steps(torch) -> dict:
    """One decode step of each ``LM_SEQUENTIAL_PATHS`` family under
    ``torch.profiler``, in a child process of its own
    (``sequential_profiles_child``): after a million or more eager
    launches a profiler session of this process may lose its first kernel
    records (ROADMAP queue 3), and by now this process has launched
    millions.  The step is the phase's last (position ``S + n_gen - 1``)
    on a fresh cache of the phase's shape, so the same kernels at the same
    shapes run on zero states and keys.  Profiled twice after a warm-up
    call: the two sessions' kernel counts must agree; where they do not,
    the kernel names whose counts differ are printed."""
    out = ROOT / "chiprun_out" / "seq_profiles.json"
    log = ROOT / "chiprun_out" / "seq_profiles.log"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    _free(torch)
    with open(log, "w") as f:
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.sequential_profiles_child(sys.argv[1]))",
             str(out)], cwd=str(ROOT), stdout=f, stderr=subprocess.STDOUT,
            timeout=SEQ_PROFILE_TIMEOUT_S)
    check(proc.returncode == 0 and out.exists(), "the decode-step profiles' "
          f"child process failed: {log.read_text()[-3000:]}")
    raw = json.loads(out.read_text())
    result = {}
    for phase, *_ in LM_SEQUENTIAL_PATHS:
        runs = raw[phase]
        counts = [r["kernels"] for r in runs]
        names = [r.pop("by_name") for r in runs]
        differ = {k: [n.get(k, 0) for n in names]
                  for k in sorted(set(names[0]) | set(names[1]))
                  if names[0].get(k, 0) != names[1].get(k, 0)}
        check(counts[0] == counts[1] > 0, f"{phase}: a profiled decode "
              f"step keeps every kernel record: {counts}, kernels whose "
              f"counts differ: {differ}")
        result[phase] = dict(runs[1], kernels_both_sessions=counts,
                             taken="child process, fresh cache")
    return result


def sequential_profiles_child(out: str) -> int:
    """``profile_sequential_steps``'s child: each family's decode step
    once as a warm-up, then in two profiler sessions; the sessions'
    records (with their kernel counts by name) written to ``out`` as
    JSON."""
    import gc
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec, lm
    from repro_torch.serve.cache import init_cache
    from repro_torch.serve.decode import prefill_cache_encdec, serve_step

    result = {}
    for phase, arch, B, S, n_gen in LM_SEQUENTIAL_PATHS:
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        init = (encdec.init_params_encdec if cfg.family == "encdec"
                else lm.init_params)
        params = init(cfg, gen)
        cache = init_cache(cfg, B, S + n_gen)
        if cfg.family == "encdec":
            prefill_cache_encdec(params, cfg, cache, torch.randn(
                (B, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
                device="cuda"))
        tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")

        def step():
            serve_step(params, cfg, cache, tok, S + n_gen - 1)

        step()
        result[phase] = [_profile(torch, step, names=True)
                         for _ in range(2)]
        del params, cache
        gc.collect()
        torch.cuda.empty_cache()
    Path(out).write_text(json.dumps(result))
    return 0


def _ssd_state_witness(torch, params, cfg, prompt, ssd_after, slot_like
                       ) -> dict:
    """Where the SSD states the token-by-token prefill left
    (``ssd_after``, every layer) part from the full-sequence pass.
    ``decode_input_layer0``: layer 0's ``ssd_forward(return_state=True)``
    on the input the decode gave that layer (the embedding; for the
    hybrid the shared block run through ``attention_decode`` one token at
    a time into a KV slot shaped as ``slot_like``), norm-wise relative:
    the chunked scan against the recurrence alone.  For the hybrid also
    that block's bf16 output against the full-sequence block's (share of
    elements that differ, the largest difference in bf16 ulps).
    ``forward_input_by_layer``: each layer's state on ``forward``'s own
    input, layer by layer (the loop is ``lm.forward``'s; its last hidden
    states must equal ``forward``'s)."""
    from repro_torch.models import layers, lm, ssm
    from repro_torch.serve.decode import decode_cos_sin

    B, S = prompt.shape
    hybrid = cfg.family == "hybrid"
    x = lm.embed_tokens(params, cfg, prompt)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(
        B, S)
    cs = layers.rotary(pos, cfg.head_dim_, cfg.rope_theta) if hybrid else None

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    def shared_full(h):
        return lm.block_apply(params.shared_attn, cfg, h,
                              lambda ap, xn: layers.attention(
                                  ap, cfg, xn, pos, cos_sin=cs))

    def layer0_state(h):
        blk = params.blocks[0]
        return ssm.ssd_forward(blk.ssm, cfg,
                               layers.rms_norm(h, blk.ln, cfg.norm_eps),
                               return_state=True)[1]

    out = {}
    x0 = x
    if hybrid:
        k, v = torch.zeros_like(slot_like), torch.zeros_like(slot_like)
        rows = []
        for p in range(S):
            cs_p = decode_cos_sin(cfg, B, p, x.device)
            rows.append(lm.block_apply(
                params.shared_attn, cfg, x[:, p:p + 1],
                lambda ap, xn: layers.attention_decode(
                    ap, cfg, xn, k, v, p, cos_sin=cs_p)))
        x0 = torch.cat(rows, 1)
        a, b = x0.float(), shared_full(x).float()
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(a.abs(), b.abs()).clamp_min(1e-30))) - 7)
        out["shared_block_decode_vs_full"] = {
            "differing_share": float((a != b).float().mean()),
            "max_ulps": float(((a - b).abs() / ulp).max())}
        del k, v, rows, a, b
    out["decode_input_layer0"] = rel(layer0_state(x0), ssd_after[0])
    by_layer = []
    for i, blk in enumerate(params.blocks):
        if lm.shared_slot(cfg, i) is not None:
            x = shared_full(x)
        y, state = ssm.ssd_forward(
            blk.ssm, cfg, layers.rms_norm(x, blk.ln, cfg.norm_eps),
            return_state=True)
        by_layer.append(rel(state, ssd_after[i]))
        x = x + y
    out["forward_input_by_layer"] = by_layer
    out["loop_equals_forward"] = bool(torch.equal(
        x, lm.forward(params, cfg, {"tokens": prompt}, return_hidden=True)))
    return out


def lm_sequential_path(torch, _build, phase, arch, B, S, n_gen,
                       profiled) -> None:
    """One family served token by token at full width and depth (module
    docstring): the launcher's path, ``serve_step`` over the prompt one
    token at a time (encdec after ``prefill_cache_encdec``), then ``n_gen
    - 1`` greedy steps.  ``profiled``: the step
    :func:`profile_sequential_steps` took for this phase."""
    import gc
    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec, layers, lm
    from repro_torch.serve.cache import init_cache
    from repro_torch.serve.decode import prefill_cache_encdec, serve_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30   # earlier phases'
    cfg = get_config(arch)
    is_encdec = cfg.family == "encdec"
    n_steps = n_gen - 1
    seconds, step_ms = {}, []

    def timed(name, fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    init = encdec.init_params_encdec if is_encdec else lm.init_params
    params = timed("init", lambda: init(cfg, gen))
    weights_gib = _tree_bytes(torch, params) / 2 ** 30
    cache = init_cache(cfg, B, S + n_gen)
    cache_gib = sum(t.numel() * t.element_size()
                    for t in cache.values()) / 2 ** 30
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    frames = (torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                          generator=gen, device="cuda")
              if is_encdec else None)

    _build.reset_launches()
    if is_encdec:
        timed("encode", lambda: prefill_cache_encdec(params, cfg, cache,
                                                     frames))

    def prefill():
        logits = None
        for p in range(S):
            logits, _ = serve_step(params, cfg, cache, prompt[:, p:p + 1], p)
        return logits

    last = timed("prefill", prefill)
    check(bool(torch.isfinite(last).all()), f"{phase}: prefill finite")
    ssd_after = cache["ssd"].clone() if "ssd" in cache else None
    tok = _greedy(torch, last)
    toks = [tok]
    for g in range(n_steps):
        logits, _ = timed("step", lambda: serve_step(params, cfg, cache, tok,
                                                     S + g))
        step_ms.append(seconds.pop("step") * 1e3)
        check(bool(torch.isfinite(logits).all()), f"{phase}: step {g} finite")
        tok = _greedy(torch, logits)
        toks.append(tok)
    launches = dict(_build.LAUNCHES)
    check(not any(launches.values()),
          f"{phase}: no kernel of the port on this path: {launches}")
    witness = (_ssd_state_witness(
        torch, params, cfg, prompt, ssd_after,
        cache["attn_k"][0] if "attn_k" in cache else None)
        if ssd_after is not None else None)
    del cache, ssd_after

    # the last prefill step against one full-sequence pass over the prompt
    def forward_last():
        if is_encdec:
            h = encdec.forward_encdec(params, cfg, {"frames": frames,
                                                    "tokens": prompt},
                                      return_hidden=True)
        else:
            h = lm.forward(params, cfg, {"tokens": prompt},
                           return_hidden=True)
        return lm.logits_from_hidden(params, cfg, h[:, -1:])

    fwd_last = timed("forward_check", forward_last)
    corr = _corr(torch, fwd_last, last)
    vs_forward = {"max_abs_err": float((fwd_last - last).abs().max()),
                  "corr": corr, "top1_agreement": float(
                      (_greedy(torch, fwd_last) == _greedy(torch, last))
                      .float().mean())}
    check(corr >= LOGIT_CORR, f"{phase}: last prefill step agrees with "
          f"forward: {vs_forward}")
    if not is_encdec:
        # the model's own sensitivity: forward with SSD chunks of 64
        # against 128 (equal up to float32 rounding), printed only
        h64 = lm.forward(params, cfg, {"tokens": prompt}, ssm_chunk=64,
                         return_hidden=True)
        vs_forward["forward_chunk64_vs_128_corr"] = _corr(
            torch, lm.logits_from_hidden(params, cfg, h64[:, -1:]), fwd_last)
        del h64
    record = {
        "phase": phase, "arch": cfg.name, "family": cfg.family,
        "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
        "d_model": cfg.d_model, "batch": B, "prompt": S,
        "frames": cfg.n_frontend_tokens if is_encdec else 0,
        "generated": n_gen, "reduced": [], "seconds": seconds,
        "prefill_tok_per_s": B * S / seconds["prefill"],
        "decode_ms_per_step": sum(step_ms[1:]) / len(step_ms[1:]),
        "first_step_ms": step_ms[0],
        "decode_tok_per_s": B * 1e3 / (sum(step_ms[1:]) / len(step_ms[1:])),
        "weights_gib": weights_gib, "cache_gib": cache_gib,
        "resident_gib_before": base_gib,
        "prefill_vs_forward": vs_forward, "profiled_step": profiled,
        "launches": launches,
        "sample_tokens": torch.cat(toks, 1)[0, :8].tolist()}
    if witness is not None:
        record["ssd_state"] = witness
        tol = SSD_STATE_RTOL
        check(witness["loop_equals_forward"], f"{phase}: the witness's "
              "layer loop is forward's")
        check(witness["decode_input_layer0"] <= tol["decode_input"],
              f"{phase}: layer 0's SSD state after the prefill equals "
              f"ssd_forward's on the decode's input within "
              f"{tol['decode_input']}: {witness['decode_input_layer0']}")
        check(witness["forward_input_by_layer"][0] <= tol["forward_input"],
              f"{phase}: layer 0's SSD state on forward's input within "
              f"{tol['forward_input']}: "
              f"{witness['forward_input_by_layer'][0]}")
        # the projections' float32 product against float64
        blk = params.blocks[0]
        xn = layers.rms_norm(lm.embed_tokens(params, cfg, prompt[:, :64]),
                             blk.ln, cfg.norm_eps)
        got = layers._dot_f32(xn, blk.ssm.wx).double()
        want = xn.double() @ blk.ssm.wx.double()
        dot_rel = float(((got - want).abs().max() / want.abs().max()))
        record["dot_f32"] = {"max_rel_err_vs_f64": dot_rel}
        check(dot_rel <= DOT_F32_RTOL, f"{phase}: the SSM projections keep "
              f"float32 sums: {record['dot_f32']}")
    record["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, frames, prompt
    gc.collect()
    torch.cuda.empty_cache()
    record["small_reference"] = small_sequential_reference(torch, arch)
    record["tolerance"] = {"prefill_vs_forward": {"corr": LOGIT_CORR},
                           "layer0_ssd_state": SSD_STATE_RTOL,
                           "dot_f32": {"rel": DOT_F32_RTOL},
                           "small_reference": {"atol": LOGIT_ATOL}}
    record["nvidia_smi"] = nvidia_smi_line()
    emit(record)


# ---------------------------------------------------------------------------
# Training (after the serving paths; no profiler session)
# ---------------------------------------------------------------------------

def _free(torch) -> float:
    """Free what earlier phases left, reset the peak; the GiB still held."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2 ** 30


def _train_flops(cfg, params, B: int, S: int) -> dict:
    """Model FLOPs of one training step: 6 x (each matrix's parameters x
    the tokens it multiplies: routed experts at k/E of the tokens, the
    hybrid's shared block once a group, the LM head; not the embedding
    gather, the depthwise convolutions or the SSD scan), plus 3 x the
    attention's score and value products (4 B Sq Sk H hd a layer, the
    whole score block, as the port computes it)."""
    from repro_torch import _tree
    T = B * S
    Sf = cfg.n_frontend_tokens
    hhd = cfg.n_heads * cfg.head_dim_
    n_groups = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    tied = getattr(params, "lm_head", None) is None
    matmul = 0
    for path, leaf in _tree.leaves_with_paths(params):
        name = _tree.path_name(path)
        if leaf.dim() < 2 or "conv_" in name:
            continue
        if path[0] == "embed":
            tokens = T if tied else 0
        elif path[0] in ("frame_proj", "enc_blocks") or (
                path[0] == "dec_blocks" and path[2] == "cross_attn"
                and path[3] in ("wk", "wv")):
            tokens = B * Sf
        elif path[0] == "patch_proj":
            tokens = B * Sf
        elif path[0] == "shared_attn":
            tokens = T * n_groups
        elif "moe" in path and path[-1] in ("we_gate", "we_up", "we_down"):
            tokens = T * cfg.n_active_experts / cfg.n_experts
        else:
            tokens = T
        matmul += leaf.numel() * tokens
    if cfg.family == "encdec":
        attn = (cfg.n_enc_layers * 4 * B * Sf * Sf * hhd
                + cfg.n_layers * 4 * B * (S * S + S * Sf) * hhd)
    elif cfg.family == "hybrid":
        attn = n_groups * 4 * B * S * S * hhd
    elif cfg.family == "ssm":
        attn = 0
    else:
        attn = cfg.n_layers * 4 * B * S * S * hhd
    return {"matmul_param_tokens": matmul, "attention_fwd": attn,
            "model_flops": 6 * matmul + 3 * attn}


def _train_block_check(torch, params, cfg, tokens) -> dict:
    """Layer 0 of ``params`` (cast to bf16 as the train step casts it) on
    its real input, the embedding of ``tokens (1, S)``, forward and
    backward against a seeded bf16 cotangent, on the card and on the CPU
    route: the input's gradient and each weight's within
    ``BLOCK_GRAD_RTOL`` of the CPU's in relative norm."""
    from repro_torch import _tree
    from repro_torch.models import layers, lm
    from repro_torch.train.step import bf16_cast
    blk = bf16_cast({"blocks": (params.blocks[0],)})["blocks"][0]
    x0 = lm.embed_tokens(params, cfg, tokens).detach()
    S = tokens.shape[1]
    g = torch.Generator(device="cuda").manual_seed(5)
    ct = torch.randn(x0.shape, generator=g, device="cuda").bfloat16()
    grads, seconds = {}, {}
    for dev in ("cuda", "cpu"):
        b = _tree.tree_map(lambda t: t.detach().to(dev).requires_grad_(), blk)
        x = x0.detach().to(dev).requires_grad_()
        start = time.perf_counter()
        if cfg.family in ("ssm", "hybrid"):
            y = lm.ssm_block_apply(b, cfg, x)
        else:
            pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
            cos_sin = layers.rotary(pos, cfg.head_dim_, cfg.rope_theta)
            y = lm.block_apply(b, cfg, x, lambda p, xn: layers.attention(
                p, cfg, xn, pos, window=lm.layer_window(cfg, 0),
                q_chunk=min(512, S), cos_sin=cos_sin))
        y.backward(ct.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
        seconds[dev] = time.perf_counter() - start
        grads[dev] = [x.grad] + [t.grad for t in _tree.leaves(b)]
    names = ["input"] + [_tree.path_name(p)
                         for p, _ in _tree.leaves_with_paths(blk)]
    rel = {}
    for name, a, c in zip(names, grads["cuda"], grads["cpu"]):
        a, c = a.float().cpu(), c.float()
        rel[name] = float((a - c).norm() / c.norm())
    worst = max(rel.values())
    check(all(v <= BLOCK_GRAD_RTOL for v in rel.values()),
          f"{cfg.name} layer 0: card gradients within {BLOCK_GRAD_RTOL} of "
          f"the CPU route's: {rel}")
    return {"batch": 1, "seq": S, "rel_norm_err": rel, "max": worst,
            "tolerance": BLOCK_GRAD_RTOL, "seconds": seconds}


def train_full_path(torch, _build, phase, arch, B, S, steps, layers,
                    block_check) -> dict:
    """``launch/train.main`` at full width (module docstring): ``steps``
    steps from seeded float32 masters, then the checks: every loss and the
    gradient norm finite, every leaf moved, step 1 run twice from the same
    state giving the same loss and state bit for bit, and (``block_check``)
    layer 0 against the CPU route."""
    import math
    import tempfile
    from repro_torch import _tree
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import train
    from repro_torch.train import optim, step as tstep

    base_gib = _free(torch)
    cfg = get_config(arch)
    reduced = []
    if layers is not None:
        reduced.append(f"n_layers {cfg.n_layers} -> {layers}: "
                       f"{cfg.param_count() / 1e9:.1f} B parameters need "
                       f"{cfg.param_count() * 16 / 1e9:.0f} GB of training "
                       "state at 16 B a parameter")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(B),
            "--seq", str(S), "--seed", str(TRAIN_SEED)]
    _build.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "metrics.jsonl"
        real_config = train.get_config
        train.get_config = lambda _: cfg     # the cut depth, through main
        try:
            start = time.perf_counter()
            state = train.main(argv + ["--metrics-out", str(out)])
            main_s = time.perf_counter() - start
        finally:
            train.get_config = real_config
        recs = [json.loads(line) for line in out.read_text().splitlines()]
    peak_main_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(_build.LAUNCHES)
    check(not any(launches.values()),
          f"{phase}: no kernel of the port on this path: {launches}")
    check(len(recs) == steps and all(math.isfinite(r["loss"]) for r in recs),
          f"{phase}: {steps} finite losses: {recs}")
    n_params = sum(t.numel() for t in _tree.leaves(state.params))
    state_gib = _tree_bytes(torch, state) / 2 ** 30
    flops = _train_flops(cfg, state.params, B, S)

    seconds = {"main": main_s}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[name] = now - mark
        mark = now

    # every leaf moved from main's initial draw
    p_init = tstep.model_init(cfg)(
        cfg, torch.Generator(device="cuda").manual_seed(TRAIN_SEED), "cuda",
        dtype=torch.float32)
    unmoved = [_tree.path_name(p) for (p, a), b in zip(
        _tree.leaves_with_paths(state.params), _tree.leaves(p_init))
        if torch.equal(a, b)]
    check(not unmoved, f"{phase}: every leaf moved: {unmoved[:8]}")
    del state
    _free(torch)
    lap("moved_check")

    # step 1 twice from the same state (main's first step and batch)
    opt_cfg = optim.AdamWConfig(total_steps=max(steps, 2),
                                warmup_steps=max(2, steps // 10))
    fn = tstep.make_train_step(cfg, opt_cfg, q_chunk=min(512, S))
    batch = train.step_batch(TokenStream(cfg.vocab_size, S, B, seed=TRAIN_SEED),
                         cfg, 0, B, torch.device("cuda"))

    def fresh(params):
        return tstep.TrainState(
            step=torch.zeros((), dtype=torch.int32, device="cuda"),
            params=params, opt=optim.adamw_init(params))

    p0 = _tree.tree_map(torch.clone, p_init)
    s1, m1 = fn(fresh(p_init), batch)
    loss1 = float(m1["loss"])
    lap("step1")
    host = _tree.tree_map(lambda t: t.to("cpu", copy=True), s1)
    del s1, p_init
    _free(torch)
    lap("state_to_host")
    loss_g, _, grads = tstep.make_loss_and_grads(cfg, q_chunk=min(512, S))(
        p0, batch)
    gnorm = float(optim.global_norm(grads))
    del grads
    check(math.isfinite(gnorm), f"{phase}: gradient norm {gnorm}")
    lap("grad_pass")
    s2, m2 = fn(fresh(p0), batch)
    lap("step1_again")
    differ = [_tree.path_name(p) for (p, a), b in zip(
        _tree.leaves_with_paths(s2), _tree.leaves(host))
        if not torch.equal(a, b.to(a.device))]
    lap("compare")
    deterministic = {"loss_step1": loss1, "loss_rerun": float(m2["loss"]),
                     "loss_grad_pass": float(loss_g),
                     "leaves_differing": differ}
    check(float(m2["loss"]) == loss1 == float(loss_g) and not differ,
          f"{phase}: step 1 twice from one state, bit for bit: "
          f"{deterministic}")
    check(round(loss1, 4) == recs[0]["loss"],
          f"{phase}: main's step 1 is this step: {recs[0]} {loss1}")
    block = (_train_block_check(torch, s2.params, cfg, batch["tokens"][:1])
             if block_check else None)
    lap("block_check")
    del s2, p0, host, batch
    s_step = sum(r["sec"] for r in recs[1:]) / len(recs[1:])
    record = {
        "phase": phase, "arch": cfg.name, "family": cfg.family,
        "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
        "d_model": cfg.d_model, "batch": B, "seq": S,
        "frames": cfg.n_frontend_tokens if cfg.family == "encdec" else 0,
        "steps": recs, "reduced": reduced, "seconds": seconds,
        "s_per_step": s_step, "first_step_s": recs[0]["sec"],
        "tokens_per_s": B * S / s_step, "params": n_params,
        "model_flops_per_step": flops["model_flops"], "flops": flops,
        "tflops_per_s": flops["model_flops"] / s_step / 1e12,
        "share_of_bf16_peak": flops["model_flops"] / s_step / BF16_PEAK_FLOPS,
        "grad_norm_step1": gnorm, "state_gib": state_gib,
        "peak_mem_gib_main": peak_main_gib,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "resident_gib_before": base_gib, "every_leaf_moved": True,
        "step1_bit_for_bit": deterministic, "block_check": block,
        "launches": launches, "nvidia_smi": nvidia_smi_line()}
    emit(record)
    return record


def train_reduced_path(torch) -> dict:
    """Every reduced config: one ``make_train_step(q_chunk=16,
    microbatches=2)`` step on the card and on the CPU route from the same
    float32 masters (made on the CPU): the loss within
    ``TRAIN_LOSS_RTOL``, each leaf's update at cosine >=
    ``TRAIN_UPDATE_COS`` with the CPU's and all of them within
    ``TRAIN_UPDATE_RTOL`` in norm (tests/test_torch_train.py's tolerances
    against the reference: AdamW's first step moves a weight by about
    ``lr`` times its gradient's sign, which rounding noise sets where a
    gradient nearly vanishes)."""
    from repro_torch import _tree
    from repro_torch.configs.registry import ARCH_IDS, get_reduced
    from repro_torch.data.tokens import TokenStream
    from repro_torch.train import optim, step as tstep
    base_gib = _free(torch)
    rows = []
    for arch in ARCH_IDS:
        cfg = get_reduced(arch)
        extra = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
        stream = TokenStream(cfg.vocab_size, 32, 4, seed=1, extras=(
            {extra: (cfg.n_frontend_tokens, cfg.d_model)} if extra else None))
        batch = {k: torch.from_numpy(v) for k, v in
                 stream.batch_at(0).items()}
        init = tstep.init_train_state(torch.Generator().manual_seed(0), cfg,
                                      "cpu")
        fn = tstep.make_train_step(cfg, optim.AdamWConfig(
            lr=1e-3, warmup_steps=1, total_steps=3), q_chunk=16,
            microbatches=2)
        runs = {}
        for dev in ("cpu", "cuda"):
            state = _tree.tree_map(lambda t: t.to(dev, copy=True), init)
            state, m = fn(state, {k: v.to(dev) for k, v in batch.items()})
            runs[dev] = (float(m["loss"]), [t.cpu() for t in
                                            _tree.leaves(state.params)])
        coss, card, cpu = [], [], []
        for a, b, p in zip(runs["cuda"][1], runs["cpu"][1],
                           _tree.leaves(init.params)):
            da, db = (a - p).flatten(), (b - p).flatten()
            coss.append(float(da @ db) / float(da.norm() * db.norm()))
            card.append(da)
            cpu.append(db)
        card, cpu = torch.cat(card), torch.cat(cpu)
        row = {"arch": cfg.name, "loss_cpu": runs["cpu"][0],
               "loss_card": runs["cuda"][0],
               "loss_rel_err": abs(runs["cuda"][0] - runs["cpu"][0])
               / abs(runs["cpu"][0]),
               "min_leaf_update_cos": min(coss),
               "update_rel_err": float((card - cpu).norm() / cpu.norm())}
        rows.append(row)
        check(row["loss_rel_err"] <= TRAIN_LOSS_RTOL
              and row["min_leaf_update_cos"] >= TRAIN_UPDATE_COS
              and row["update_rel_err"] <= TRAIN_UPDATE_RTOL,
              f"train_reduced_path: {arch} card vs CPU route: {row}")
    record = {"phase": "train_reduced_path", "rows": rows,
              "tolerance": {"loss_rel": TRAIN_LOSS_RTOL,
                            "leaf_update_cos": TRAIN_UPDATE_COS,
                            "update_rel": TRAIN_UPDATE_RTOL},
              "resident_gib_before": base_gib}
    emit(record)
    return record


def train_resume_path(torch) -> dict:
    """``main`` at ``RESUME_ARCH``'s reduced config on the card, in a temp
    dir: 6 steps with a checkpoint every 3; the same 6 steps preempted
    after step 3 (SIGTERM sent by the process itself while the stream
    draws step 3's batch), then resumed from that checkpoint to 6.  The
    two step-6 checkpoints are equal bit for bit."""
    import os
    import signal
    import tempfile
    import numpy as np
    from repro_torch.launch import train
    base_gib = _free(torch)
    argv = ["--arch", RESUME_ARCH, "--reduced", "--steps", "6", "--batch",
            "4", "--seq", "64", "--microbatches", "2", "--ckpt-every", "3"]

    class Preempted(train.TokenStream):
        def batch_at(self, step):
            if step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().batch_at(step)

    def ckpt(d):
        step = os.path.join(d, "step_0000000006")
        with open(os.path.join(step, "manifest.json")) as f:
            man = json.load(f)["leaves"]
        return [(m["name"], np.load(os.path.join(step, m["file"])))
                for m in man]

    with tempfile.TemporaryDirectory() as tmp:
        full, part = os.path.join(tmp, "full"), os.path.join(tmp, "part")
        train.main(argv + ["--ckpt-dir", full])
        real_stream = train.TokenStream
        train.TokenStream = Preempted
        try:
            stopped = train.main(argv + ["--ckpt-dir", part])
        finally:
            train.TokenStream = real_stream
        stopped_at = int(stopped.step)
        check(stopped_at == 3 and train.latest_step(part) == 3,
              f"train_resume_path: preempted after step 3 ({stopped_at})")
        train.main(argv + ["--ckpt-dir", part])
        a, b = ckpt(full), ckpt(part)
        differ = [n for (n, x), (_, y) in zip(a, b)
                  if x.dtype != y.dtype or not np.array_equal(x, y)]
        same_names = [n for n, _ in a] == [n for n, _ in b]
    record = {"phase": "train_resume_path", "arch": RESUME_ARCH,
              "reduced_config": True, "argv": argv, "stopped_at": stopped_at,
              "leaves": len(a), "leaves_differing": differ,
              "resident_gib_before": base_gib}
    check(same_names and not differ, f"train_resume_path: the resumed run's "
          f"step-6 checkpoint equals the uninterrupted run's: {record}")
    emit(record)
    return record


# ---------------------------------------------------------------------------
# The tuner's auto mode, the two LM examples and the cell layer
# ---------------------------------------------------------------------------

def start_cell_counts() -> list:
    """Start the meta pass of every applicable cell (``launch/dryrun.py
    --all``, ``CELL_JOBS`` processes) and of ``CELL_PREFILL``'s batch cut
    into ``chiprun_out/dryrun``: CPU work only, on every core of the
    host, so ``cell_path`` starts it after every timed phase."""
    import os
    out = ROOT / "chiprun_out" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    arch, shape, batch = CELL_PREFILL
    commands = [
        ["--all", "--jobs", str(CELL_JOBS)],
        ["--arch", arch, "--shape", shape, "--tag", f"b{batch}",
         "--extra", json.dumps({"global_batch": batch})]]
    logs = ROOT / "chiprun_out" / "dryrun_logs"
    logs.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, args in enumerate(commands):
        with open(logs / f"meta_{i}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
                 str(out), *args], env=env, cwd=str(ROOT), stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True))
        procs[-1].log = logs / f"meta_{i}.log"
    return procs


def stop(procs) -> None:
    """Kill what is left of ``procs`` and their process groups (the meta
    pass's pool workers)."""
    import os
    import signal
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()


def tune_path(torch, _build, ctx, waves) -> dict:
    """``REPRO_TUNE=auto`` on the main path's fitted quantizer at full
    width (the 6144 training series and 768 queries, D = 512): ``encode``
    (row 1 on the LB filter's refine pairs) and the fused exact encode
    (row 5), ``cdist_sym`` (row 3), the query tables and ``cdist_asym``
    (row 4), ``dtw_band_cdist`` (row 2) of the first ``EXACT_QUERIES``
    queries at the exact search's band and ``lb_refine`` (row 6) on
    ``pruned_nn``'s first mixed wave.  The same calls run three times: with
    the tuner off, in ``auto`` mode writing ``chiprun_out/tune/tuning.json``
    (every candidate's ms, or why it was left out, and the winner
    printed), and with that table pinned; codes, distances and ids must
    be equal bit for bit across the three.  The tuner's measurements count
    in ``tune.LAUNCHES``, the tuned calls' own launches in this phase's
    ``launches``; neither goes into the rows' path counts."""
    import os
    from repro_torch.core import dispatch, pq
    from repro_torch.kernels import tune
    from repro_torch.kernels.lb_cascade.ops import lb_refine
    cfg, cb, Xd, Qd = ctx["cfg"], ctx["cb"], ctx["Xd"], ctx["Qd"]
    cfg_exact = dataclasses.replace(cfg, exact_encode=True)
    wave = waves["pruned_nn"]["mixed"]
    out = ROOT / "chiprun_out" / "tune"
    shutil.rmtree(out, ignore_errors=True)
    saved = {k: os.environ.get(k) for k in (tune.ENV, tune.OUT_ENV,
                                            tune.GRID_ENV)}

    def calls():
        res = {"codes": pq.encode(Xd, cb, cfg),
               "codes_fused": pq.encode(Xd, cb, cfg_exact),
               "q_codes": pq.encode(Qd, cb, cfg)}
        res["d_sym"] = pq.cdist_sym(res["q_codes"], res["codes"], cb.lut)
        res["d_asym"] = pq.cdist_asym(Qd, res["codes"], cb, cfg)
        res["d_cdist"] = dispatch.elastic_cdist(Qd[:EXACT_QUERIES], Xd,
                                                ctx["w_exact"])
        res["lb_d"], res["lb_flag"] = lb_refine(*wave)
        for name in ("d_sym", "d_asym", "d_cdist"):
            res[name + "_ids"] = torch.topk(res[name], 10, dim=1,
                                            largest=False).indices
        torch.cuda.synchronize()
        return res

    seconds, runs, resolved = {}, {}, {}
    try:
        os.environ.pop(tune.GRID_ENV, None)
        for name, mode in (("off", "off"), ("auto", "auto"),
                           ("pinned", str(out / "tuning.json"))):
            os.environ[tune.ENV] = mode
            os.environ[tune.OUT_ENV] = str(out)
            tune.reset()
            counts = resolved.setdefault(name, {})
            t0 = time.perf_counter()
            with _build.counted_apart(counts):
                runs[name] = calls()
            seconds[name] = time.perf_counter() - t0
            if name == "auto":
                report = [dict(r) for r in tune.REPORT]
                measured = dict(tune.LAUNCHES)
                table = json.loads((out / "tuning.json").read_text())
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tune.reset()
    for line in report:
        emit({"phase": "tune_key", **line})
    differ = {run: [k for k in runs["off"]
                    if not torch.equal(runs["off"][k], runs[run][k])]
              for run in ("auto", "pinned")}
    record = {"phase": "tune_path", "seconds": seconds,
              "keys": len(table), "table": table,
              "winners_vs_default": [
                  {"key": r["key"], "winner": r["winner"],
                   "winner_ms": r["winner_ms"],
                   "default": r["candidates"][0]["params"],
                   "default_ms": r["candidates"][0].get("ms")}
                  for r in report],
              "launches": {"measured": measured, "tuned_calls": resolved},
              "differ": differ}
    emit(record)
    ops = {r["key"].split("|")[0] for r in report}
    check(ops >= {"dtw_band", "dtw_band_cdist", "adc_sym", "adc_lookup",
                  "prealign_encode", "lb_refine"},
          f"tune_path: every row 1-6 key measured: {sorted(ops)}")
    check(all(("ms" in c) != ("error" in c) or "ms" in c
              for r in report for c in r["candidates"]),
          "tune_path: every candidate timed or reported left out")
    check(all(r["winner"] in [c["params"] for c in r["candidates"]
                              if "ms" in c and "error" not in c]
              for r in report),
          "tune_path: every winner is an admitted candidate")
    check(sorted(table) == sorted(r["key"] for r in report),
          "tune_path: the table holds every measured key")
    check(not differ["auto"] and not differ["pinned"],
          f"tune_path: codes, distances and ids of the auto and pinned runs "
          f"equal the off run's bit for bit: {differ}")
    check(sum(measured.values()) > 0, "tune_path: the tuner launched")
    return record


def _first_parting(torch, a, b):
    """``(row, step)`` of the first token where ``a`` and ``b`` (``(B,
    gen)``) part, or ``None``."""
    diff = (a != b).nonzero()
    if not diff.numel():
        return None
    step = int(diff[:, 1].min())
    row = int(diff[diff[:, 1] == step][0, 0])
    return row, step


def examples_lm_path(torch, _build, kernels) -> dict:
    """The two LM examples on the card at the reference example's
    arguments (``repro_torch.examples.serve_pqkv`` and ``.train_lm``).
    ``serve_pqkv`` (reduced internlm2-1.8b, 4 x 32 tokens, 12 steps,
    PQKVConfig(n_sub=4, codebook_size=16, recent_window=8)) must launch
    row 11 on its PQ steps; its exact and PQ greedy tokens against the CPU
    route's on the same seed: equal, or at the first step where they part
    both routes' top-2 logit gaps there below twice ``LOGIT_ATOL`` (a
    near-tie of two logits each within the ``lm_path`` tolerance; later
    tokens follow other histories).  ``train_lm`` (``TRAIN_LM_STEPS``
    steps, batch 8 x 128, 2 microbatches, checkpoints every 25 steps,
    stopped half-way and restarted): the loss falls (the example asserts
    it) and phase 2 starts from phase 1's last checkpoint.  Row 11's
    launches here are added to its record in ``kernels``."""
    import tempfile
    from repro_torch.examples import serve_pqkv, train_lm
    _free(torch)
    _build.reset_launches()
    t0 = time.perf_counter()
    card = serve_pqkv.main([])
    serve_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    cpu = serve_pqkv.main(["--device", "cpu"])
    parts = {}
    for key, gaps in (("tokens", "margins"), ("pq_tokens", "pq_margins")):
        at = _first_parting(torch, card[key], cpu[key])
        if at is None:
            parts[key] = None
            continue
        row, step = at
        gap = max(float(card[gaps][row, step]), float(cpu[gaps][row, step]))
        parts[key] = {"row": row, "step": step, "top2_gap": gap}
        check(gap < 2 * LOGIT_ATOL, f"examples_lm_path: serve_pqkv's {key} "
              f"part from the CPU route's at a near-tie: {parts[key]}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rows = train_lm.main(["--steps", str(TRAIN_LM_STEPS),
                              "--ckpt-dir", tmp])
        train_s = time.perf_counter() - t0
    half = TRAIN_LM_STEPS // 2
    steps = [r["step"] for r in rows]
    record = {"phase": "examples_lm_path", "serve_s": serve_s,
              "serve_launches": launches, "parting": parts,
              "pq_agreement": float((card["pq_tokens"]
                                     == card["tokens"]).float().mean()),
              "train_s": train_s, "train_steps": TRAIN_LM_STEPS,
              "loss_first": rows[0]["loss"],
              "loss_half": rows[half - 1]["loss"],
              "loss_after_restart": rows[half]["loss"],
              "loss_last": rows[-1]["loss"]}
    emit(record)
    check(launches["pq_attn"] > 0, "examples_lm_path: serve_pqkv launched "
          "row 11 on the card")
    check(steps == list(range(1, TRAIN_LM_STEPS + 1)),
          "examples_lm_path: phase 2 resumed from phase 1's checkpoint "
          "(steps logged once each, in order)")
    check(rows[-1]["loss"] < rows[0]["loss"], "examples_lm_path: loss fell")
    for row in kernels:
        if row["name"] in ("pq_attn", "pq_attn[window]"):
            row["launches"] += launches[row["name"]]
    return record


def cell_path(torch) -> dict:
    """The cell layer on the card.  The meta pass
    (``start_cell_counts``) writes a record for every applicable (arch x
    shape) cell; each is printed (fit, peak, FLOPs by type, roofline
    terms).  Then one real step each of ``CELL_RUNS`` through
    ``launch.dryrun.run_cell(run=True)``, timed after a warm-up step:
    mamba2-780m's ``train_4k`` (cut to 2 microbatches of its 1 x 4096
    rows), ``decode_32k`` and ``prefill_32k`` at ``CELL_PREFILL``'s batch
    (no prefill cell fits the card whole: 100-119 GiB for the smallest),
    with ``max_memory_allocated`` beside the meta peak."""
    from repro_torch.launch import dryrun
    out = ROOT / "chiprun_out" / "dryrun"
    t0 = time.perf_counter()
    procs = start_cell_counts()
    try:
        for p in procs:
            p.wait(timeout=CELL_WAIT_S)
            text = p.log.read_text()
            check(p.returncode == 0, f"cell_path: the meta pass failed: "
                  f"{text[-2000:]}")
    finally:
        stop(procs)
    wait_s = time.perf_counter() - t0
    cells = []
    for path in sorted(out.glob("*.json")):
        rec = json.loads(path.read_text())
        ro = rec["roofline"]
        cells.append({"cell": path.stem, "fit": rec["fit"],
                      "peak_gib": rec["memory"]["peak_bytes"] / 2 ** 30,
                      "flops_bf16": ro["flops_bf16"],
                      "flops_f32": ro["flops_f32"],
                      "floor_bytes": ro["hbm_bytes"],
                      "eager_bytes": ro["hbm_eager_bytes"],
                      "compute_s": ro["compute_s"],
                      "memory_s": ro["memory_s"],
                      "memory_eager_s": ro["memory_eager_s"],
                      "bound": ro["bound"],
                      "roofline_frac": ro["roofline_frac"],
                      "count_s": rec["t_count_s"]})
    emit({"phase": "cell_counts", "cells": cells, "wait_s": wait_s})
    _free(torch)
    runs = []
    t0 = time.perf_counter()
    for arch, shape, extra, tag in CELL_RUNS:
        rec = dryrun.run_cell(arch, shape, str(out), extra=extra, tag=tag,
                              run=True)
        run = rec.get("run", {})
        runs.append({"cell": dryrun.cell_id(arch, shape) + (
            f"__{tag}" if tag else ""), "fit": rec["fit"],
            "reduced": rec.get("reduced", []) + run.get("reduced", []),
            **{k: run.get(k) for k in ("seconds", "max_memory_allocated",
                                       "meta_peak_bytes", "meta_over_real",
                                       "error", "skipped")}})
        _free(torch)
    record = {"phase": "cell_path", "cells": len(cells),
              "fit": sorted(c["cell"] for c in cells if c["fit"]),
              "runs": runs, "runs_s": time.perf_counter() - t0}
    emit(record)
    applicable = sum(1 for *_, ok, _ in _all_cells() if ok)
    check(len(cells) == applicable + 1, f"cell_path: a record for every "
          f"applicable cell and the batch cut ({len(cells)})")
    from repro_torch.configs.registry import SHAPES
    kinds = {SHAPES[r["cell"].split("__")[1]].kind for r in runs
             if r["seconds"] is not None}
    check(kinds == {"train", "prefill", "decode"}, f"cell_path: a real step "
          f"of a train, a prefill and a decode cell: {runs}")
    return record


def _all_cells():
    from repro_torch.configs.registry import all_cells
    return list(all_cells())


# ---------------------------------------------------------------------------
# The multi-device rules on one card: the host mesh and the per-device
# dry runs
# ---------------------------------------------------------------------------

def start_mesh_counts() -> list:
    """Start the per-device dry runs of ``MESH_CELLS`` (``launch/dryrun.py
    --mesh single`` and ``--mesh multi``, one process a record, 16 on the
    host's cores) into ``chiprun_out/dryrun_mesh``: CPU work only."""
    import os
    out = ROOT / "chiprun_out" / "dryrun_mesh"
    shutil.rmtree(out, ignore_errors=True)
    logs = ROOT / "chiprun_out" / "dryrun_logs"
    logs.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for arch, shape in MESH_CELLS:
        for mesh in ("single", "multi"):
            log = logs / f"mesh_{arch}_{shape}_{mesh}.log"
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--out", str(out), "--arch", arch, "--shape", shape,
                     "--mesh", mesh], env=env, cwd=str(ROOT), stdout=f,
                    stderr=subprocess.STDOUT, start_new_session=True))
            procs[-1].log = log
    return procs


def mesh_path(torch, _build, kernels) -> dict:
    """The partition rules and the mesh forms of the model on the card.

    The per-device dry runs of ``MESH_CELLS`` start in background processes
    (``start_mesh_counts``, one a record), and meanwhile a child process
    (``mesh_child``: this process never holds a process group) builds a
    real ``(1, 1)`` ``DeviceMesh`` over ``("data", "model")`` on an NCCL
    group of one and runs ``MESH_ARCH`` at full width and depth from
    seeded weights twice, without a mesh and laid out as ``DTensor`` s by
    the partition rules: one train step (``launch/train``'s step:
    ``state_specs``, ``make_train_step``, ``mesh_context``), then
    ``MESH_DECODE`` exact and PQ-KV decode steps from one prefilled cache,
    the PQ steps' row 11 launched inside the ``local_map`` of
    ``models/spmd.py``.  Each mesh run equals its meshless run bit for
    bit: the loss, every updated master, every logit.  One model state is
    on the card at a time; the meshless results wait on the host.  Then
    row 11 on one layer's cache split four ways along its sequence
    (``split_pq_decode``: the mesh's split branch, each shard in a thread)
    must equal the one-device call.  Row 11's launches of the mesh steps
    are this record's and are added to row 11's record in ``kernels``;
    the ``main_path`` line keeps the main path's own counts.  Then every
    dry-run record is printed (per-device peak, FLOPs by type, collective
    bytes by kind, the roofline's terms, the gathers the port forces) and
    must be ``ok``; a train cell's per-device bf16 FLOPs times its
    devices lie within ``MESH_FLOPS_RATIO`` of one card's count
    (``cell_path``'s records)."""
    out = ROOT / "chiprun_out" / "mesh_child.json"
    log = ROOT / "chiprun_out" / "mesh_child.log"
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    procs = start_mesh_counts()
    try:
        _free(torch)
        with open(log, "w") as f:
            proc = subprocess.run(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "sys.exit(chip_smoke.mesh_child(sys.argv[1]))", str(out)],
                cwd=str(ROOT), stdout=f, stderr=subprocess.STDOUT,
                timeout=MESH_CHILD_TIMEOUT_S)
        check(proc.returncode == 0 and out.exists(), "mesh_path: the host "
              f"mesh's child process failed: {log.read_text()[-3000:]}")
        child = json.loads(out.read_text())
        child_s = time.perf_counter() - t0
        for p in procs:
            p.wait(timeout=max(1.0, MESH_CELL_WAIT_S
                               - (time.perf_counter() - t0)))
            check(p.returncode == 0, f"mesh_path: a per-device dry run "
                  f"failed: {p.log.read_text()[-2000:]}")
    finally:
        stop(procs)
    records = _mesh_records()
    record = {"phase": "mesh_path", "host_mesh": child,
              "child_s": child_s, "wait_s": time.perf_counter() - t0,
              "cells": records, "nvidia_smi": nvidia_smi_line()}
    emit(record)
    for what in ("train", "exact", "pq"):
        check(child[what]["equal"], f"mesh_path: the host mesh's {what} "
              f"run equals the meshless run bit for bit: {child[what]}")
    n = child["launches"].get("pq_attn", 0)
    check(n == child["pq_attn_expected"] > 0, f"mesh_path: row 11 launched "
          f"inside local_map once a layer a PQ step: {child['launches']}")
    check(all(r["within"] and r["launches"] == MESH_SPLIT
              for r in child["split"]), f"mesh_path: row 11 over a "
          f"sequence split {MESH_SPLIT} ways equals the one-device call "
          f"within {MESH_SPLIT_TOL}: {child['split']}")
    check(len(records) == 2 * len(MESH_CELLS) and all(
        r["ok"] for r in records), f"mesh_path: every per-device record ok: "
        f"{[(r['cell'], r.get('error')) for r in records if not r['ok']]}")
    for r in records:
        if r.get("card_ratio") is not None:
            check(r["card_ratio"] <= MESH_FLOPS_RATIO, f"mesh_path: "
                  f"{r['cell']}: per-device bf16 FLOPs x devices within "
                  f"{MESH_FLOPS_RATIO}x of the card's: {r['card_ratio']}")
    for row in kernels:
        if row["name"] == "pq_attn":
            row["launches"] += n
    return record


def _mesh_records() -> list:
    """The per-device records, each beside its cell's one-card count."""
    card_dir = ROOT / "chiprun_out" / "dryrun"
    rows = []
    for path in sorted((ROOT / "chiprun_out" / "dryrun_mesh").glob("*.json")):
        r = json.loads(path.read_text())
        row = {"cell": path.stem, "ok": r["ok"], "chips": r["chips"]}
        if not r["ok"]:
            rows.append(dict(row, error=r.get("error")))
            continue
        ro, m = r["roofline"], r["memory"]
        card = card_dir / f"{r['arch']}__{r['shape']}__card.json"
        ratio = None
        if card.exists() and r["shape"].startswith("train"):
            c = json.loads(card.read_text())["roofline"]
            ratio = ro["flops_bf16"] * r["chips"] / c["flops_bf16"]
        rows.append(dict(
            row, peak_gib=m["peak_bytes"] / 2 ** 30,
            flops_bf16=ro["flops_bf16"], flops_f32=ro["flops_f32"],
            collectives=r["collectives"], compute_s=ro["compute_s"],
            memory_s=ro["memory_s"], collective_s=ro["collective_s"],
            bound=ro["bound"], card_ratio=ratio,
            forced=[(f["tensor"], f["bytes"]) for f in r["forced"][:4]],
            count_s=r["t_count_s"]))
    return rows


def mesh_child(out: str) -> int:
    """``mesh_path``'s child: an NCCL group of one, the ``(1, 1)`` host
    mesh, and ``MESH_ARCH``'s train step and decode steps without and on
    the mesh; the comparisons and row 11's launches on the mesh written to
    ``out`` as JSON."""
    import gc
    import tempfile
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _tree
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import _build
    from repro_torch.launch.cells import mesh_context, state_specs
    from repro_torch.launch.mesh import device_mesh, make_host_mesh
    from repro_torch.models.lm import init_params
    from repro_torch.serve.cache import init_cache
    from repro_torch.serve.decode import serve_step
    from repro_torch.serve.pqkv import (PQKVConfig, compress_cache,
                                        pq_serve_step)
    from repro_torch.serve.prefill import prefill
    from repro_torch.sharding import partition as P
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    store = tempfile.mkdtemp()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/pg",
                            rank=0, world_size=1)
    result = {}
    try:
        mesh = device_mesh(make_host_mesh(), "cuda")
        cfg = get_config(MESH_ARCH)
        dev = torch.device("cuda")

        # -- one train step: meshless, then on the mesh ------------------
        B, S = MESH_TRAIN
        batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenStream(
            cfg.vocab_size, S, B).batch_at(0).items()}
        step = make_train_step(cfg, AdamWConfig(), q_chunk=512)

        def train(on_mesh):
            state = init_train_state(
                torch.Generator(device=dev).manual_seed(0), cfg, dev)
            b = batch
            if on_mesh:
                state = P.distribute(state, state_specs(state, mesh), mesh)
                b = P.distribute(batch, P.batch_specs(batch, mesh), mesh)
            t0 = time.perf_counter()
            with mesh_context(mesh if on_mesh else None):
                state, metrics = step(state, b)
                loss = float(P.full(metrics["loss"]))
            # repro: ignore[RS101] the step's time, read once the card is done
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            return state, loss, secs

        state, loss_plain, s_plain = train(False)
        host = [t.detach().cpu() for t in _tree.leaves(state.params)]
        del state
        gc.collect()
        torch.cuda.empty_cache()
        state, loss_mesh, s_mesh = train(True)
        differ = [i for i, (t, h) in enumerate(zip(
            _tree.leaves(state.params), host))
            if not torch.equal(P.full(t).cpu(), h)]
        result["train"] = {"batch": [B, S], "loss": [loss_plain, loss_mesh],
                           "seconds": [s_plain, s_mesh],
                           "leaves": len(host), "leaves_differ": len(differ),
                           "peak_gib": torch.cuda.max_memory_allocated()
                           / 2 ** 30,
                           "equal": loss_plain == loss_mesh and not differ}
        del state, host
        gc.collect()
        torch.cuda.empty_cache()

        # -- decode: exact and PQ-KV, meshless then on the mesh ----------
        B, prompt, n = MESH_DECODE
        gen = torch.Generator(device=dev).manual_seed(1)
        params = init_params(cfg, gen, dev)
        cache = init_cache(cfg, B, prompt + n, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (B, prompt + n), device=dev,
                             generator=gen, dtype=torch.int32)
        with torch.no_grad():
            _, cache = prefill(params, cfg, cache,
                               {"tokens": toks[:, :prompt]})
            pqc = PQKVConfig()
            pq = compress_cache({"k": cache["k"], "v": cache["v"].clone()},
                                cfg, pqc, pos=prompt, generator=torch.
                                Generator(device=dev).manual_seed(2))
        m_params = P.distribute(params, P.param_specs(params, mesh,
                                                      fsdp=False), mesh)

        def decode(on_mesh, pq_cache=None):
            c = _tree.tree_map(lambda t: t.clone(),
                               cache if pq_cache is None else pq_cache)
            p_ = params
            if on_mesh:
                p_ = m_params
                c = P.distribute(c, P.cache_specs(c, mesh), mesh)
            logits = []
            with torch.no_grad(), mesh_context(mesh if on_mesh else None):
                for i in range(n):
                    tok = toks[:, prompt + i:prompt + i + 1]
                    if on_mesh:
                        tok = P.distribute({"token": tok}, P.batch_specs(
                            {"token": tok}, mesh), mesh)["token"]
                    if pq_cache is None:
                        out, c = serve_step(p_, cfg, c, tok, prompt + i)
                    else:
                        out, c = pq_serve_step(p_, cfg, c, tok, prompt + i,
                                               pqc=pqc)
                    logits.append(P.full(out).cpu())
            return torch.stack(logits)

        for what, pq_cache in (("exact", None), ("pq", pq)):
            plain = decode(False, pq_cache)
            _build.reset_launches()
            on_mesh = decode(True, pq_cache)
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            result[what] = {"batch": B, "prompt": prompt, "steps": n,
                            "max_abs_diff": float(
                                (on_mesh - plain).abs().max()),
                            "equal": torch.equal(on_mesh, plain)}
            if pq_cache is not None:
                result["launches"] = launches
                result["pq_attn_expected"] = cfg.n_layers * n
        result["split"] = split_pq_decode(torch, pq.layer(0), pqc, cfg)
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(result))
    return 0


def split_pq_decode(torch, lc, pqc, cfg) -> list:
    """Row 11 on a sequence split over ``MESH_SPLIT`` ranks, as a
    ``model`` axis of that size splits it: one layer's compressed cache
    cut into shards along its positions, each shard's decode attention
    (``pq_attention_decode``'s ``s0`` / ``reduce``, the kernel on the
    shard's part of the tail, the log-sum-exp merge) run in a thread of
    its own by ``partition.shard_threads``, against the one-device call
    on the whole cache, at ``MESH_SPLIT_POS`` (the later leaves the last
    shards without a tail position).  Returns each position's worst
    error and its bound (``MESH_SPLIT_TOL``)."""
    from repro_torch.kernels import _build
    from repro_torch.serve.pqkv import pq_attention_decode
    from repro_torch.sharding.partition import shard_threads
    B, S, G = lc.k_codes.shape[:3]
    R, hd = cfg.n_heads // G, cfg.head_dim_
    Sl = S // MESH_SPLIT
    dev = lc.k_codes.device
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((B, G, R, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    rows = []
    for pos in MESH_SPLIT_POS:
        want = pq_attention_decode(q, lc, pos, pqc=pqc).float()

        def shard(rank, reduce, pos=pos):
            part = lc._replace(k_codes=lc.k_codes[:, rank * Sl:
                                                  (rank + 1) * Sl],
                               v=lc.v[:, rank * Sl:(rank + 1) * Sl])
            return pq_attention_decode(q, part, pos, pqc=pqc,
                                       s0=rank * Sl, reduce=reduce)

        before = _build.LAUNCHES["pq_attn"]
        got = shard_threads(shard, MESH_SPLIT)
        err = max(float((g.float() - want).abs().max()) for g in got)
        bound = max(float((MESH_SPLIT_TOL["atol"] + MESH_SPLIT_TOL["rtol"]
                           * want.abs() - (g.float() - want).abs()).min())
                    for g in got)
        rows.append({"pos": pos, "shards": MESH_SPLIT, "max_abs_err": err,
                     "launches": _build.LAUNCHES["pq_attn"] - before,
                     "within": bound >= 0.0})
    return rows


# ---------------------------------------------------------------------------
# The port's gates: static analysis, sync sanitizer, routing
# ---------------------------------------------------------------------------

ROUTING_MEASURE = "msm:c=0.5"   # the routing leg's non-DTW measure
ROUTING_TOP_LISTS, ROUTING_PROBE_TOP = 8, 2
# one DBA round for the two-level table (the index's default is 8): the
# table only has to exist for the two-level stage to dispatch
ROUTING_COARSE_ITERS = 1


def static_gate() -> dict:
    """``repro_torch.analysis`` over this checkout against its baseline
    (``python -m repro_torch.analysis.check_static``, in-process): no new
    finding, no stale or unjustified baseline entry."""
    from repro_torch.analysis import analyze, engine
    report = analyze(ROOT, baseline_path=ROOT / engine.BASELINE)
    g = report.graph
    record = {"phase": "static_gate", "modules": len(g.modules),
              "functions": len(g.functions), "hot_roots": len(g.hot_roots()),
              "hot_reachable": len(g.hot_reachable()),
              "baselined": len(report.baselined),
              "findings": [f.render(ROOT) for f in report.findings],
              "stale": report.stale_baseline,
              "unjustified": report.unjustified_baseline}
    emit(record)
    check(report.clean, f"static_gate: {record}")
    return record


def _dispatch_counts(snap: dict) -> dict:
    return {tuple(sorted(c["labels"].items())): c["value"]
            for c in snap["counters"] if c["name"] == "dispatch_total"}


def sanitizer_path(torch, _build) -> dict:
    """Every dispatch op (``check_sanitizers.device_ops``: the routing
    gate's 11, the 4 measured ones under a non-DTW measure, and
    ``knn_classify_sym`` / ``knn_classify_asym`` over encoded codes) on tiny
    device-resident inputs, warmed up and then run again under
    ``torch.cuda.set_sync_debug_mode("error")``: none may wait for the
    card but the ops of ``check_sanitizers.KNOWN_READS`` (ROADMAP queue
    3; none is listed since the ADC range check moved to where codes
    enter the program), which would trip at their own call and be
    reported as failing.
    A seeded thunk that calls ``.item()`` sits among them and must
    trip under its own name; the mode must be back at 0 after.  Returns
    the dispatch counts the phase added (the routing gate takes them out
    again for its check of the other paths)."""
    from repro_torch import obs
    from repro_torch.analysis import check_sanitizers
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    ops = check_sanitizers.device_ops()
    ops.insert(len(ops) // 2, ("seeded_item", lambda: x.sum().item()))
    before = _dispatch_counts(obs.snapshot())
    _build.reset_launches()
    results = check_sanitizers.run(ops)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    after = _dispatch_counts(obs.snapshot())
    trips = {n: e for n, e in results if e is not None}
    known = [n for n, e in trips.items() if check_sanitizers.known(n, e)]
    emit({"phase": "sanitizer_path", "mode": "error",
          "clean": [n for n, e in results if e is None],
          "trips": trips, "known_reads": known, "launches": launches})
    if known:
        print(f"sanitizer_path: FAIL for {len(known)} op(s) that read the "
              f"card back where the reference's do not (ROADMAP queue 3, "
              f"check_sanitizers.KNOWN_READS): {', '.join(known)}",
              file=sys.stderr, flush=True)
    check(set(trips) - set(known) == {"seeded_item"},
          f"sanitizer_path: no trip but the seeded .item() and the known "
          f"reads, each at its own call: {trips}")
    check(sorted(known) == sorted(check_sanitizers.KNOWN_READS),
          f"sanitizer_path: every known read trips at its call (a read "
          f"that is gone leaves KNOWN_READS and ROADMAP queue 3): {trips}")
    check(".item()" in trips["seeded_item"],
          f"sanitizer_path: the seeded trip names its call: {trips}")
    check(torch.cuda.get_sync_debug_mode() == 0,
          "sanitizer_path: the sync debug mode is reset")
    for k in MAIN_PATH_KERNELS + ("lb_refine", "dtw_band_adaptive",
                                  "lb_refine_adaptive", "adc_sym_quant",
                                  "adc_lookup_quant"):
        check(launches.get(k, 0) > 0, f"sanitizer_path launched {k}")
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def routing_leg(torch, _build, ctx) -> dict:
    """The smallest leg that dispatches the measured ops under a non-DTW
    measure on the card at real shapes (no earlier path does: the sweeps
    of ``measure_sweep`` call the kernels directly): an msm index on the
    index path's quantizers (the codebook's LUT rebuilt under msm) with
    the fused exact encode and a two-level coarse quantizer (one DBA
    round over the 64 coarse centroids), the 6144
    series inserted, the 768 queries searched, ``search_sharded`` on 256
    of them, then a flush, a compaction and a search again, with obs on.
    The two-level coarse stage with every top probed must equal the flat
    coarse matrix."""
    from repro_torch import obs
    from repro_torch.core import dispatch, pq
    from repro_torch.index import IndexConfig, StreamingIndex
    from repro_torch.index.planner import search_sharded

    X, Qd, D = ctx["X"], ctx["Qd"], ctx["D"]
    st = ctx["index_state"]
    pcfg = dataclasses.replace(
        pq.PQConfig(), metric="msm", measure_params=(("c", 0.5),),
        exact_encode=True)
    cfg = IndexConfig(pcfg, n_lists=INDEX_LISTS, hot_capacity=HOT_CAPACITY,
                      n_top_lists=ROUTING_TOP_LISTS,
                      n_probe_top=ROUTING_PROBE_TOP,
                      coarse_iters=ROUTING_COARSE_ITERS)
    check(pq.uses_fused_prealign(pcfg), "routing leg: the fused encode")
    seconds = {}
    _build.reset_launches()
    dispatch.reset_stats()
    with obs.override(True):
        cb, seconds["codebook"] = _timed(
            torch, lambda: pq.codebook_from_centroids(st["cb"].centroids,
                                                      pcfg, D))
        idx, seconds["index"] = _timed(torch, lambda: StreamingIndex(
            cfg, st["coarse"], cb, D, device=Qd.device))
        _, seconds["insert"] = _timed(torch, lambda: idx.insert(X))
        (d, i), seconds["search"] = _timed(torch, lambda: idx.search(
            Qd, n_probe=N_PROBE, topk=TOPK))
        Qs = Qd[:SHARDED_QUERIES]
        want = idx.search(Qs, n_probe=N_PROBE, topk=TOPK)
        sharded, seconds["sharded"] = _timed(torch, lambda: search_sharded(
            idx, Qs, n_probe=N_PROBE, topk=TOPK, partition="queries"))
        _, seconds["flush_compact"] = _timed(
            torch, lambda: (idx.flush(), idx.compact()))
        (cd, ci), seconds["search_compacted"] = _timed(
            torch, lambda: idx.search(Qd, n_probe=N_PROBE, topk=TOPK))
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    stats = {f"{op}:{route}": n for (op, route), n in dispatch.stats.items()}
    N, Nq = X.shape[0], Qd.shape[0]
    for dd, ii, what in ((d, i, "search"), (cd, ci, "compacted search")):
        check(tuple(dd.shape) == (Nq, TOPK) and bool(torch.isfinite(dd).all())
              and bool(((ii >= 0) & (ii < N)).all()),
              f"routing leg {what}: finite distances, ids in range")
    ties = _same_up_to_ties(torch, sharded, want,
                            "routing leg: search_sharded")
    tl, w = idx.two_level, cfg.coarse_window(D)
    two = dispatch.two_level_coarse(
        Qs, tl.top, idx.coarse, tl.child_idx, tl.child_valid, w,
        n_probe_top=ROUTING_TOP_LISTS, measure=ROUTING_MEASURE)
    flat = dispatch.elastic_cdist(Qs, idx.coarse, w, measure=ROUTING_MEASURE)
    _, two_rel, ok = _errors(torch, two, flat)
    check(ok, "routing leg: the two-level coarse stage with every top "
          "probed equals the flat coarse matrix")
    for key in ("prealign_encode[msm]:cuda", "elastic_cdist[msm]:cuda",
                "elastic_pairwise[msm]:cuda", "two_level_coarse[msm]:cuda"):
        check(stats.get(key, 0) > 0, f"routing leg dispatched {key}")
    record = {"phase": "routing_leg", "measure": ROUTING_MEASURE,
              "n_lists": INDEX_LISTS, "n_top_lists": ROUTING_TOP_LISTS,
              "coarse_iters": ROUTING_COARSE_ITERS,
              "n_probe_top": ROUTING_PROBE_TOP, "n_probe": N_PROBE,
              "topk": TOPK, "inserted": N, "queries": Nq,
              "segments": idx.n_segments, "sharded_tie_reorders": ties,
              "two_level_max_rel_err": two_rel, "seconds": seconds,
              "dispatch": stats, "launches": launches}
    emit(record)
    return record


def routing_gate(torch, _build, ctx, sanitized: dict) -> dict:
    """Last: the routing leg, then ``check_routing.check`` on the whole
    run's obs snapshot (route ``"cuda"`` for the 12 ops, a non-DTW
    measure for the 4 measured ones, every instrumented stage recorded
    with obs on), and again with the sanitizer's tiny dispatches taken
    out, so the paths themselves pass."""
    from repro_torch import obs
    from repro_torch.analysis import check_routing
    routing_leg(torch, _build, ctx)
    snap = obs.snapshot()
    rc, lines = check_routing.check(snap, "cuda", stages=True)
    paths = dict(snap, counters=[
        dict(c, value=c["value"] - sanitized.get(
            tuple(sorted(c["labels"].items())), 0))
        if c["name"] == "dispatch_total" else c for c in snap["counters"]])
    rc_paths, lines_paths = check_routing.check(paths, "cuda", stages=True)
    emit({"phase": "routing_gate", "route": "cuda", "rc": rc,
          "report": lines, "rc_without_sanitizer": rc_paths,
          "report_without_sanitizer": lines_paths[-2:]})
    check(rc == 0, "routing_gate: " + " | ".join(lines[-2:]))
    check(rc_paths == 0, "routing_gate without the sanitizer's dispatches: "
          + " | ".join(lines_paths[-2:]))
    return {"rc": rc}


def small_sequential_reference(torch, arch) -> dict:
    """The family's reduced config with weights made on the CPU and
    carried to the card: a 12-token prompt through ``serve_step`` one
    token at a time (encdec after ``prefill_cache_encdec`` of 16 frames),
    then 4 greedy steps, give the CPU route's logits within
    ``LOGIT_ATOL`` and its greedy tokens."""
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import encdec, lm
    from repro_torch.serve.cache import init_cache
    from repro_torch.serve.decode import prefill_cache_encdec, serve_step
    cfg = get_reduced(arch)
    B, S, n_gen = 2, 12, 4
    init = (encdec.init_params_encdec if cfg.family == "encdec"
            else lm.init_params)
    p_cpu = init(cfg, torch.Generator().manual_seed(3), "cpu")
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    frames = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model), generator=g)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = _to(torch, p_cpu, dev)
        cache = init_cache(cfg, B, S + n_gen, dev)
        if cfg.family == "encdec":
            prefill_cache_encdec(params, cfg, cache, frames.to(dev))
        logits, toks = [], []
        for p in range(S + n_gen):
            tok = (tokens[:, p:p + 1] if p < S
                   else _greedy(torch, logits[-1])).to(dev)
            if p >= S:
                toks.append(tok.cpu())
            lg, _ = serve_step(params, cfg, cache, tok, p)
            logits.append(lg.cpu())
        toks.append(_greedy(torch, logits[-1]).cpu())
        runs[dev] = (torch.cat(logits, 1), torch.cat(toks, 1))
    err = float((runs["cpu"][0] - runs["cuda"][0]).abs().max())
    same = bool(torch.equal(runs["cpu"][1], runs["cuda"][1]))
    out = {"arch": cfg.name, "prompt": S, "generated": n_gen,
           "logits_max_abs_err": err, "greedy_tokens_equal": same}
    check(err <= LOGIT_ATOL, f"{arch} reduced: card logits within the "
          f"tolerance of the CPU route: {err}")
    check(same, f"{arch} reduced: the card's greedy tokens are the CPU's")
    return out


def small_family_reference(torch, arch, patches) -> dict:
    """The family's reduced config with weights made on the CPU and
    carried to the card (gemma2's prompt 8 past its window of 32; the vlm
    with patch embeddings): prefill, 3 exact decode steps and 3 PQ steps
    in each of ``mode="softmax"``, ``"topk"`` and ``quantize_v=True``
    (books fit on the CPU) give the CPU route's logits within
    ``LOGIT_ATOL``.  The codes of the two runs may differ where a key lies
    near two codewords (the card's products round their sums in another
    order; gemma2's softcap is another ``tanh``): they are counted, and
    the CPU run's prefill cache compressed on the card gives the CPU's
    key and value codes bit for bit."""
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve import pqkv
    from repro_torch.serve.cache import init_cache
    from repro_torch.serve.decode import serve_step
    from repro_torch.serve.prefill import prefill
    cfg = get_reduced(arch)
    B = 2
    S = cfg.sliding_window + 8 if cfg.sliding_window else 24
    base = dict(n_sub=4, codebook_size=16, recent_window=8)
    modes = {"softmax": pqkv.PQKVConfig(**base),
             "topk": pqkv.PQKVConfig(**base, mode="topk", top_t=8),
             "quantize_v": pqkv.PQKVConfig(**base, quantize_v=True)}
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if patches:
        batch["patches"] = torch.randn((B, cfg.n_frontend_tokens,
                                        cfg.d_model), generator=g)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = _to(torch, p_cpu, dev)
        logits, cache = prefill(params, cfg, init_cache(cfg, B, S + 4, dev),
                                {k: v.to(dev) for k, v in batch.items()})
        if dev == "cpu":
            fit = torch.Generator().manual_seed(5)
            books = pqkv.fit_kv_books(cache["k"], modes["softmax"], fit, S)
            v_books = pqkv.fit_kv_books(cache["v"], modes["softmax"], fit, S)
            cpu_cache = {k: v.clone() for k, v in cache.items()}
        pq = {m: pqkv.compress_cache(
            {"k": cache["k"], "v": cache["v"].clone()}, cfg, c, pos=S,
            books=books, v_books=v_books) for m, c in modes.items()}
        out = {"prefill": [logits], "exact": []}
        out.update({m: [] for m in modes})
        tok = _greedy(torch, logits)
        pq_tok = dict.fromkeys(modes, tok)
        for step in range(3):
            logits, cache = serve_step(params, cfg, cache, tok, S + step)
            out["exact"].append(logits)
            tok = _greedy(torch, logits)
            for m, c in modes.items():
                lg, pq[m] = pqkv.pq_serve_step(params, cfg, pq[m], pq_tok[m],
                                               S + step, pqc=c)
                out[m].append(lg)
                pq_tok[m] = _greedy(torch, lg)
        codes = [pq[m].k_codes for m in modes] + [pq["quantize_v"].v_codes]
        runs[dev] = ({k: [t.cpu() for t in v] for k, v in out.items()},
                     [c.cpu() for c in codes])
    errs = {k: max(float((a - b).abs().max()) for a, b in
                   zip(runs["cpu"][0][k], runs["cuda"][0][k]))
            for k in runs["cpu"][0]}
    differ = sum(int((a != b).sum())
                 for a, b in zip(runs["cpu"][1], runs["cuda"][1]))
    same_input = [pqkv.compress_cache(
        {k: v.to(dev) for k, v in cpu_cache.items()}, cfg,
        modes["quantize_v"], pos=S, books=books, v_books=v_books)
        for dev in ("cpu", "cuda")]
    same_codes = all(torch.equal(getattr(same_input[0], n),
                                 getattr(same_input[1], n).cpu())
                     for n in ("k_codes", "v_codes"))
    out = {"arch": cfg.name, "prompt": S, "patches": bool(patches),
           "logits_max_abs_err": errs, "pq_codes_differing": differ,
           "pq_codes": sum(int(c.numel()) for c in runs["cpu"][1]),
           "same_cache_codes_identical": same_codes,
           "tolerance": {"atol": LOGIT_ATOL}}
    emit({"phase": "small_family_reference", **out})
    check(max(errs.values()) <= LOGIT_ATOL, f"{arch} reduced: card logits "
          f"within the tolerance of the CPU route: {errs}")
    check(same_codes, f"{arch} reduced: the same cache's codes identical on "
          "card and CPU")
    return out


def small_lm_reference(torch) -> None:
    """internlm2's reduced config with weights made on the CPU and carried
    to the card: prefill, 3 exact and 3 PQ decode steps (books fit on the
    CPU) give the CPU route's tokens, logits within ``LOGIT_ATOL`` and the
    same PQ codes."""
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve import pqkv
    from repro_torch.serve.cache import init_cache
    from repro_torch.serve.decode import serve_step
    from repro_torch.serve.prefill import prefill
    cfg = get_reduced(LM_ARCH)
    pqc = pqkv.PQKVConfig(n_sub=4, codebook_size=16, recent_window=8)
    B, S = 2, 24
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(4))
    runs = {}
    for dev in ("cpu", "cuda"):
        params = _to(torch, p_cpu, dev)
        logits, cache = prefill(params, cfg, init_cache(cfg, B, S + 4, dev),
                                {"tokens": tokens.to(dev)})
        if dev == "cpu":
            books = pqkv.fit_kv_books(cache["k"], pqc,
                                      torch.Generator().manual_seed(5), S)
        pq_cache = pqkv.compress_cache(
            {"k": cache["k"], "v": cache["v"].clone()}, cfg, pqc, pos=S,
            books=books)
        out = [logits]
        tok = pq_tok = _greedy(torch, logits)
        for g in range(3):
            logits, cache = serve_step(params, cfg, cache, tok, S + g)
            pq_logits, pq_cache = pqkv.pq_serve_step(
                params, cfg, pq_cache, pq_tok, S + g, pqc=pqc)
            out += [logits, pq_logits]
            tok, pq_tok = _greedy(torch, logits), _greedy(torch, pq_logits)
        runs[dev] = ([t.cpu() for t in out], pq_cache.k_codes.cpu())
    errs = [float((a - b).abs().max())
            for a, b in zip(runs["cpu"][0], runs["cuda"][0])]
    codes_equal = bool(torch.equal(runs["cpu"][1], runs["cuda"][1]))
    emit({"phase": "small_lm_reference", "arch": cfg.name,
          "logits_max_abs_err": max(errs), "pq_codes_identical": codes_equal,
          "tolerance": {"atol": LOGIT_ATOL}})
    check(max(errs) <= LOGIT_ATOL, "small LM: card logits within the "
          "tolerance of the CPU route")
    check(codes_equal, "small LM: PQ codes identical on card and CPU")


def _tree_bytes(torch, x) -> int:
    """Bytes of a parameter tree's tensors (NamedTuples and tuples)."""
    if x is None:
        return 0
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return sum(_tree_bytes(torch, f) for f in x)


def _to(torch, x, dev):
    """A parameter tree (NamedTuples and tuples of tensors) on ``dev``."""
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.to(dev)
    if hasattr(x, "_fields"):
        return type(x)(*(_to(torch, f, dev) for f in x))
    return tuple(_to(torch, f, dev) for f in x)


def pq_attn_phase(torch, lm, lm_launches) -> dict:
    """Row 11 on the first PQ step's layer-0 tensors (B=8, tail 1921,
    G=8, R=2, M=8, K=256, Dv=128): with the serving path's bf16 table,
    uint8 codes and bf16 values against its plain version (timed), and
    with a float32 table and values against the reference's oracle
    (dequantise, then exact softmax), both within ``PQ_ATTN_TOL``.  Its
    launches are the LM paths' (``lm_launches``, one dict a path)."""
    import torch.nn.functional as F
    from repro_torch.kernels.pq_attn.ops import (launch_pq_attn, pq_attn,
                                                 pq_attn_decode,
                                                 split_geometry)
    from repro_torch.kernels.pq_attn.ref import (pq_attn_decode_ref,
                                                 pq_attn_lut_ref,
                                                 reconstruct_keys)
    from repro_torch.serve import pqkv
    q, pos, layer = lm["q"], lm["pos"], lm["layer"]
    B, G, R, hd = q.shape
    codes, books, v = layer.k_codes, layer.k_books, layer.v
    M, K = books.shape[1], books.shape[2]
    H, W = G * R, layer.k_recent.shape[1]
    n = pos - W + 1
    scale = hd ** -0.5
    qlut = pqkv._query_table(q, books).reshape(B, H, M, K).contiguous()
    got = pq_attn(qlut, codes, v, n, scale)
    torch.cuda.synchronize()
    want, plain_ms = _sync_ms(torch, lambda: pq_attn_lut_ref(
        qlut, codes, v, n, scale))
    serve_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    serve_ok = all(bool(torch.allclose(a, b, rtol=PQ_ATTN_TOL,
                                       atol=PQ_ATTN_TOL))
                   for a, b in zip(got, want))
    q32 = q.float().reshape(B, H, hd)
    codes32, v32 = codes.to(torch.int32), v.float()
    got32 = pq_attn_decode(q32, codes32, books, v32, valid_len=n)
    want32 = pq_attn_decode_ref(q32, codes32, books, v32, valid_len=n)
    max_abs = float((got32 - want32).abs().max())
    ok32 = bool(torch.allclose(got32, want32, rtol=PQ_ATTN_TOL,
                               atol=PQ_ATTN_TOL))
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    ms = _mean_ms(torch, lambda: launch_pq_attn(qlut, codes, v, n, scale,
                                                out, m, l), REPS)
    check(torch.equal(out, got[0]) and torch.equal(m, got[1])
          and torch.equal(l, got[2]), "pq_attn: the launch alone equals the "
          "wrapper, bit for bit (the split merge is in a fixed order)")
    wrapper_ms = _mean_ms(torch, lambda: pq_attn(qlut, codes, v, n, scale),
                          REPS)
    keys = reconstruct_keys(codes[:, :n], books).to(torch.bfloat16)
    kh = keys.permute(0, 2, 1, 3).contiguous()            # (B, G, n, hd)
    vh = v[:, :n].permute(0, 2, 1, 3).contiguous()
    qh = q.reshape(B, H, 1, hd)
    library_ms = _mean_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, enable_gqa=True), REPS)
    nbytes = (B * n * G * (M + hd * v.element_size())
              + qlut.numel() * qlut.element_size() + B * H * (hd + 2) * 4)
    ops = B * H * n * (M + 4 + 2 * hd)
    bound_ms, bound_by = bound(nbytes, ops)
    chunk, n_split = split_geometry(n, B * G)
    row = {"name": "pq_attn", "route": "cuda", "source": SOURCES["pq_attn"],
           "replaces": TPU_SITES["pq_attn"],
           "launches": sum(x["pq_attn"] for x in lm_launches),
           "max_abs_err": max_abs,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "design": DESIGNS["pq_attn"], "variant": f"{n_split} splits"}
    emit({"phase": "kernel", **row, "shapes": {
              "batch": B, "tail": n, "groups": G, "reps": R, "M": M, "K": K,
              "Dv": hd, "table": str(qlut.dtype), "codes": str(codes.dtype),
              "values": str(v.dtype), "chunk": chunk, "n_split": n_split,
              "ctas": B * G * n_split},
          "wrapper_ms": wrapper_ms, "serving_types_max_abs_err": serve_err,
          "agrees": ok32 and serve_ok, "in_table": True,
          "tolerance": {"rtol": PQ_ATTN_TOL, "atol": PQ_ATTN_TOL}})
    _pq_attn_two_streams(torch, qlut, codes, v, n, scale)
    check(serve_ok, "pq_attn (bf16 table, uint8 codes, bf16 values) agrees "
          "with its plain version")
    check(ok32, "pq_attn (float32) agrees with the dequantise-then-softmax "
          "oracle")
    return row


def pq_attn_window_phase(torch, fam, lm_launches) -> dict:
    """Row 11 with a window start on gemma2's first local layer at its
    first PQ step (B=2, positions [513, 4481) of 4640, G=16, R=2, M=8,
    K=256, Dv=128): against its plain version, timed beside it and beside
    ``scaled_dot_product_attention`` over the keys reconstructed for the
    same positions.  ``launches``: the launches with ``start > 0`` (each
    also counts as ``pq_attn``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.pq_attn.ops import (launch_pq_attn, pq_attn,
                                                 split_geometry)
    from repro_torch.kernels.pq_attn.ref import (pq_attn_lut_ref,
                                                 reconstruct_keys)
    from repro_torch.serve import pqkv
    q, pos, layer, window = fam["q"], fam["pos"], fam["layer"], fam["window"]
    B, G, R, hd = q.shape
    codes, books, v = layer.k_codes, layer.k_books, layer.v
    M, K = books.shape[1], books.shape[2]
    H, W = G * R, layer.k_recent.shape[1]
    start, stop = pqkv.tail_range(pos, W, window)
    n = stop - start
    check(start > 0 and n > 0, "pq_attn[window]: a window start")
    scale = hd ** -0.5
    qlut = pqkv._query_table(q, books).reshape(B, H, M, K).contiguous()
    got = pq_attn(qlut, codes, v, stop, scale, start)
    want, plain_ms = _sync_ms(torch, lambda: pq_attn_lut_ref(
        qlut, codes, v, stop, scale, start))
    max_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
    ok = all(bool(torch.allclose(a, b, rtol=PQ_ATTN_TOL, atol=PQ_ATTN_TOL))
             for a, b in zip(got, want))
    shifted = pq_attn(qlut, codes[:, start:].contiguous(),
                      v[:, start:].contiguous(), n, scale)
    same_bits = all(torch.equal(a, b) for a, b in zip(got, shifted))
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    ms = _mean_ms(torch, lambda: launch_pq_attn(qlut, codes, v, stop, scale,
                                                out, m, l, start), REPS)
    check(torch.equal(out, got[0]) and torch.equal(m, got[1])
          and torch.equal(l, got[2]), "pq_attn[window]: the launch alone "
          "equals the wrapper, bit for bit")
    keys = reconstruct_keys(codes[:, start:stop], books).to(torch.bfloat16)
    kh = keys.permute(0, 2, 1, 3).contiguous()            # (B, G, n, hd)
    vh = v[:, start:stop].permute(0, 2, 1, 3).contiguous()
    library_ms = _mean_ms(torch, lambda: F.scaled_dot_product_attention(
        q.reshape(B, H, 1, hd), kh, vh, enable_gqa=True), REPS)
    nbytes = (B * n * G * (M + hd * v.element_size())
              + qlut.numel() * qlut.element_size() + B * H * (hd + 2) * 4)
    ops = B * H * n * (M + 4 + 2 * hd)
    bound_ms, bound_by = bound(nbytes, ops)
    chunk, n_split = split_geometry(n, B * G)
    row = {"name": "pq_attn[window]", "route": "cuda",
           "source": SOURCES["pq_attn"], "replaces": TPU_SITES["pq_attn"],
           "launches": sum(x["pq_attn[window]"] for x in lm_launches),
           "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "design": DESIGNS["pq_attn"],
           "variant": f"start {start}, {n_split} splits"}
    emit({"phase": "kernel", **row, "shapes": {
              "batch": B, "pos": pos, "window": window, "start": start,
              "stop": stop, "groups": G, "reps": R, "M": M, "K": K,
              "Dv": hd, "table": str(qlut.dtype), "codes": str(codes.dtype),
              "values": str(v.dtype), "chunk": chunk, "n_split": n_split,
              "ctas": B * G * n_split},
          "equals_shifted_prefix": same_bits, "agrees": ok,
          "in_table": True,
          "tolerance": {"rtol": PQ_ATTN_TOL, "atol": PQ_ATTN_TOL}})
    check(ok, "pq_attn[window] agrees with its plain version")
    check(same_bits, "pq_attn[window] equals the shifted prefix bit for bit")
    return row


def _pq_attn_two_streams(torch, qlut, codes, v, n, scale) -> None:
    """Row 11 launched on two streams at once with different inputs (the
    layer-0 table and its rows reversed): each launch equals its
    single-stream result bit for bit, and every stream's ticket counters
    end at 0 (each stream draws its own)."""
    from repro_torch.kernels.pq_attn import ops
    inputs = [(qlut, codes, v), (qlut.flip(0).contiguous(), codes, v)]
    want = [ops.pq_attn(*x, n, scale) for x in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = []
    for _ in range(REPS):
        for x, st in zip(inputs, streams):
            with torch.cuda.stream(st):
                got.append(ops.pq_attn(*x, n, scale))
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for k, outs in enumerate(got)
                for a, b in zip(outs, want[k % 2]))
    keys = {ops.counter_key(qlut.device, st.cuda_stream) for st in streams}
    keys.add(ops.counter_key(qlut.device,
                             torch.cuda.current_stream().cuda_stream))
    zero = all(int(ops._COUNTERS[k].abs().sum()) == 0 for k in keys)
    emit({"phase": "pq_attn_two_streams", "launches_per_stream": REPS,
          "identical": equal, "counters_at_zero": zero,
          "counter_sets": len(keys)})
    check(equal, "pq_attn on two streams equals its single-stream results")
    check(zero and len(keys) == 3, "pq_attn: every stream's counters at 0")


def full_kernel_phase(torch, ctx) -> dict:
    """Row 12 on the 7680 pairs at L=512, w=51: identical to its plain
    version (the reference kernel's sweep) and to row 1 on the same pairs.
    It computes banded DTW, so its bound counts the band's cells, as row
    1's does; ``sweep_bound_ms`` in the phase line is the same bound over
    all (2L-1) * L slots that the full-width algorithm visits (the band
    only a mask there): the algorithm's work, not the function's."""
    from repro_torch.kernels.dtw_band.ops import (full_warp_geometry,
                                                  launch_dtw_band_full)
    from repro_torch.kernels.dtw_band.ref import dtw_band_full_ref
    qq, xx, _, _, w, _ = ctx["adaptive_pairs"]
    n, L = qq.shape
    got = ctx["baseline_full"]
    want, plain_ms = _sync_ms(torch, lambda: dtw_band_full_ref(qq, xx, w))
    ok = bool(torch.equal(got, want))
    out = torch.empty(n, dtype=torch.float32, device=qq.device)
    ms = _mean_ms(torch, lambda: launch_dtw_band_full(qq, xx, w, out), REPS)
    check(torch.equal(out, got), "dtw_band_full: the launch alone equals "
          "the wrapper")
    cells, _, _ = full_warp_geometry(n, L)
    prev, prev_ms = _full_thread_form(torch, qq, xx, w)
    check(torch.equal(prev, got), "dtw_band_full: the warp form equals the "
          "thread form bit for bit")
    bound_ms, bound_by = bound((2 * n * L + n) * 4,
                               n * band_cells(L, w) * DTW_OPS_PER_CELL)
    sweep_bound_ms, _ = bound((2 * n * L + n) * 4,
                              n * (2 * L - 1) * L * DTW_OPS_PER_CELL)
    row = {"name": "dtw_band_full", "route": "cuda",
           "source": SOURCES["dtw_band_full"],
           "replaces": TPU_SITES["dtw_band_full"],
           "launches": ctx["full_launches"]["dtw_band_full"],
           "max_abs_err": float((got - want).abs().max()), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None, "design": DESIGNS["dtw_band_full"],
           "variant": f"warp ({cells} rows a lane)", "prev_ms": prev_ms}
    emit({"phase": "kernel", **row, "shapes": {"pairs": [n, L], "window": w},
          "sweep_bound_ms": sweep_bound_ms,
          "equals_dtw_band": bool(torch.equal(got,
                                              ctx["baseline_compressed"])),
          "agrees": ok, "in_table": True, "tolerance": "identical"})
    check(ok, "dtw_band_full equals its plain version")
    return row


def _full_thread_form(torch, A, B, w):
    """Row 12's thread form (the wrapper's choice beyond L = 1024)
    launched directly: its output and its ms (mean of 2 launches after
    one warm-up: about 120 ms each).  Not launches of the path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.dtw_band.ops import row_geometry
    n, L = A.shape
    out = torch.empty(n, dtype=torch.float32, device=A.device)
    threads, blocks, scratch = row_geometry(n, 2 * L, A.device)

    def launch():
        _build.check(_build.lib().pq_dtw_band_full(
            A.data_ptr(), B.data_ptr(), out.data_ptr(), _build.ptr(scratch),
            n, L, w, 0, threads, blocks, _build.stream(A.device)),
            "dtw_band_full (thread form)")
    return out, _mean_ms(torch, launch, 2)


# ---------------------------------------------------------------------------
# Agreement with the port's CPU route on a small input
# ---------------------------------------------------------------------------

def small_reference(torch) -> None:
    """A codebook trained on the CPU, carried to the card: codes and 1-NN
    predictions on the card equal those of the CPU route (which the tests
    hold against the JAX package)."""
    from repro_torch.core import knn, pq
    from repro_torch.data.timeseries import make_dataset
    X, y = make_dataset("cbf", 16, 128, seed=1)
    Q, _ = make_dataset("cbf", 4, 128, seed=2)
    cfg = pq.PQConfig(n_sub=4, codebook_size=8, kmeans_iters=2, dba_iters=1)
    cfg_exact = dataclasses.replace(cfg, exact_encode=True)
    cb_cpu = pq.fit(X, cfg, torch.Generator().manual_seed(1), device="cpu")
    cb_gpu = pq.codebook_from_numpy(pq.codebook_to_numpy(cb_cpu))
    results = {}
    for name, fn in {
        "encode": lambda cb, dev: pq.encode(X, cb, cfg, device=dev),
        "encode_exact_fused": lambda cb, dev: pq.encode(X, cb, cfg_exact,
                                                        device=dev),
        "knn_sym": lambda cb, dev: knn.knn_classify_sym(
            pq.encode(X, cb, cfg, device=dev), y, Q, cb, cfg, device=dev),
        "knn_asym": lambda cb, dev: knn.knn_classify_asym(
            pq.encode(X, cb, cfg, device=dev), y, Q, cb, cfg, device=dev),
        "nn_dtw_exact": lambda cb, dev: knn.nn_dtw_exact(X, y, Q, window=13,
                                                         device=dev),
    }.items():
        want = fn(cb_cpu, "cpu")
        got = fn(cb_gpu, None).cpu()
        results[name] = bool(torch.equal(got, want))
        check(results[name], f"small input: {name} equals the CPU route")
    emit({"phase": "small_reference", "train": list(X.shape),
          "identical": results})


# ---------------------------------------------------------------------------
# Every kernel against its plain version, on the main path's tensors
# ---------------------------------------------------------------------------

def _sync_ms(torch, fn):
    """One call timed with CUDA events (plain versions: host loops)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


def _mean_ms(torch, fn, reps):
    """Mean of ``reps`` back-to-back calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _errors(torch, got, want):
    if got.dtype in (torch.int32, torch.int64):
        diff = (got.long() - want.long()).abs()
        return float(diff.max()), 0.0, bool(diff.max() == 0)
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    ok = bool((diff <= ATOL + RTOL * want.abs()).all())
    rel = float((diff / want.abs().clamp_min(1e-30)).max())
    return float(diff.max()), rel, ok


def _device_ms(torch, launch_fn, name):
    """``launch_fn``'s own device time under ``torch.profiler``: the mean
    over the kernels it records of ``PROFILE_LAUNCHES`` launches (it may
    miss the first few; a window with no record at all is profiled again,
    ``PROFILE_ATTEMPTS`` times at most), the kernels seen and the profiles
    taken."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        prof = _profile(torch, lambda: [launch_fn()
                                        for _ in range(PROFILE_LAUNCHES)])
        _windows.append((prof["kernels"], prof["launch_to_kernel_ms"]))
        if prof["kernels"]:
            break
    n_seen = prof["kernels"]
    check(1 <= n_seen <= PROFILE_LAUNCHES, f"{name}: {n_seen} kernels under "
          f"the profiler for {PROFILE_LAUNCHES} launches ({attempt} "
          "profiles)")
    return prof["device_busy_ms"] / n_seen, n_seen, attempt


def kernel_row(torch, launches, rows, name, shapes, kernel_fn, plain_fn,
               library_fn, nbytes, ops, launch_fn=None, table=True,
               exact=False, extra=None, profiled=False):
    """Hold one kernel against its plain version and time both.
    ``launch_fn``: the launch alone, returning its output, where the
    wrapper does more than launch (a range check); ``table=False``: a
    second shape of a kernel already in the table, printed as a phase line
    only; ``exact``: the outputs must be identical (max abs error 0);
    ``extra``: more fields of the record (a redesigned row's earlier
    form); ``profiled``: also ``device_ms``, the launch's own device time under
    ``torch.profiler`` (the mean over the kernels it records of
    ``PROFILE_LAUNCHES`` launches: it may miss some; a window with no
    record at all is profiled again, ``PROFILE_ATTEMPTS`` times at most,
    counted in ``device_ms_profiles``), for launches near the host's
    launch overhead, whose ``ms`` may read that overhead."""
    got = kernel_fn()
    torch.cuda.synchronize()
    want, plain_ms = _sync_ms(torch, plain_fn)
    max_abs, max_rel, ok = _errors(torch, got, want)
    if exact:
        ok = bool(torch.equal(got, want))
    wrapper_ms = _mean_ms(torch, kernel_fn, REPS)
    ms = wrapper_ms
    if launch_fn is not None:
        check(torch.equal(launch_fn(), got),
              f"{name}: the launch alone equals the wrapper's result")
        ms = _mean_ms(torch, launch_fn, REPS)
    library_ms = (None if library_fn is None
                  else _mean_ms(torch, library_fn, REPS))
    if profiled:
        device_ms, n_seen, attempt = _device_ms(torch, launch_fn, name)
        extra = {**(extra or {}), "device_ms": device_ms,
                 "device_ms_kernels": n_seen, "device_ms_profiles": attempt}
    bound_ms, bound_by = bound(nbytes, ops)
    row = {"name": name, "route": "cuda", "source": SOURCES[name],
           "replaces": TPU_SITES[name], "launches": launches[name],
           "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, **(extra or {})}
    emit({"phase": "kernel", **row, "shapes": shapes,
          "wrapper_ms": wrapper_ms, "max_rel_err": max_rel, "agrees": ok,
          "in_table": table,
          "tolerance": ("identical" if exact or got.dtype == torch.int32
                        else {"rtol": RTOL, "atol": ATOL})})
    check(ok, f"{name} {shapes} agrees with its plain version")
    if table:
        rows.append(row)
    return got


def kernel_phases(torch, ctx) -> list:
    from repro_torch.core import pq
    from repro_torch.core.modwt import linspace01
    from repro_torch.kernels.dtw_band.ops import (cdist_bucket, dtw_band,
                                                  dtw_band_cdist,
                                                  pairs_reg_geometry)
    from repro_torch.kernels.dtw_band.ref import (dtw_band_cdist_ref,
                                                  dtw_band_ref)
    from repro_torch.kernels.pq_adc.ops import (adc_lookup, adc_sym_cdist,
                                               launch_adc_lookup,
                                               launch_adc_sym)
    from repro_torch.kernels.pq_adc.ref import (adc_lookup_ref,
                                               adc_sym_cdist_ref)
    from repro_torch.kernels.prealign_encode.ops import (encode_geometry,
                                                         prealign_encode)
    from repro_torch.kernels.prealign_encode.ref import prealign_encode_ref

    cfg, cb, D = ctx["cfg"], ctx["cb"], ctx["D"]
    Xd, Qd = ctx["Xd"], ctx["Qd"]
    # int32 and in range (checked on the main path), as the launches take
    codes, q_codes = ctx["codes"].contiguous(), ctx["q_codes"].contiguous()
    M, K, S = cb.centroids.shape
    w = cfg.window(D)
    cells = band_cells(S, w)
    segs = pq.segment(Xd, cfg)
    N, Nq = Xd.shape[0], Qd.shape[0]
    rows = []

    # the main-path rows also run on the evaluation paths: a record's
    # launches are the sum, by path in ``launches_by_path``
    paths = {"main_path": ctx["launches"], **ctx["eval_launches"],
             "serving_path": ctx["serving_launches"]}
    launches = {k: sum(p.get(k, 0) for p in paths.values())
                for k in ctx["launches"]}

    def phase(name, *args, extra=None, **kw):
        by_path = {p: counts.get(name, 0) for p, counts in paths.items()}
        return kernel_row(torch, launches, rows, name, *args,
                          extra={**(extra or {}),
                                 "launches_by_path": by_path}, **kw)

    # 1. zipped pairs: the LB-filtered encode's refine batch, the register
    # form, with the shared-memory form timed beside it
    _, _, qs, cs = pq.lb_filter_pairs(segs, cb, cfg.refine_t())
    P = qs.shape[0]
    reg = pairs_reg_geometry(P, S, w, 0)
    check(reg is not None and reg[0] == 16, "the encode's refine takes the "
          "register form at 16 slots")
    prev_ms = _pairs_shared_form_ms(torch, qs, cs, w, dtw_band(qs, cs, w))
    phase("dtw_band", {"pairs": [P, S], "window": w, "bucket": reg[0]},
          lambda: dtw_band(qs, cs, w), lambda: dtw_band_ref(qs, cs, w), None,
          (2 * P * S + P) * 4, P * cells * DTW_OPS_PER_CELL,
          extra={"design": DESIGNS["dtw_band"],
                 "variant": f"registers ({reg[0]} slots, {reg[1]} warps a "
                            "block)", "prev_ms": prev_ms})
    del qs, cs

    # 2. all pairs: a DBA k-means assignment (N segments x K centroids),
    # the register form, with the shared-memory form timed beside it
    A, B = segs[:, 0].contiguous(), cb.centroids[0].contiguous()
    bucket = cdist_bucket(w, 0, S)
    check(bucket is not None, "fit's assignment takes the register form")
    forms = _cdist_forms_ms(torch, A, B, w, bucket)
    phase("dtw_band_cdist", {"A": [N, S], "B": [K, S], "window": w,
                             "bucket": bucket},
          lambda: dtw_band_cdist(A, B, w),
          lambda: dtw_band_cdist_ref(A, B, w), None,
          (N * S + K * S + N * K) * 4, N * K * cells * DTW_OPS_PER_CELL,
          extra={"design": DESIGNS["dtw_band_cdist"],
                 "variant": f"registers ({bucket} slots)",
                 "prev_ms": forms["shared_memory_ms"]})
    del A, B

    # 2b. all pairs at the exact 1-NN's geometry (L=512, window 51, the
    # register form at 128 slots): the first queries of nn_dtw_exact
    # against the whole training set, held against the plain version; then
    # all the exact search's queries timed in both forms, and the same at
    # L=256, w=26 (64 slots)
    Qn, w_nn = Qd[:EXACT_CHECK_QUERIES].contiguous(), ctx["w_exact"]
    nn_cells = band_cells(D, w_nn)
    check(cdist_bucket(w_nn, 0, D) == 128, "the exact search's band takes "
          "the register form at 128 slots")
    phase("dtw_band_cdist", {"A": [EXACT_CHECK_QUERIES, D], "B": [N, D],
                             "window": w_nn},
          lambda: dtw_band_cdist(Qn, Xd, w_nn),
          lambda: dtw_band_cdist_ref(Qn, Xd, w_nn), None,
          (EXACT_CHECK_QUERIES * D + N * D + EXACT_CHECK_QUERIES * N) * 4,
          EXACT_CHECK_QUERIES * N * nn_cells * DTW_OPS_PER_CELL, table=False)
    for Lf, wf in ((D, w_nn), (D // 2, 26)):
        Qe = Qd[:EXACT_QUERIES, :Lf].contiguous()
        Xe = Xd[:, :Lf].contiguous()
        forms = _cdist_forms_ms(torch, Qe, Xe, wf, cdist_bucket(wf, 0, Lf))
        bound_ms, bound_by = bound(
            (EXACT_QUERIES * Lf + N * Lf + EXACT_QUERIES * N) * 4,
            EXACT_QUERIES * N * band_cells(Lf, wf) * DTW_OPS_PER_CELL)
        emit({"phase": "dtw_band_cdist_forms", "A": [EXACT_QUERIES, Lf],
              "B": [N, Lf], "window": wf, **forms, "bound_ms": bound_ms,
              "bound_by": bound_by, "wrapper_form": "registers"})
    del Xe

    # 3. symmetric ADC: query codes x training codes through the LUT, the
    # row-staged form, with the thread form and the other tiles timed
    # beside it, all equal bit for bit
    lut = cb.lut.contiguous()
    m_idx = torch.arange(M, device=lut.device)[:, None, None]
    qa, tb = q_codes.long().T[:, :, None], codes.long().T[:, None, :]
    sym_out = torch.empty((Nq, N), dtype=torch.float32, device=lut.device)
    phase("adc_sym", {"codes_a": [Nq, M], "codes_b": [N, M],
                      "lut": [M, K, K]},
          lambda: adc_sym_cdist(q_codes, codes, lut),
          lambda: adc_sym_cdist_ref(q_codes, codes, lut),
          lambda: torch.sqrt(lut[m_idx, qa, tb].sum(0).clamp_min(0.0)),
          ((Nq + N) * M + M * K * K + Nq * N) * 4, Nq * N * (M + 2),
          launch_fn=lambda: (launch_adc_sym(q_codes, codes, lut, sym_out),
                             sym_out)[1], profiled=True, exact=True,
          extra=_sym_forms(torch, "adc_sym", q_codes, codes, lut, None, None,
                           adc_sym_cdist(q_codes, codes, lut)))

    # 4. asymmetric ADC: every query's (M, K) table x training codes, the
    # row-staged form, with the table form, the other tiles and the
    # crossover in the query count timed beside it, all equal bit for bit
    luts = pq.query_lut_batch(pq.segment(Qd, cfg), cb, w, False,
                              cfg.measure()).contiguous()
    m_row = torch.arange(M, device=lut.device)[None, :]
    codes_l = codes.long()
    lookup_out = torch.empty((Nq, N), dtype=torch.float32, device=lut.device)
    phase("adc_lookup", {"qlut": [Nq, M, K], "codes": [N, M]},
          lambda: adc_lookup(codes, luts), lambda: adc_lookup_ref(codes, luts),
          lambda: torch.sqrt(luts[:, m_row, codes_l].sum(-1).clamp_min(0.0)),
          (Nq * M * K + N * M + Nq * N) * 4, Nq * N * (M + 2),
          launch_fn=lambda: (launch_adc_lookup(codes, luts, lookup_out),
                             lookup_out)[1], profiled=True, exact=True,
          extra=_lookup_forms(torch, "adc_lookup", codes, luts, None, None,
                              adc_lookup(codes, luts)))

    # 5. fused MODWT prealign + exact 1-NN encode of the training set: the
    # register form (the whole wrapper call, its per-call transpose of the
    # codebook to (M, S, K) included), the shared-memory form timed beside
    # it
    cents = cb.centroids.contiguous()
    level, tail = cfg.wavelet_level, cfg.tail(D)
    lin = linspace01(S, Xd.device)
    bucket, _ = encode_geometry(D, M, K, S, w, 0)
    check(bucket == 16, "the encode takes the register form at 16 slots")
    _, transpose_ms = _sync_ms(
        torch, lambda: cents.transpose(1, 2).contiguous())
    prev_codes, prev_ms = _prealign_shared_form(torch, Xd, cents, lin, level,
                                                tail, w)
    cur = prealign_encode(Xd, cents, level, tail, w)
    same_prev = bool(torch.equal(cur, prev_codes))
    same_main = bool(torch.equal(cur, ctx["codes_fused"]))
    phase(
        "prealign_encode", {"X": [N, D], "centroids": [M, K, S],
                            "window": w, "bucket": bucket},
        lambda: prealign_encode(Xd, cents, level, tail, w),
        lambda: prealign_encode_ref(Xd, cents, level, tail, w, None, lin),
        None, (N * D + M * K * S + N * M + S) * 4,
        N * M * K * cells * DTW_OPS_PER_CELL,
        extra={"design": DESIGNS["prealign_encode"],
               "variant": f"registers ({bucket} slots)",
               "prev_ms": prev_ms, "transpose_ms": transpose_ms,
               "equals_prev_form": same_prev,
               "equals_codes_fused": same_main})
    check(same_main, "fused codes equal the main path's exact encode")
    check(same_prev, "prealign_encode: the register form's codes equal the "
          "shared-memory form's bit for bit")
    rows.append(_lb_filter_row(torch, launches,
                               {p: c.get("lb_filter", 0)
                                for p, c in paths.items()},
                               segs, cb, cfg.refine_t()))
    return rows


def _lb_filter_row(torch, launches, by_path, segs, cb, T):
    """6. The encode's LB filter on the training set's segments (the LB
    path's shapes): ``next_lb`` within ``S * 2**-23`` relative of the
    plain version's (LB_Keogh summed in order, ``torch.sum`` in its own),
    ``cand`` equal at every rank the plain bounds decide
    (``undecided_ranks``: its neighbours lie farther apart than that, or
    are the same bound in float64).  The bound is ``portbench.roofline.lb_filter``'s
    arithmetic; no library has the step."""
    from portbench import roofline
    from repro_torch.kernels.lb_cascade.ops import filter_geometry, lb_filter
    from repro_torch.kernels.lb_cascade.ref import (filter_bounds,
                                                    lb_filter_ref,
                                                    undecided_ranks)
    N, M, S = segs.shape
    K = cb.centroids.shape[1]
    args = [t.contiguous() for t in (segs, cb.centroids, cb.env_upper,
                                     cb.env_lower)]
    cand, next_lb = lb_filter(*args, T)
    torch.cuda.synchronize()
    (want_c, want_n), plain_ms = _sync_ms(torch,
                                          lambda: lb_filter_ref(*args, T))
    rtol = S * 2.0 ** -23
    open_ = undecided_ranks(filter_bounds(*args),
                            filter_bounds(*(t.double() for t in args)), T,
                            rtol)
    diff = (next_lb.double() - want_n.double()).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want_n.double().abs().clamp_min(1e-30)).max())
    same_cand = bool(torch.equal(cand[~open_], want_c[~open_]))
    open_share = float(open_.float().mean())
    ok = (bool((diff <= rtol * want_n.double().abs()).all()) and same_cand
          and open_share < 0.01)
    ms = _mean_ms(torch, lambda: lb_filter(*args, T), REPS)
    work = roofline.lb_filter(N, M, K, S)
    bound_ms, bound_by = bound(work.nbytes, work.ops)
    kj, rows, kc, warps, chunk, smem = filter_geometry(K, S, T)
    row = {"name": "lb_filter", "route": "cuda",
           "source": SOURCES["lb_filter"], "replaces": TPU_SITES["lb_filter"],
           "launches": launches["lb_filter"], "max_abs_err": max_abs,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None,
           "design": DESIGNS["lb_filter"],
           "variant": f"{warps * rows} series x {32 * kc} centroids a stage, "
                      f"{chunk} points, {smem} B shared",
           "launches_by_path": by_path}
    emit({"phase": "kernel", **row,
          "shapes": {"segs": [N, M, S], "centroids": [M, K, S], "T": T},
          "max_rel_err": max_rel, "cand_equal_where_decided": same_cand,
          "undecided_share": open_share, "agrees": ok, "in_table": True,
          "tolerance": {"next_lb_rtol": rtol, "undecided_share_below": 0.01}})
    check(ok, f"lb_filter {[N, M, K, S, T]} agrees with its plain version")
    return row


def _sym_launcher(torch, ca, cb, table, scale, zero, out, ta=None,
                  pitch=None):
    """The symmetric scan straight through the kernel library into
    ``out``: its thread form (``ta=None``) or its row-staged form at
    ``ta`` queries a tile (and ``pitch`` words a staged row, the
    selector's by default).  Not a launch of the path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.pq_adc.ops import (TABLE_TYPES, sym_geometry,
                                               sym_thread_geometry)
    (Na, M), Nb, K = ca.shape, cb.shape[0], table.shape[1]
    lib, stream = _build.lib(), _build.stream(out.device)
    size, code = table.element_size(), TABLE_TYPES[table.dtype]
    ptrs = (ca.data_ptr(), cb.data_ptr(), table.data_ptr())
    if ta is not None:
        geo = sym_geometry(Na, Nb, M, K, size, ta=ta)
        return lambda: _build.check(lib.pq_adc_sym_rows(
            *ptrs, _build.ptr(scale), _build.ptr(zero), out.data_ptr(), Na,
            Nb, M, K, code, ta, pitch or geo.pitch, geo.chunk, geo.grid[1],
            stream), f"adc_sym (rows form, {ta} queries a tile)")
    grid_y = sym_thread_geometry(Na, Nb, M, size).grid[1]
    if scale is None:
        return lambda: _build.check(lib.pq_adc_sym(
            *ptrs, out.data_ptr(), Na, Nb, M, K, grid_y, stream),
            "adc_sym (thread form)")
    return lambda: _build.check(lib.pq_adc_sym_quant(
        *ptrs, scale.data_ptr(), zero.data_ptr(), out.data_ptr(), Na, Nb, M,
        K, code, grid_y, stream), "adc_sym_quant (thread form)")


def _sym_forms(torch, name, ca, cb, table, scale, zero, want) -> dict:
    """Rows 3 and 9's record fields beside the wrapper's form: its
    geometry (``variant``), the thread form's ``prev_ms`` (``REPS``
    launches by CUDA events) and ``prev_device_ms`` (under the profiler),
    and the row-staged form at every other tile that fits
    (``other_tiles``: ``ta`` -> its device ms) and, where the selector's
    pitch is not 1 (mod 32) words, at that pitch
    (``pitch_1_mod_32_device_ms``), each output equal to ``want`` (the
    wrapper's) bit for bit.  Not launches of the path."""
    from repro_torch.kernels.pq_adc.ops import ROWS_TA, sym_geometry
    (Na, M), Nb, K = ca.shape, cb.shape[0], table.shape[1]
    geo = sym_geometry(Na, Nb, M, K, table.element_size())
    check(geo.form == "rows", f"{name}: the path's codes take the "
          "row-staged form")
    out = torch.empty_like(want)
    launch = _sym_launcher(torch, ca, cb, table, scale, zero, out)
    prev_ms = _mean_ms(torch, launch, REPS)
    check(torch.equal(out, want), f"{name}: the thread form equals the "
          "row-staged form bit for bit")
    prev_device_ms, _, _ = _device_ms(torch, launch, f"{name} thread form")
    others = {}
    for ta in ROWS_TA:
        if ta == geo.ta:
            continue
        try:
            launch = _sym_launcher(torch, ca, cb, table, scale, zero, out, ta)
        except ValueError:  # the tile's rows do not fit
            continue
        out.zero_()
        launch()
        check(torch.equal(out, want), f"{name}: the row-staged form at {ta} "
              "queries a tile equals the wrapper's bit for bit")
        others[str(ta)] = _device_ms(torch, launch, f"{name} ta={ta}")[0]
    pitch_1 = None
    if geo.pitch % 32 != 1:
        launch = _sym_launcher(torch, ca, cb, table, scale, zero, out,
                               geo.ta, geo.pitch - 32 // geo.ta + 1)
        out.zero_()
        launch()
        check(torch.equal(out, want), f"{name}: the row-staged form at a "
              "pitch of 1 (mod 32) equals the wrapper's bit for bit")
        pitch_1 = _device_ms(torch, launch, f"{name} pitch 1 mod 32")[0]
    return {"design": DESIGNS["adc_sym"],
            "variant": {"ta": geo.ta, "chunk": geo.chunk,
                        "smem_bytes": geo.smem, "pitch_words": geo.pitch,
                        "grid": list(geo.grid)},
            "prev_ms": prev_ms, "prev_device_ms": prev_device_ms,
            "other_tiles_device_ms": others,
            "pitch_1_mod_32_device_ms": pitch_1}


def _lookup_launcher(torch, codes, q, scale, zero, out, ta=None):
    """The lookup straight through the kernel library into ``out``: its
    table form (``ta=None``) or its row-staged form at ``ta`` queries a
    tile.  Not a launch of the path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.pq_adc.ops import (TABLE_TYPES, lookup_geometry,
                                               lookup_table_geometry)
    (Nq, M, K), N = q.shape, codes.shape[0]
    lib, stream = _build.lib(), _build.stream(out.device)
    size, code = q.element_size(), TABLE_TYPES[q.dtype]
    if ta is not None:
        geo = lookup_geometry(Nq, N, M, K, size, ta=ta)
        return lambda: _build.check(lib.pq_adc_lookup_rows(
            q.data_ptr(), _build.ptr(scale), _build.ptr(zero),
            codes.data_ptr(), out.data_ptr(), Nq, N, M, K, code, ta,
            geo.pitch, geo.chunk, geo.grid[1], stream),
            f"adc_lookup (rows form, {ta} queries a tile)")
    geo = lookup_table_geometry(Nq, N, M, K, size)
    if scale is None:
        return lambda: _build.check(lib.pq_adc_lookup(
            q.data_ptr(), codes.data_ptr(), out.data_ptr(), Nq, N, M, K,
            geo.chunk, *geo.grid, stream), "adc_lookup (table form)")
    return lambda: _build.check(lib.pq_adc_lookup_quant(
        q.data_ptr(), scale.data_ptr(), zero.data_ptr(), codes.data_ptr(),
        out.data_ptr(), Nq, N, M, K, code, geo.chunk, *geo.grid, stream),
        "adc_lookup_quant (table form)")


def _lookup_forms(torch, name, codes, q, scale, zero, want) -> dict:
    """Rows 4 and 10's record fields beside the wrapper's form: its
    geometry (``variant``), the table form's ``prev_ms`` (``REPS``
    launches by CUDA events) and ``prev_device_ms`` (under the profiler),
    the row-staged form at every other tile that fits
    (``other_tiles_device_ms``), and both forms' device ms on the first
    ``Nq`` queries for each ``Nq`` of ``LOOKUP_CROSSOVER_NQ``
    (``crossover_device_ms``: ``Nq`` -> ``[table, rows]``, the rows at the
    wrapper's tile), each output equal to ``want`` (the wrapper's) bit for
    bit.  Not launches of the path."""
    from repro_torch.kernels.pq_adc.ops import (LOOKUP_ROWS_MIN_NQ, ROWS_TA,
                                               lookup_geometry)
    (Nq, M, K), N = q.shape, codes.shape[0]
    geo = lookup_geometry(Nq, N, M, K, q.element_size())
    check(geo.form == "rows", f"{name}: the path's codes take the "
          "row-staged form")
    out = torch.empty_like(want)
    launch = _lookup_launcher(torch, codes, q, scale, zero, out)
    prev_ms = _mean_ms(torch, launch, REPS)
    check(torch.equal(out, want), f"{name}: the table form equals the "
          "row-staged form bit for bit")
    prev_device_ms, _, _ = _device_ms(torch, launch, f"{name} table form")
    others = {}
    for ta in ROWS_TA:
        if ta == geo.ta:
            continue
        try:
            launch = _lookup_launcher(torch, codes, q, scale, zero, out, ta)
        except ValueError:  # the tile's rows do not fit
            continue
        out.zero_()
        launch()
        check(torch.equal(out, want), f"{name}: the row-staged form at {ta} "
              "queries a tile equals the wrapper's bit for bit")
        others[str(ta)] = _device_ms(torch, launch, f"{name} ta={ta}")[0]
    crossover = {}
    for nq in LOOKUP_CROSSOVER_NQ:
        qn = q[:nq]
        sn = None if scale is None else scale[:nq * M]
        zn = None if zero is None else zero[:nq * M]
        times = []
        for ta in (None, geo.ta):
            part = torch.empty_like(want[:nq])
            launch = _lookup_launcher(torch, codes, qn, sn, zn, part, ta)
            launch()
            check(torch.equal(part, want[:nq]), f"{name}: both forms on "
                  f"{nq} queries equal the wrapper's rows bit for bit")
            times.append(_device_ms(torch, launch,
                                    f"{name} {nq} queries")[0])
        crossover[str(nq)] = times
    return {"design": DESIGNS["adc_lookup"],
            "variant": {"ta": geo.ta, "chunk": geo.chunk,
                        "smem_bytes": geo.smem, "pitch_words": geo.pitch,
                        "grid": list(geo.grid)},
            "prev_ms": prev_ms, "prev_device_ms": prev_device_ms,
            "other_tiles_device_ms": others,
            "crossover_device_ms": crossover,
            "rows_min_nq": LOOKUP_ROWS_MIN_NQ[q.element_size()]}


def _pairs_shared_form_ms(torch, A, B, w, want) -> float:
    """``dtw_band``'s shared-memory form (the wrapper's choice where no
    register bucket holds the band, and row 1's design before the register
    form) launched directly on the same zipped pairs: its ms (``REPS``
    launches, the launch alone), its output equal to ``want`` (the register
    form's) bit for bit.  Not launches of the path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.dtw_band.ops import band_geometry
    n, L = A.shape
    threads, blocks, scratch = band_geometry(n, w, A.device)
    out = torch.empty(n, dtype=torch.float32, device=A.device)

    def launch():
        _build.check(_build.lib().pq_dtw_band(
            A.data_ptr(), B.data_ptr(), out.data_ptr(), None,
            _build.ptr(scratch), n, L, w, 0, 0.0, 0, threads, blocks,
            _build.stream(A.device)), "dtw_band (shared-memory form)")

    ms = _mean_ms(torch, launch, REPS)
    check(torch.equal(out, want), "dtw_band: the register form equals the "
          "shared-memory form bit for bit")
    return ms


def _prealign_shared_form(torch, X, cents, lin, level, tail, w,
                          measure="dtw"):
    """``prealign_encode``'s shared-memory form (the wrapper's choice where
    no register bucket holds the band) launched directly on the ``(M, K,
    S)`` codebook: its codes and its ms (``REPS`` launches).  Not launches
    of the path."""
    from repro_torch.core import measures as tmeas
    from repro_torch.kernels import _build
    from repro_torch.kernels.prealign_encode.ops import block_geometry
    spec = tmeas.resolve(measure)
    (N, D), (M, K, S) = X.shape, cents.shape
    wt = tmeas.wdtw_weights(spec, S, X.device) if spec.uses_position else None
    codes = torch.empty((N, M), dtype=torch.int32, device=X.device)
    threads = block_geometry(D, M, S, w)
    kid, param = tmeas.kernel_measure_id(spec), tmeas.kernel_param(spec)

    def launch():
        _build.check(_build.lib().pq_prealign_encode(
            X.data_ptr(), cents.data_ptr(), lin.data_ptr(), _build.ptr(wt),
            codes.data_ptr(), N, D, M, K, S, level, tail, w, kid,
            float(param), 0, threads, _build.stream(X.device)),
            "prealign_encode (shared-memory form)")
    return codes, _mean_ms(torch, launch, REPS)


def _cdist_forms_ms(torch, A, B, w, bucket) -> dict:
    """``dtw_band_cdist`` (dtw) in its two forms launched directly on the
    same inputs: the band row in registers (``bucket`` slots) and in
    shared memory; both timed in this run and equal bit for bit.  Not
    launches of the path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.dtw_band.ops import band_geometry, reg_grid
    (N, L), M = A.shape, B.shape[0]
    outs, ms = {}, {}
    stream = _build.stream(A.device)
    swap, blocks_x, blocks_y = reg_grid(N, M)
    threads, blocks, scratch = band_geometry(N * M, w, A.device)
    for form in ("registers", "shared_memory"):
        out = torch.empty((N, M), dtype=torch.float32, device=A.device)
        if form == "registers":
            def launch():
                _build.check(_build.lib().pq_dtw_band_cdist_reg(
                    A.data_ptr(), B.data_ptr(), out.data_ptr(), None, N, M,
                    L, w, 0, 0.0, bucket, int(swap), 128, blocks_x,
                    blocks_y, stream), "dtw_band_cdist (registers)")
        else:
            def launch():
                _build.check(_build.lib().pq_dtw_band_cdist(
                    A.data_ptr(), B.data_ptr(), out.data_ptr(), None,
                    _build.ptr(scratch), N, M, L, w, 0, 0.0, threads,
                    blocks, stream), "dtw_band_cdist (shared memory)")
        ms[f"{form}_ms"] = _mean_ms(torch, launch, REPS)
        outs[form] = out
    check(torch.equal(outs["registers"], outs["shared_memory"]),
          f"dtw_band_cdist: the register form ({bucket} slots) equals the "
          "shared-memory form bit for bit")
    return {**ms, "bucket": bucket, "identical": True}


def lb_refine_phases(torch, ctx, waves) -> dict:
    """``lb_refine`` against its plain version on real waves of the three
    searches: the first wave of each (the hot scan's is the table's
    record) and, for the index's hot scan and ``pruned_nn``, the first
    mixed wave, where some pairs refine and others are pruned at their
    threshold (one with filler pairs at ``thresh = -inf`` where a wave had
    them); for the serving path's padded batch, whose waves need not
    prune, the first wave with filler, where the padding rows' pairs sit
    at ``thresh = -inf``.

    The kernel's warp form (the path's, at ``w <= 255``) sums LB_Keogh in
    lane-strided partial sums and a shuffle tree, its thread form left to
    right, and the plain version as a tree, so a bound within an ulp of its
    threshold may flip its flag: flags must
    be identical apart from pairs whose bound lies within ``FLAG_TIE_REL``
    (relative) of a finite threshold, which are counted; distances are
    held to ``rtol=1e-5, atol=1e-4`` where the flags agree."""
    from repro_torch.core.dispatch import effective_window
    from repro_torch.core.lb import cascade_bound
    from repro_torch.kernels.dtw_band.ops import dtw_band
    from repro_torch.kernels.lb_cascade.ops import (launch_lb_refine,
                                                    lb_refine,
                                                    refine_variant)
    from repro_torch.kernels.lb_cascade.ref import lb_refine_ref
    by_path = {"pruned_nn": ctx["pruned_launches"]["lb_refine"],
               "index_path": ctx["index_launches"]["lb_refine"],
               "serving_path": ctx["serving_launches"]["lb_refine"]}
    launches = sum(by_path.values())
    record = None
    for name in ("hot_scan", "pruned_nn", "serving"):
        log = waves[name]
        totals = log["totals"]
        emit({"phase": "lb_refine_waves", "search": name, **totals,
              "unrefined_max_abs_err": log["unrefined_max_abs_err"][0]})
        if name == "serving":
            second = ("filler", log.get("mixed_filler", log.get("filler")))
            check(second[1] is not None,
                  f"{name}: a wave carried filler pairs")
        else:
            check(totals["pruned"] > 0,
                  f"{name}: some wave pruned pairs at their threshold")
            second = ("mixed", log.get("mixed_filler", log.get("mixed")))
            check(second[1] is not None,
                  f"{name}: a wave both refined and pruned")
        for which, args in (("first", log["first"]), second):
            table = name == "hot_scan" and which == "first"
            A, B, up, lo, th, w = args
            n, L = A.shape
            d, f = lb_refine(A, B, up, lo, th, w)
            torch.cuda.synchronize()
            (want_d, want_f), plain_ms = _sync_ms(
                torch, lambda: lb_refine_ref(A, B, up, lo, th, w))
            lb = cascade_bound(B, A, up, lo)
            check(torch.equal(want_f, lb < th),
                  "the plain flags are the plain bound's")
            flips, near = _flag_flips(torch, f, lb, th,
                                      f"lb_refine {name} {which}")
            agree = ~flips
            max_abs, max_rel, ok = _errors(torch, d[agree], want_d[agree])
            check(ok, f"lb_refine {name} {which}: distances agree where "
                  "flags agree")
            filler = th == -float("inf")
            n_refined = int(f.sum())
            n_filler = int(filler.sum())
            n_pruned = n - n_refined - n_filler
            if which == "mixed":
                check(0 < n_refined < n and n_pruned > 0,
                      f"lb_refine {name}: the mixed wave refines and prunes")
            if which == "filler":
                check(n_refined > 0 and n_filler > 0,
                      f"lb_refine {name}: the filler wave refines and "
                      "carries filler")
            # row 1 on the refined pairs: the same DP, bit for bit
            check(torch.equal(d[f], dtw_band(A[f], B[f], w)),
                  f"lb_refine {name} {which}: refined distances equal "
                  "dtw_band's bit for bit")
            d_out = torch.empty_like(d)
            flag = torch.empty(n, dtype=torch.int32, device=A.device)
            ms = _mean_ms(torch, lambda: launch_lb_refine(
                A, B, up, lo, th, w, d_out, flag), REPS)
            check(torch.equal(flag.bool(), f) and torch.equal(d_out, d),
                  f"lb_refine {name} {which}: the launch alone equals the "
                  "wrapper")
            wrapper_ms = _mean_ms(
                torch, lambda: lb_refine(A, B, up, lo, th, w), REPS)
            variant = refine_variant(effective_window(L, w))
            thread_ms = _thread_form_ms(torch, args, d, f)
            bound_ms, bound_by = bound(
                n * (16 * L + 12),
                n * 5 * L + n_refined * DTW_OPS_PER_CELL * band_cells(L, w))
            row = {"name": "lb_refine", "route": "cuda",
                   "source": SOURCES["lb_refine"],
                   "replaces": TPU_SITES["lb_refine"], "launches": launches,
                   "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None, "design": DESIGNS["lb_refine"],
                   "variant": variant, "prev_ms": thread_ms,
                   "launches_by_path": by_path}
            emit({"phase": "kernel", **row, "wave": f"{name} {which}",
                  "shapes": {"pairs": [n, L], "window": w},
                  "n_refined": n_refined, "n_pruned": n_pruned,
                  "n_filler": n_filler, "flag_ties": int(flips.sum()),
                  "near_threshold": int(near.sum()),
                  "wrapper_ms": wrapper_ms, "thread_form_ms": thread_ms,
                  "max_rel_err": max_rel, "refined_equal_dtw_band": True,
                  "agrees": ok, "in_table": table,
                  "tolerance": {"rtol": RTOL, "atol": ATOL,
                                "flag_tie_rel": FLAG_TIE_REL}})
            if name == "pruned_nn" and which == "first":
                emit({"phase": "lb_refine_pruned_wave", "pairs": [n, L],
                      "window": w, "n_refined": n_refined, "ms": ms,
                      "thread_form_ms": thread_ms, "variant": variant,
                      "bound_ms": bound_ms, "bound_by": bound_by})
            if table:
                record = row
    check(sum(waves[k]["totals"]["filler"] for k in waves) > 0,
          "some wave carried filler pairs (thresh = -inf)")
    return record


def _thread_form_ms(torch, args, d, f):
    """The thread-per-pair form of ``lb_refine`` (the wrapper's choice
    beyond ``w = 255``, PR 14's design at every band) launched directly on
    the same wave: timed for comparison within this run, its refined
    distances equal to the wrapper's.  Not a launch of the path."""
    from repro_torch.core.dispatch import effective_window
    from repro_torch.kernels import _build
    from repro_torch.kernels.dtw_band.ops import band_geometry
    A, B, up, lo, th, window = args
    n, L = A.shape
    w = effective_window(L, window)
    threads, blocks, scratch = band_geometry(n, w, A.device)
    d_out = torch.empty_like(d)
    flag = torch.empty(n, dtype=torch.int32, device=A.device)

    def launch():
        _build.check(_build.lib().pq_lb_refine(
            A.data_ptr(), B.data_ptr(), up.data_ptr(), lo.data_ptr(),
            th.data_ptr(), d_out.data_ptr(), flag.data_ptr(),
            _build.ptr(scratch), n, L, w, threads, blocks,
            _build.stream(A.device)), "lb_refine (thread form)")

    ms = _mean_ms(torch, launch, REPS)
    both = flag.bool() & f
    check(torch.equal(d_out[both], d[both]), "lb_refine: the thread form's "
          "refined distances equal the warp form's")
    return ms


def measure_sweep(torch) -> None:
    """Both DP kernels for every measure at the main path's subsequence
    geometry (S=74, w=7) and at the exact-NN geometry (L=512, w=51), plus
    the unbanded L=600 case whose band rows live in device scratch,
    ``adc_sym`` on 1024 x 6144 random codes and at edge shapes (float32,
    int8, bfloat16) in its row-staged form, bit for bit against the plain
    version and the thread form, ``adc_lookup`` / ``adc_lookup_quant``
    likewise against the plain version and both its forms (one query and
    a count under ``LOOKUP_ROWS_MIN_NQ`` take the table form), and the
    fused encode under every
    measure, its register form against the plain version and its
    shared-memory form."""
    from repro_torch.core.modwt import linspace01
    from repro_torch.kernels.dtw_band.ops import dtw_band, dtw_band_cdist
    from repro_torch.kernels.dtw_band.ref import (dtw_band_cdist_ref,
                                                  dtw_band_ref)
    from repro_torch.kernels.pq_adc.ops import (LOOKUP_ROWS_MIN_NQ, ROWS_TA,
                                               adc_lookup, adc_lookup_quant,
                                               adc_sym_cdist,
                                               adc_sym_cdist_quant,
                                               lookup_geometry, quantize_lut,
                                               sym_geometry)
    from repro_torch.kernels.pq_adc.ref import (adc_lookup_quant_ref,
                                               adc_lookup_ref,
                                               adc_sym_cdist_quant_ref,
                                               adc_sym_cdist_ref)
    from repro_torch.kernels.prealign_encode.ops import prealign_encode
    from repro_torch.kernels.prealign_encode.ref import prealign_encode_ref

    g = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    cases = []
    for L, window, n_pairs, (na, nb) in ((74, 7, 4096, (64, 64)),
                                         (512, 51, 512, (16, 32)),
                                         (600, None, 64, (8, 8))):
        measures = ("dtw", "wdtw", "erp:g=0.3", "msm:c=0.5") \
            if window is not None else ("dtw",)
        for measure in measures:
            A, B = randn(n_pairs, L), randn(n_pairs, L)
            Ac, Bc = randn(na, L), randn(nb, L)
            for form, got, want in (
                    ("zipped", dtw_band(A, B, window, measure),
                     dtw_band_ref(A, B, window, measure)),
                    ("all_pairs", dtw_band_cdist(Ac, Bc, window, measure),
                     dtw_band_cdist_ref(Ac, Bc, window, measure))):
                max_abs, max_rel, ok = _errors(torch, got, want)
                cases.append({"L": L, "window": window, "measure": measure,
                              "form": form, "max_abs_err": max_abs,
                              "max_rel_err": max_rel, "agrees": ok})
                check(ok, f"dtw_band {form} {measure} L={L} w={window}")
    # the symmetric scan: 1024 x 6144 random codes, then edge shapes (one
    # query, tiles and chunks cut short, M = 3 at K = 16, M = 16), each
    # through the wrapper's row-staged form, equal to the plain version
    # and the thread form bit for bit
    for Na, Nb, M, K, dtypes in (
            (1024, 6144, 8, 256, ("float32",)),
            (1, 6144, 8, 256, ("float32", "int8", "bfloat16")),
            (77, 301, 8, 256, ("float32", "int8", "bfloat16")),
            (9, 5, 3, 16, ("float32", "int8", "bfloat16")),
            (33, 1000, 16, 256, ("float32",))):
        lut = randn(M, K, K).abs()
        ca = torch.randint(0, K, (Na, M), generator=g, device="cuda",
                           dtype=torch.int32)
        cb = torch.randint(0, K, (Nb, M), generator=g, device="cuda",
                           dtype=torch.int32)
        for dt in dtypes:
            if dt == "float32":
                table, sc, zp = lut, None, None
                got = adc_sym_cdist(ca, cb, lut)
                want = adc_sym_cdist_ref(ca, cb, lut)
            else:
                table, sc, zp = quantize_lut(lut, dt)
                got = adc_sym_cdist_quant(ca, cb, table, sc, zp)
                want = adc_sym_cdist_quant_ref(ca, cb, table, sc, zp)
                sc, zp = sc.reshape(M).contiguous(), zp.reshape(M).contiguous()
            geo = sym_geometry(Na, Nb, M, K, table.element_size())
            prev = torch.empty_like(got)
            _sym_launcher(torch, ca, cb, table, sc, zp, prev)()
            max_abs, max_rel, _ = _errors(torch, got, want)
            ok = bool(torch.equal(got, want))
            same = bool(torch.equal(got, prev))
            cases.append({"form": "adc_sym", "dtype": dt,
                          "codes": [[Na, M], [Nb, M]], "K": K,
                          "ta": geo.ta, "max_abs_err": max_abs,
                          "max_rel_err": max_rel, "agrees": ok,
                          "equals_prev_form": same})
            check(geo.form == "rows" and ok and same,
                  f"adc_sym {dt} {Na} x {Nb}, M={M}, K={K}: the row-staged "
                  "form equals the plain version and the thread form")
    # the lookup: 1024 x 6144 random codes, then edge shapes (one query,
    # a count under LOOKUP_ROWS_MIN_NQ, tiles and chunks cut short, M = 3
    # at K = 16, M = 16), through the wrapper, equal to the plain version
    # and to both forms (the row-staged one at the largest tile that fits)
    # bit for bit
    for Nq, N, M, K, dtypes in (
            (1024, 6144, 8, 256, ("float32",)),
            (1, 6144, 8, 256, ("float32", "int8", "bfloat16")),
            (77, 301, 8, 256, ("float32", "int8", "bfloat16")),
            (301, 77, 8, 256, ("float32", "int8", "bfloat16")),
            (259, 5, 3, 16, ("float32", "int8", "bfloat16")),
            (263, 1000, 16, 256, ("float32",))):
        qlut = randn(Nq, M, K).abs()
        codes = torch.randint(0, K, (N, M), generator=g, device="cuda",
                              dtype=torch.int32)
        for dt in dtypes:
            if dt == "float32":
                table, sc, zp = qlut, None, None
                got = adc_lookup(codes, qlut)
                want = adc_lookup_ref(codes, qlut)
            else:
                table, sc, zp = quantize_lut(qlut.reshape(Nq * M, K), dt)
                table = table.reshape(Nq, M, K)
                sc, zp = sc.reshape(Nq, M, 1), zp.reshape(Nq, M, 1)
                got = adc_lookup_quant(codes, table, sc, zp)
                want = adc_lookup_quant_ref(codes, table, sc, zp)
                sc, zp = (t.reshape(-1).contiguous() for t in (sc, zp))
            geo = lookup_geometry(Nq, N, M, K, table.element_size())
            forms = {}
            for ta in (None,) + ROWS_TA:
                out = torch.empty_like(got)
                try:
                    launch = _lookup_launcher(torch, codes, table, sc, zp,
                                              out, ta)
                except ValueError:  # the tile's rows do not fit
                    continue
                launch()
                forms["table" if ta is None else "rows"] = bool(
                    torch.equal(got, out))
                if ta is not None:
                    break
            max_abs, max_rel, _ = _errors(torch, got, want)
            ok = bool(torch.equal(got, want))
            cases.append({"form": "adc_lookup", "dtype": dt,
                          "qlut": [Nq, M, K], "codes": [N, M],
                          "wrapper_form": geo.form, "ta": geo.ta,
                          "max_abs_err": max_abs, "max_rel_err": max_rel,
                          "agrees": ok, "equals_forms": forms})
            check(geo.form == ("rows" if Nq >= LOOKUP_ROWS_MIN_NQ[
                table.element_size()] else "table")
                  and ok and len(forms) == 2 and all(forms.values()),
                  f"adc_lookup {dt} {Nq} x {N}, M={M}, K={K}: the wrapper "
                  "equals the plain version and both forms")
    X = torch.cumsum(randn(128, 512), dim=1)
    cents = randn(8, 32, 74)
    lin = linspace01(74, X.device)
    for measure in ("dtw", "wdtw:g=0.1", "erp:g=0.3", "msm:c=0.5"):
        got = prealign_encode(X, cents, 3, 10, 7, measure)
        want = prealign_encode_ref(X, cents, 3, 10, 7, measure)
        prev, _ = _prealign_shared_form(torch, X, cents, lin, 3, 10, 7,
                                        measure)
        ok = bool(torch.equal(got, want))
        same = bool(torch.equal(got, prev))
        cases.append({"L": 512, "window": 7, "measure": measure,
                      "form": "prealign_encode", "agrees": ok,
                      "equals_prev_form": same})
        check(ok and same, f"prealign_encode {measure}: the register form "
              "equals the plain version and the shared-memory form")
    emit({"phase": "measure_sweep", "tolerance": {"rtol": RTOL,
                                                  "atol": ATOL},
          "cases": cases})


if __name__ == "__main__":
    sys.exit(main())
