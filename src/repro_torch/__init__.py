"""PQDTW in PyTorch — the port of :mod:`repro` to one NVIDIA H100.

The paper's main path (DBA k-means codebooks + symmetric LUT, LB-filtered
or fused MODWT encoding, symmetric/asymmetric PQ distances, 1-NN) runs on
the card through four hand-written CUDA kernels under
``repro_torch/kernels/csrc``.  Every kernel has a plain PyTorch version
beside it; a wrapper takes that version only for tensors on the CPU.

Entry points (``fit``, ``encode``, ``cdist_sym``, ``cdist_asym``,
``knn_classify_*``, ``nn_dtw_exact``) run on ``cuda`` unless the caller
passes ``device="cpu"``; with no card and no explicit CPU request they
raise.

The LM stack (``models``, ``serve``, ``launch.serve``) serves the
dense, moe and vlm families with an exact or PQ-compressed KV cache on
the card, the PQ decode attention through the ``pq_attn`` kernel, and
the ssm, hybrid and encdec families token by token, in plain PyTorch.

Float32 products on the card stay in full float32: TF32 would break the
parity of ``euclidean_sq`` and of every ADC sum with the reference.  bf16
products accumulate in float32 without reduced-precision partial sums,
as the reference's ``preferred_element_type`` products do.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
