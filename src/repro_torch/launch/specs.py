"""Abstract inputs, parameters, train state and caches of every (arch x
shape) cell (counterpart of :mod:`repro.launch.specs`): tensors on
``torch.device("meta")``, which carry a shape and a dtype and allocate
nothing.

The reference builds them with ``jax.eval_shape``; here the port's own
constructors run under :class:`meta_factories`, which sends every factory
call to the meta device and drops the random generator (meta tensors
hold no values).  :func:`reference_layout` restacks a port tree's
per-layer leaves into the reference's stacked layout (a leading layer
axis; gemma2's ``(L/2, 2)`` pairs; the hybrid's ``(L / attn_every,
attn_every)`` groups, in the parameters and in the cache's SSM states),
so that both packages' leaves can be compared by field path.

>>> from repro_torch.configs.registry import SHAPES, get_config
>>> cfg = get_config("internlm2-1.8b")
>>> batch = input_specs(cfg, SHAPES["train_4k"])
>>> {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in batch.items()}
... # doctest: +NORMALIZE_WHITESPACE
{'tokens': ((256, 4096), torch.int32, 'meta'),
 'labels': ((256, 4096), torch.int32, 'meta')}
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.overrides import TorchFunctionMode

from .._tree import leaves_with_paths
from ..configs.registry import ShapeSpec
from ..models.config import ModelConfig
from ..serve.cache import init_cache

__all__ = ["META", "meta_factories", "input_specs", "abstract_cache",
           "abstract_pq_cache", "abstract_params", "abstract_train_state",
           "reference_layout"]

META = torch.device("meta")

_RANDOM = {torch.randn, torch.rand, torch.randint, torch.normal,
           torch.randperm, torch.randn_like, torch.rand_like,
           torch.randint_like}
_FACTORIES = _RANDOM | {torch.zeros, torch.ones, torch.empty, torch.full,
                        torch.arange, torch.tensor, torch.eye,
                        torch.linspace}


class meta_factories(TorchFunctionMode):
    """Inside the block every factory call makes a meta tensor (its
    ``generator`` dropped), and ``Tensor.to`` keeps a meta tensor on the
    meta device, so the port's constructors build abstract trees."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _FACTORIES:
            kwargs["device"] = META
            kwargs.pop("generator", None)
            if func in (torch.randn_like, torch.rand_like,
                        torch.randint_like):
                kwargs.pop("device")
        elif func is torch.Tensor.to and args and args[0].is_meta:
            dtype = kwargs.get("dtype")
            for a in args[1:]:
                if isinstance(a, torch.dtype):
                    dtype = a
                elif isinstance(a, torch.Tensor):
                    dtype = a.dtype
            return args[0].to(device=META, dtype=dtype or args[0].dtype)
        elif getattr(func, "__name__", "") in ("normal_", "uniform_",
                                                "random_"):
            kwargs.pop("generator", None)
        return func(*args, **kwargs)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Abstract model inputs for one cell: ``tokens`` (and ``labels`` for
    train) ``(B, S)`` int32; a vlm's ``patches`` and an encdec's
    ``frames`` ``(B, n_frontend_tokens, d)`` float32; a decode cell's
    ``token (B, 1)`` and scalar ``pos`` int32."""
    B, S = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)

    if shape.kind == "train":
        batch = {"tokens": spec((B, S), torch.int32),
                 "labels": spec((B, S), torch.int32)}
    elif shape.kind == "prefill":
        batch = {"tokens": spec((B, S), torch.int32)}
    elif shape.kind == "decode":
        return {"token": spec((B, 1), torch.int32),
                "pos": spec((), torch.int32)}
    else:
        raise ValueError(shape.kind)
    extra = {"vlm": "patches", "encdec": "frames"}.get(cfg.family)
    if extra:
        batch[extra] = spec((B, cfg.n_frontend_tokens, cfg.d_model),
                            torch.float32)
    return batch


def abstract_cache(cfg: ModelConfig, shape: ShapeSpec):
    """Abstract KV / state cache of a decode cell."""
    return init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def abstract_pq_cache(cfg: ModelConfig, shape: ShapeSpec, pqc):
    """Abstract PQ-compressed cache, its codebooks included."""
    from ..serve.pqkv import init_pq_cache
    L, G = cfg.n_layers, cfg.n_kv_heads
    hd, M, K = cfg.head_dim_, pqc.n_sub, pqc.codebook_size
    books = torch.empty((L, G, M, K, hd // M), dtype=torch.float32,
                        device=META)
    return init_pq_cache(cfg, pqc, shape.global_batch, shape.seq_len, books,
                         device=META,
                         v_books=books if pqc.quantize_v else None)


def abstract_params(cfg: ModelConfig):
    """The family's parameters as float32, the reference's init dtype."""
    from ..train.step import model_init
    with meta_factories():
        return model_init(cfg)(cfg, torch.Generator(), META,
                               dtype=torch.float32)


def abstract_train_state(cfg: ModelConfig):
    """``TrainState``: float32 masters, moments and int32 counters."""
    from ..train.step import init_train_state
    with meta_factories():
        return init_train_state(torch.Generator(), cfg, META)


_BLOCKS = ("blocks", "enc_blocks", "dec_blocks")
_HYBRID_STATES = ("ssd", "conv_x", "conv_B", "conv_C")


def _lead(cfg: ModelConfig, field: str) -> Tuple[int, ...]:
    n = cfg.n_enc_layers if field == "enc_blocks" else cfg.n_layers
    if field == "blocks" and cfg.local_global:
        return (n // 2, 2)
    if field == "blocks" and cfg.family == "hybrid":
        return (n // cfg.attn_every, cfg.attn_every)
    return (n,)


def reference_layout(tree, cfg: ModelConfig
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{path: (shape, dtype)}`` of a port tree (parameters, a train
    state, a cache or a PQ cache) in the reference's layout: per-layer
    leaves under ``blocks`` / ``enc_blocks`` / ``dec_blocks`` stacked
    along :func:`_lead`'s axes, a hybrid cache's SSM states grouped.
    Paths join field names with ``/``."""
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    for path, leaf in leaves_with_paths(tree):
        names = [str(k) for k in path]
        for i, k in enumerate(path):
            if k in _BLOCKS and i + 1 < len(path):
                del names[i + 1]                 # the layer index
                shape = _lead(cfg, k) + tuple(leaf.shape)
                break
        else:
            shape = tuple(leaf.shape)
            if (cfg.family == "hybrid" and names[-1] in _HYBRID_STATES
                    and isinstance(tree, dict)):
                g = cfg.attn_every
                shape = (shape[0] // g, g) + shape[1:]
        out["/".join(names)] = (shape, leaf.dtype)
    return out
