"""LM serving, dense family (counterpart of :mod:`repro.serve`): KV cache,
batched prefill, single-token decode, and the PQ-compressed cache with
its decode step (``pqkv``)."""
