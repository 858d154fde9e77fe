"""Fused LB cascade + conditional banded-DTW refine over zipped pairs."""
