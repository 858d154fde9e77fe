"""Fused MODWT pre-alignment + elastic 1-NN encode."""
