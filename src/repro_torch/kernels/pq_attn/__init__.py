"""Decode attention against a PQ-coded key cache (flash-ADC)."""
