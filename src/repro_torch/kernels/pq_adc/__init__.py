"""PQ distance scans: symmetric LUT and asymmetric query tables."""
