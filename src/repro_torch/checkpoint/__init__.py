"""Persistence helpers of the port (atomic directories)."""
