"""Banded elastic cost: zipped pairs and all pairs."""
