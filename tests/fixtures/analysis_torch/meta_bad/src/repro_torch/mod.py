"""Suppression hygiene seeds: reasonless ignore + unused ignore."""


def pull(x):
    return x.item()  # repro: ignore[RS101]


def fine(x):
    return x + 1  # repro: ignore[RS303] nothing here matches
