"""A reasoned suppression silences its finding: zero findings."""


def pull(x):
    return x.item()  # repro: ignore[RS101] export path, documented
