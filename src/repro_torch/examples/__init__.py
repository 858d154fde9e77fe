"""Ports of the JAX package's examples (``examples/``), run as

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.clustering [--device cpu]
    python -m repro_torch.examples.nn_classification [--measure M] \
        [--device cpu]

On the card by default; ``--device cpu`` runs the plain versions.
"""
