"""Architecture configs (copied as data from :mod:`repro.configs`):
``registry.get_config(arch)`` / ``get_reduced(arch)`` for every
``--arch`` id."""
