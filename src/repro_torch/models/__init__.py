"""The LM stack's model definitions, dense family (counterpart of
:mod:`repro.models`): ``config`` (``ModelConfig``), ``layers`` and
``lm``."""
