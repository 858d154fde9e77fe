"""LM training (counterpart of :mod:`repro.train`): the loss, AdamW and
the train step over the port's float32 masters."""
