"""Synthetic datasets (numpy only): copies of :mod:`repro.data.timeseries`
and :mod:`repro.data.tokens`."""
