"""Synthetic datasets (numpy only), a copy of :mod:`repro.data.timeseries`."""
