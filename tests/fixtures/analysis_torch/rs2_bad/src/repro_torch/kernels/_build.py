"""Mini kernel library loader."""

import ctypes


def lib():
    return ctypes.CDLL("libmini.so")


def stream(device):
    del device
    return 0
