"""float32 ``cosf`` and ``powf`` of the C library, for host scalars.

XLA's CPU backend computes float32 ``cos`` and ``pow`` with these C
library functions, which are not correctly rounded; torch's vectorised
versions differ from them in the last bit on about 1 % of inputs.  The
schedules and the optimizers' bias corrections take one such scalar per
step, so they call the same functions and give the JAX package's numbers
bit for bit.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _libm():
    name = ctypes.util.find_library("m")
    if name is None:
        raise RuntimeError("the C math library (libm) was not found")
    lib = ctypes.CDLL(name)
    lib.cosf.restype = ctypes.c_float
    lib.cosf.argtypes = [ctypes.c_float]
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return lib


def cosf(x) -> np.float32:
    return np.float32(_libm().cosf(float(np.float32(x))))


def powf(x, y) -> np.float32:
    return np.float32(_libm().powf(float(np.float32(x)), float(np.float32(y))))


def recip(c) -> np.float32:
    """The float32 reciprocal XLA multiplies by where the JAX package
    divides by a constant ``c``."""
    return np.float32(1.0) / np.float32(c)
