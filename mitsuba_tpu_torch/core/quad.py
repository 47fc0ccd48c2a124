"""Quadrature nodes and weights (counterpart of mitsuba_tpu/core/quad.py,
its Gauss-Legendre rule over an interval, which the size distributions
use): computed once on the host with numpy in float64 and returned as
float32 arrays."""
from __future__ import annotations

import numpy as np


def gauss_legendre_interval(n: int, a: float, b: float):
    """Nodes and weights scaled to [a, b]."""
    x, w = np.polynomial.legendre.leggauss(int(n))
    half = 0.5 * (b - a)
    mid = 0.5 * (b + a)
    return (mid + half * x).astype(np.float32), (half * w).astype(np.float32)
