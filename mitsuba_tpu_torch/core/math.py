"""Math constants and numerics helpers (counterpart of mitsuba_tpu/core/math.py).

The JAX package's ``lookup_rows`` (a one-hot matrix product standing in for
a gather on the TPU) has no counterpart: the one-hot product is exact, so
plain indexing gives the same values.
"""
from __future__ import annotations

import torch

PI = 3.14159265358979323846
INV_PI = 1.0 / PI
TWO_PI = 2.0 * PI
INV_TWO_PI = 1.0 / TWO_PI
FOUR_PI = 4.0 * PI
INV_FOUR_PI = 1.0 / FOUR_PI

RAY_EPSILON = 1e-4          # min-t offset for secondary rays
SHADOW_EPSILON = 1e-4
EPSILON = 1e-7
INF = float("inf")


def safe_sqrt(x):
    """sqrt clamped at 0 with a finite derivative everywhere: the where()
    keeps the value of sqrt(x) for x > 1e-12 and pins both value and
    derivative to 0 on the clamped branch."""
    return torch.where(x > 0, torch.sqrt(torch.clamp(x, min=1e-12)), 0.0)


def safe_rsqrt(x):
    return torch.where(x > 0, 1.0 / torch.sqrt(torch.clamp(x, min=1e-30)), 0.0)


def safe_div(a, b, eps=1e-20):
    """a/b with 0 where |b| < eps (masked-lane-safe division)."""
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def rcp(x):
    return 1.0 / x


def sqr(x):
    return x * x


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def mulsign(x, s):
    return torch.where(s >= 0, x, -x)


def safe_acos(x):
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def safe_asin(x):
    return torch.asin(torch.clamp(x, -1.0, 1.0))
