"""Sampling warps (counterpart of mitsuba_tpu/core/warp.py): the concentric
disk, the cosine hemisphere, the uniform triangle, the tent, the uniform
sphere, the Henyey-Greenstein lobe and the Rayleigh lobe.

Inputs carry a trailing dimension of 2 (or none, for 1D warps) and
broadcast over the leading wavefront axes; there is no data-dependent
control flow.
"""
from __future__ import annotations

import math

import torch

from .math import INV_FOUR_PI, INV_PI, TWO_PI, safe_sqrt


def square_to_uniform_disk_concentric(u):
    """Concentric (Shirley) square-to-disk mapping."""
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_x = torch.abs(x) > torch.abs(y)
    r = torch.where(quadrant_x, x, y)
    ratio = torch.where(
        quadrant_x,
        y / torch.where(x == 0, 1.0, x),
        x / torch.where(y == 0, 1.0, y),
    )
    phi = torch.where(
        quadrant_x, 0.25 * math.pi * ratio, 0.5 * math.pi - 0.25 * math.pi * ratio
    )
    phi = torch.where(is_zero, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_cosine_hemisphere(u):
    """Cosine-weighted hemisphere: concentric disk, then projection."""
    p = square_to_uniform_disk_concentric(u)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return torch.stack([p[..., 0], p[..., 1], z], dim=-1)


def square_to_cosine_hemisphere_pdf(d):
    return torch.clamp(d[..., 2], min=0.0) * INV_PI


def square_to_uniform_triangle(u):
    """Uniform barycentric coordinates on the unit triangle."""
    t = safe_sqrt(1.0 - u[..., 0])
    return torch.stack([1.0 - t, t * u[..., 1]], dim=-1)


def interval_to_tent(u):
    """[0,1] -> [-1,1] tent distribution."""
    u2 = 2.0 * u
    side = u2 < 1.0
    return torch.where(
        side,
        torch.sqrt(torch.clamp(u2, min=0.0)) - 1.0,
        1.0 - torch.sqrt(torch.clamp(2.0 - u2, min=0.0)),
    )


def square_to_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 1]
    r = safe_sqrt(1.0 - z * z)
    phi = TWO_PI * u[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_hg(u, g):
    """Henyey-Greenstein direction around +z (the forward axis); |g| below
    1e-3 takes the isotropic limit of the inverse cdf."""
    g = torch.as_tensor(g, dtype=torch.float32, device=u.device)
    tiny = torch.abs(g) < 1e-3
    g_safe = torch.where(tiny, 0.5, g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u[..., 1])
    cos_theta_hg = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    cos_theta_iso = 2.0 * u[..., 1] - 1.0
    cos_theta = torch.where(tiny, cos_theta_iso, torch.clamp(cos_theta_hg, -1.0, 1.0))
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = TWO_PI * u[..., 0]
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def square_to_hg_pdf(d, g):
    """HG density of direction d about the +z axis."""
    cos_theta = d[..., 2]
    temp = 1.0 + g * g - 2.0 * g * cos_theta
    return INV_FOUR_PI * (1.0 - g * g) / torch.clamp(temp * safe_sqrt(temp), min=1e-12)


def square_to_rayleigh(u):
    """A direction about +z whose cos(theta) follows the unpolarized
    Rayleigh phase 3/(16 pi) (1 + cos^2): the closed-form inverse cdf
    (Cardano)."""
    z = 2.0 * (2.0 * u[..., 1] - 1.0)
    a = _cbrt(z + torch.sqrt(z * z + 1.0))
    cos_theta = torch.clamp(a - 1.0 / a, -1.0, 1.0)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = TWO_PI * u[..., 0]
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def square_to_rayleigh_pdf(d):
    cos_theta = d[..., 2]
    return (3.0 / (16.0 * math.pi)) * (1.0 + cos_theta * cos_theta)


def _cbrt(x):
    """The real cube root (torch has none): sign(x) |x|^(1/3)."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
