"""Microfacet distributions (counterpart of mitsuba_tpu/render/microfacet.py).

GGX and Beckmann with Smith shadowing and visible-normal sampling (VNDF,
Heitz 2018 for GGX), and the GTR1 helpers of the principled clearcoat
lobe. All functions work on local-frame unit vectors [N, 3].
"""
from __future__ import annotations

import torch

from ..core.frame import cross, normalize
from ..core.math import PI, TWO_PI, safe_sqrt


def ggx_d(m, alpha_u, alpha_v):
    """GGX normal distribution function D(m)."""
    cos2 = m[..., 2] ** 2
    e = m[..., 0] ** 2 / (alpha_u ** 2) + m[..., 1] ** 2 / (alpha_v ** 2) + cos2
    d = 1.0 / (PI * alpha_u * alpha_v * e * e)
    return torch.where(m[..., 2] > 0, d, 0.0)


def beckmann_d(m, alpha_u, alpha_v):
    cos2 = m[..., 2] ** 2
    c = torch.clamp(cos2, min=1e-9)
    d = torch.exp(-(m[..., 0] ** 2 / (alpha_u ** 2) + m[..., 1] ** 2 / (alpha_v ** 2)) / c) / (
        PI * alpha_u * alpha_v * c ** 2)
    return torch.where(m[..., 2] > 0, d, 0.0)


def smith_g1_ggx(v, m, alpha_u, alpha_v):
    """Smith mono-directional shadowing for GGX; 0 where v lies on the other
    side of m than of the macro surface."""
    xy_alpha_2 = (alpha_u * v[..., 0]) ** 2 + (alpha_v * v[..., 1]) ** 2
    tan_theta_alpha_2 = xy_alpha_2 / torch.clamp(v[..., 2] ** 2, min=1e-12)
    result = 2.0 / (1.0 + torch.sqrt(1.0 + tan_theta_alpha_2))
    result = torch.where(xy_alpha_2 == 0.0, 1.0, result)
    back = torch.sum(v * m, dim=-1) * v[..., 2] <= 0.0
    return torch.where(back, 0.0, result)


def ggx_sample_vndf(wi, u1, u2, alpha_u, alpha_v):
    """A normal of the GGX distribution of visible normals seen from wi
    (Heitz 2018)."""
    alpha_u = torch.as_tensor(alpha_u, dtype=torch.float32, device=wi.device)
    alpha_v = torch.as_tensor(alpha_v, dtype=torch.float32, device=wi.device)
    # stretch
    v = normalize(torch.stack([alpha_u * wi[..., 0], alpha_v * wi[..., 1], wi[..., 2]], dim=-1))
    v = torch.where(v[..., 2:3] < 0, -v, v)
    # orthonormal basis around v
    lensq = v[..., 0] ** 2 + v[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    ex = torch.zeros_like(v)
    ex[..., 0] = 1.0
    t1 = torch.where((lensq > 1e-12)[..., None],
                     torch.stack([-v[..., 1] * inv, v[..., 0] * inv, torch.zeros_like(inv)],
                                 dim=-1),
                     ex)
    t2 = cross(v, t1)
    # parameterization of the projected area
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    n = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * v
    # unstretch
    return normalize(torch.stack(
        [alpha_u * n[..., 0], alpha_v * n[..., 1], torch.clamp(n[..., 2], min=1e-6)], dim=-1))


def ggx_pdf_visible(wi, m, alpha_u, alpha_v):
    """pdf of ggx_sample_vndf: G1(wi) |wi.m| D(m) / |cos_theta_i|."""
    g1 = smith_g1_ggx(wi, m, alpha_u, alpha_v)
    d = ggx_d(m, alpha_u, alpha_v)
    return g1 * torch.abs(torch.sum(wi * m, dim=-1)) * d / torch.clamp(
        torch.abs(wi[..., 2]), min=1e-9)


def ggx_g(wi, wo, m, alpha_u, alpha_v):
    return smith_g1_ggx(wi, m, alpha_u, alpha_v) * smith_g1_ggx(wo, m, alpha_u, alpha_v)


# ---------------------------------------------------------------------------
# GTR1 (Berry): the principled BSDF's clearcoat lobe
# ---------------------------------------------------------------------------

def gtr1_d(m, alpha):
    """GTR1 normal distribution."""
    cos2 = m[..., 2] ** 2
    a2 = alpha * alpha
    res = (a2 - 1.0) / (PI * torch.log(torch.as_tensor(a2)) * (1.0 + (a2 - 1.0) * cos2))
    return torch.where(res * m[..., 2] > 1e-20, res, 0.0)


def gtr1_pdf(m, alpha):
    """Plain (not visible-normal) sampling pdf: cos_theta D."""
    return torch.where(m[..., 2] < 0.0, 0.0, m[..., 2] * gtr1_d(m, alpha))


def gtr1_sample(u1, u2, alpha):
    """Inverse-CDF sample of GTR1."""
    phi = TWO_PI * u1
    a2 = torch.as_tensor(alpha * alpha, dtype=torch.float32, device=u1.device)
    cos2 = (1.0 - torch.pow(a2, 1.0 - u2)) / (1.0 - a2)
    sin_t = safe_sqrt(1.0 - cos2)
    cos_t = safe_sqrt(cos2)
    return torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], dim=-1)


def smith_ggx1(v, m, alpha):
    """Separable Smith G1 of the clearcoat lobe."""
    a2 = alpha * alpha
    cos_t = torch.abs(v[..., 2])
    cos2 = cos_t * cos_t
    tan2 = (1.0 - cos2) / torch.clamp(cos2, min=1e-12)
    res = 2.0 / (1.0 + torch.sqrt(1.0 + a2 * tan2))
    res = torch.where(v[..., 2] == 1.0, 1.0, res)
    back = torch.sum(v * m, dim=-1) * v[..., 2] <= 0.0
    return torch.where(back, 0.0, res)
