"""Fresnel equations (counterpart of mitsuba_tpu/render/fresnel.py): the
unpolarized reflectance of a real dielectric interface and of a conductor
of complex index eta - i k, the polarized complex amplitudes (the Mueller
matrices of specular reflection and transmission), and the diffuse
Fresnel reflectance's polynomial fit.

Complex amplitudes are ``torch.complex64``, as the reference's jnp.complex64.
"""
from __future__ import annotations

import torch

from ..core.math import safe_sqrt


def fresnel(cos_theta_i, eta):
    """Unpolarized Fresnel reflectance at a real dielectric interface of
    relative IOR eta (inside over outside); cos_theta_i is signed
    (positive outside). Returns (F, cos_theta_t, eta_it, eta_ti)."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=cos_theta_i.device)
    outside = cos_theta_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)

    cos_theta_t_sqr = 1.0 - eta_ti * eta_ti * (1.0 - cos_theta_i * cos_theta_i)
    cos_theta_i_abs = torch.abs(cos_theta_i)
    cos_theta_t_abs = safe_sqrt(cos_theta_t_sqr)

    index_matched = eta == 1.0
    tir = cos_theta_t_sqr <= 0.0

    a_s = (cos_theta_i_abs - eta_it * cos_theta_t_abs) / torch.clamp(
        cos_theta_i_abs + eta_it * cos_theta_t_abs, min=1e-12)
    a_p = (eta_it * cos_theta_i_abs - cos_theta_t_abs) / torch.clamp(
        eta_it * cos_theta_i_abs + cos_theta_t_abs, min=1e-12)

    r = 0.5 * (a_s * a_s + a_p * a_p)
    r = torch.where(index_matched, 0.0, torch.where(tir, 1.0, r))
    cos_theta_t = torch.where(tir, 0.0, -torch.sign(cos_theta_i) * cos_theta_t_abs)
    return r, cos_theta_t, eta_it, eta_ti


def fresnel_conductor(cos_theta_i, eta, k):
    """Unpolarized Fresnel reflectance of a conductor of complex relative
    IOR eta - i k (cos_theta_i >= 0); eta and k broadcast against it (one
    value per channel)."""
    cos_theta_i_2 = cos_theta_i * cos_theta_i
    sin_theta_i_2 = 1.0 - cos_theta_i_2
    sin_theta_i_4 = sin_theta_i_2 * sin_theta_i_2

    eta_2 = eta * eta
    k_2 = k * k

    temp_1 = eta_2 - k_2 - sin_theta_i_2
    a_2_pb_2 = safe_sqrt(temp_1 * temp_1 + 4.0 * eta_2 * k_2)
    a = safe_sqrt(0.5 * (a_2_pb_2 + temp_1))

    term_1 = a_2_pb_2 + cos_theta_i_2
    term_2 = 2.0 * a * cos_theta_i
    r_s = (term_1 - term_2) / torch.clamp(term_1 + term_2, min=1e-12)

    term_3 = a_2_pb_2 * cos_theta_i_2 + sin_theta_i_4
    term_4 = term_2 * sin_theta_i_2
    r_p = r_s * (term_3 - term_4) / torch.clamp(term_3 + term_4, min=1e-12)

    return 0.5 * (r_s + r_p)


def fresnel_diffuse_reflectance(eta):
    """The hemispherical (diffuse) Fresnel reflectance at relative IOR
    eta, as the reference's polynomial fits: Egan and Hilgeman's below
    eta = 1, d'Eon and Irving's above."""
    eta = torch.as_tensor(eta, dtype=torch.float32)
    inv_eta = 1.0 / eta
    approx_lo = -1.4399 * eta * eta + 0.7099 * eta + 0.6681 + 0.0636 * inv_eta
    inv_eta_2 = inv_eta * inv_eta
    inv_eta_3 = inv_eta_2 * inv_eta
    inv_eta_4 = inv_eta_3 * inv_eta
    inv_eta_5 = inv_eta_4 * inv_eta
    approx_hi = (0.919317 - 3.4793 * inv_eta + 6.75335 * inv_eta_2 - 7.80989 * inv_eta_3
                 + 4.98554 * inv_eta_4 - 1.36881 * inv_eta_5)
    return torch.where(eta < 1.0, approx_lo, approx_hi)


def _mulsign_c(z, s):
    return torch.where(s >= 0, z, -z)


def fresnel_polarized(cos_theta_i, eta):
    """Complex polarized Fresnel amplitudes (Verdet convention) at an
    interface of relative IOR eta (real or complex; a real eta is the
    dielectric case, total internal reflection included). Returns
    (a_s, a_p, cos_theta_t_signed, eta_it, eta_ti), a_s and a_p complex64."""
    cos_theta_i = torch.as_tensor(cos_theta_i, dtype=torch.float32)
    eta = torch.as_tensor(eta, device=cos_theta_i.device).to(torch.complex64)
    # the kappa sign convention: a positive imaginary part is conjugated
    eta = torch.where(eta.imag > 0, eta.conj(), eta)

    outside = cos_theta_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)

    cos_theta_t_sqr = 1.0 - eta_ti * eta_ti * (1.0 - cos_theta_i * cos_theta_i).to(torch.complex64)
    cos_theta_i_abs = torch.abs(cos_theta_i)
    cos_theta_t = torch.sqrt(cos_theta_t_sqr)
    # the sign of the root (Clarke, "Stellar Polarimetry", A.2)
    cos_theta_t = _mulsign_c(cos_theta_t, cos_theta_t_sqr.real)

    a_s = (cos_theta_i_abs - eta_it * cos_theta_t) / (cos_theta_i_abs + eta_it * cos_theta_t)
    a_p = (eta_it * cos_theta_i_abs - cos_theta_t) / (eta_it * cos_theta_i_abs + cos_theta_t)

    sq_norm = eta.real ** 2 + eta.imag ** 2
    index_matched = (sq_norm == 1.0) & (eta.imag == 0.0)
    bad = index_matched | (sq_norm == 0.0)
    zero = torch.zeros((), dtype=torch.complex64, device=a_s.device)
    a_s = torch.where(bad, zero, a_s)
    a_p = torch.where(bad, zero, a_p)

    cos_theta_t_signed = torch.where(
        cos_theta_t_sqr.real >= 0.0,
        -torch.sign(cos_theta_i) * torch.abs(cos_theta_t.real),
        0.0,
    )
    return a_s, a_p, cos_theta_t_signed, eta_it, eta_ti
