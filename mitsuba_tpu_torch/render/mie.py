"""Lorenz-Mie scattering solver (counterpart of mitsuba_tpu/render/mie.py,
after Mishchenko & Yang 2018).

Evaluates the complex scattering amplitudes S1 and S2, the phase
normalization Ns and the scattering and extinction cross sections Cs and Ct
of a dielectric sphere in a (possibly absorbing) host medium. The amplitude
convention is the reference's (its S1 and S2 are swapped relative to Bohren
& Huffman; mueller.mie_scatter reads this convention).

The series runs in complex64, as in the reference. Its recurrences over the
series index are Python loops over the static nmax on tensors of the
broadcast shape (cosines x radii): the caller gives nmax (mie_nmax), since
the solve is done once, when a scene is loaded, to bake a tabulated phase.
"""
from __future__ import annotations

import numpy as np
import torch

TWO_PI = 2.0 * np.pi


def mie_nmax(x_norm_max: float) -> int:
    """Series length, the stopping criterion of Mishchenko & Yang 2018."""
    return int(8 + x_norm_max + 4.05 * np.cbrt(x_norm_max))


def _j_ratio_table(z, ndown):
    """Downward recurrence of j_n(z) / j_{n-1}(z) for n = ndown-1 .. 1:
    a list whose entry n holds the ratio for index n (entry 0 unused)."""
    rcp_z = 1.0 / z
    jr = z / (2.0 * ndown + 1.0)
    out = [None] * ndown
    for n in range(ndown - 1, 0, -1):
        kn = (2.0 * n + 1.0) * rcp_z
        jr = 1.0 / (kn - jr)
        out[n] = jr
    return out


def _f32(x):
    """x rounded to float32, as a Python float: the coefficients of the
    recurrences, which the reference computes in float32."""
    return float(np.float32(x))


def _c64(x, device):
    return torch.as_tensor(x, device=device).to(torch.complex64)


def mie(wavelength, mu, radius, ior_med, ior_sph, nmax, device=None):
    """The Mie series: (S1, S2, Ns, Cs, Ct) over the broadcast shape of the
    arguments; nmax is static."""
    mu = torch.as_tensor(mu, dtype=torch.float32, device=device)
    device = mu.device
    wavelength = torch.as_tensor(wavelength, dtype=torch.float32, device=device)
    radius = torch.as_tensor(radius, dtype=torch.float32, device=device)
    ior_med = _c64(ior_med, device)
    ior_sph = _c64(ior_sph, device)

    m = ior_sph / ior_med
    kx = TWO_PI * ior_med / wavelength
    ky = TWO_PI * ior_sph / wavelength
    x = kx * radius
    y = ky * radius
    m_sq = m * m
    rcp_x = 1.0 / x
    rcp_y = 1.0 / y

    shape = torch.broadcast_shapes(mu.shape, x.shape, y.shape, m.shape)
    mu = mu.expand(shape)
    x, y = x.expand(shape), y.expand(shape)
    rcp_x, rcp_y = rcp_x.expand(shape), rcp_y.expand(shape)
    m_sq = m_sq.expand(shape)

    ndown = int(nmax + 8 * np.sqrt(nmax) + 3)
    j_ratio_x = _j_ratio_table(x, ndown)
    j_ratio_y = _j_ratio_table(y, ndown)

    i_unit = torch.tensor(1j, dtype=torch.complex64, device=device)
    jx_0 = torch.sin(x) * rcp_x
    jy_0 = torch.sin(y) * rcp_y
    h_exp = torch.exp(i_unit * x) * rcp_x
    hx_0 = -i_unit * h_exp
    hx_1 = -h_exp * (1.0 + i_unit * rcp_x)

    pi_0 = torch.zeros(shape, dtype=torch.float32, device=device)
    pi_1 = torch.ones(shape, dtype=torch.float32, device=device)
    S1 = torch.zeros(shape, dtype=torch.complex64, device=device)
    S2 = torch.zeros(shape, dtype=torch.complex64, device=device)
    Ns = torch.zeros(shape, dtype=torch.float32, device=device)
    Cs = torch.zeros(shape, dtype=torch.float32, device=device)
    Ct = torch.zeros(shape, dtype=torch.float32, device=device)
    zero_c = torch.zeros((), dtype=torch.complex64, device=device)

    for n in range(1, nmax + 1):
        fn = float(n)
        jrx, jry = j_ratio_x[n], j_ratio_y[n]
        if n == 1:
            hx_n = hx_1
            hx_dx = x * hx_0 - fn * hx_1
        else:
            # Hankel upward recurrence
            hx_n = (2.0 * fn - 1.0) * rcp_x * hx_1 - hx_0
            hx_dx = x * hx_1 - fn * hx_n
            hx_0, hx_1 = hx_1, hx_n

        jx_n = jrx * jx_0
        jy_n = jry * jy_0
        jx_dx = x * jx_0 - fn * jx_n
        jy_dy = y * jy_0 - fn * jy_n

        # angle functions from the Legendre recurrence (Bohren & Huffman p. 95)
        if n == 1:
            pi_n = pi_1
            tau_n = mu
        else:
            pi_n = _f32((2.0 * fn - 1.0) / (fn - 1.0)) * mu * pi_1 - _f32(fn / (fn - 1.0)) * pi_0
            tau_n = fn * mu * pi_n - (fn + 1.0) * pi_1
            pi_0, pi_1 = pi_1, pi_n

        # Lorenz-Mie coefficients (Mishchenko & Yang, Eqs. 9-10)
        a_n = (m_sq * jy_n * jx_dx - jx_n * jy_dy) / (m_sq * jy_n * hx_dx - hx_n * jy_dy)
        b_n = (jy_n * jx_dx - jx_n * jy_dy) / (jy_n * hx_dx - hx_n * jy_dy)
        bad = (torch.isnan(a_n.real) | torch.isnan(a_n.imag)
               | torch.isnan(b_n.real) | torch.isnan(b_n.imag))
        a_n = torch.where(bad, zero_c, a_n)
        b_n = torch.where(bad, zero_c, b_n)

        cn = 2.0 * fn + 1.0
        kn = _f32(cn / (fn * (fn + 1.0)))
        S1 = S1 + kn * (a_n * tau_n + b_n * pi_n)
        S2 = S2 + kn * (a_n * pi_n + b_n * tau_n)
        sq = a_n.real ** 2 + a_n.imag ** 2 + b_n.real ** 2 + b_n.imag ** 2
        Ns = Ns + cn * sq
        Cs = Cs + cn * sq
        Ct = Ct + (cn * (a_n + b_n)).real

        jx_0, jy_0 = jx_n, jy_n

    S1 = S1 * (i_unit / kx)
    S2 = S2 * (i_unit / kx)
    k = TWO_PI / (kx.real ** 2 + kx.imag ** 2)
    return S1, S2, Ns * k, Cs * k, Ct * k
