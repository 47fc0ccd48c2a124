"""Polarized plane-parallel adding-doubling solver (numpy, deterministic):
the port's own copy of mitsuba_tpu/utils/doubling.py, which the port does
not import.

Independent multi-scattering reference for the Rayleigh-slab problem the
Coulson-Dave-Sekera (1960) tables tabulate — the canonical validation target
of this fork's polarized atmospheric domain (reference:
src/integrators/tests/test_ad_volpathaos.py validates against in-process
renders; the CDS tables themselves are not retrievable offline).  The
doubling method (van de Hulst 1963; Hansen & Travis 1974, Space Sci. Rev.
16, 527, §5) reproduces those tables to publication precision and shares no
code or algorithm with the Monte Carlo transport it validates here.

Scope: homogeneous slab, Rayleigh scattering (optional depolarization),
single-scatter albedo omega, collimated zenith illumination (mu0 = 1 -> the
problem is azimuthally symmetric and only the m = 0 Fourier mode is
nonzero; U = V = 0).  Stokes components (I, Q) with Q defined w.r.t. the
meridian plane, Q < 0 = polarized perpendicular to it (Chandrasekhar's
convention via the Mueller rotation sign used below, matching the
renderer's sensor basis — see tests/test_rayleigh_slab_gold.py).

Conventions:
  * beam irradiance F0 = 1 measured perpendicular to the beam (the
    `directional` emitter's `irradiance` parameter).
  * R/T supermatrices act on diffuse radiance: I_out_i = sum_j M_ij I_in_j
    with the 2 mu_j w_j quadrature absorbed into M.
  * T includes the direct (exponential) attenuation of diffuse streams on
    its diagonal, which keeps the doubling recursion in its simplest form:
        R' = R + T R (1 - R R)^-1 T
        T' = T (1 - R R)^-1 T
    (Hansen & Travis 1974, eqs. 35-40, specialized to identical
    homogeneous sublayers).
  * beam source vectors r, t (diffuse radiance per unit F0) combine as
        D  = (1 - R R)^-1 (t + R r e)        downward diffuse at interface
        U  = R D + r e                        upward diffuse at interface
        r' = r + T U,  t' = T D + t e,  e' = e^2
    with e = exp(-tau_layer / mu0).
"""
from __future__ import annotations

import numpy as np


def rayleigh_F(cos_t, depolarization=0.0):
    """4x4 Rayleigh scattering matrix w.r.t. the scattering plane,
    normalized so that \\int F11 dOmega = 4 pi (phase function mean 1).
    With depolarization rho, the standard Chandrasekhar mixture
    (reference: mueller.h:311-328 rayleigh_scatter)."""
    cos_t = np.asarray(cos_t, np.float64)
    rho = float(depolarization)
    D = (1.0 - rho) / (1.0 + rho / 2.0)
    c2 = cos_t * cos_t
    s2 = 1.0 - c2
    F = np.zeros(cos_t.shape + (4, 4))
    a = 0.75 * (1.0 + c2)
    b = -0.75 * s2
    c = 1.5 * cos_t
    # polarized part scaled by D, isotropic remainder (1 - D) on I->I
    F[..., 0, 0] = D * a + (1.0 - D)
    F[..., 0, 1] = D * b
    F[..., 1, 0] = D * b
    F[..., 1, 1] = D * a
    F[..., 2, 2] = D * c
    F[..., 3, 3] = D * 1.5 * cos_t  # V: (1-3rho)/(1-rho) factor omitted (V=0 here)
    return F


def _rot(c2s, s2s):
    """Stokes rotation by angle s with cos(2s)=c2s, sin(2s)=s2s (batched)."""
    R = np.zeros(np.shape(c2s) + (4, 4))
    R[..., 0, 0] = 1.0
    R[..., 3, 3] = 1.0
    R[..., 1, 1] = c2s
    R[..., 1, 2] = s2s
    R[..., 2, 1] = -s2s
    R[..., 2, 2] = c2s
    return R


def _meridian_basis(w):
    """(e_perp, e_par) basis of the meridian plane of propagation direction
    w: e_par lies in the plane containing w and z, e_perp = z x w normalized.
    Q > 0 along e_par (in-meridian polarization)."""
    z = np.zeros_like(w)
    z[..., 2] = 1.0
    perp = np.cross(z, w)
    n = np.linalg.norm(perp, axis=-1, keepdims=True)
    # w parallel to z: pick x as the azimuth origin
    fallback = np.zeros_like(w)
    fallback[..., 1] = 1.0   # e_perp = y for the zenith beam (phi = 0 meridian)
    perp = np.where(n > 1e-12, perp / np.maximum(n, 1e-12), fallback)
    par = np.cross(w, perp)
    return perp, par


def rotated_Z(w_out, w_in, depolarization=0.0):
    """Phase (Mueller) matrix for scattering from propagation direction w_in
    to w_out, with incoming Stokes in w_in's meridian basis and outgoing in
    w_out's meridian basis (batched over leading dims)."""
    cos_t = np.sum(w_out * w_in, axis=-1)
    F = rayleigh_F(np.clip(cos_t, -1.0, 1.0), depolarization)

    # scattering plane normal
    nsc = np.cross(w_in, w_out)
    nn = np.linalg.norm(nsc, axis=-1, keepdims=True)
    degenerate = (nn < 1e-9)[..., 0]
    nsc = np.where(nn > 1e-9, nsc / np.maximum(nn, 1e-9), nsc)

    out = np.empty(F.shape)
    for (w, side) in ((w_in, "in"), (w_out, "out")):
        perp, par = _meridian_basis(w)
        # rotation angle s from meridian basis to scattering basis
        # (scattering-plane perp = nsc): cos s = e_perp . nsc_perp ...
        cs = np.sum(perp * nsc, axis=-1)
        sn = np.sum(par * nsc, axis=-1)
        c2s = cs * cs - sn * sn
        s2s = 2.0 * sn * cs
        if side == "in":
            Rin = _rot(c2s, s2s)
        else:
            Rout = _rot(c2s, -s2s)
    Z = Rout @ F @ Rin
    # forward/backward scattering: no rotation needed (F is diagonal-ish
    # and the meridian bases coincide up to the degenerate normal)
    Zdeg = F
    return np.where(degenerate[..., None, None], Zdeg, Z)


def _z0_block(mu_out, up_out, mu_in, up_in, nphi=64, depolarization=0.0):
    """Azimuth-averaged 2x2 (I, Q) phase-matrix block between direction
    cones: (1/2pi) \\int Z(w_out(phi_rel), w_in(0)) dphi_rel.
    mu_* in (0, 1]; up_* selects the hemisphere (z component sign)."""
    phis = (np.arange(nphi) + 0.5) / nphi * 2.0 * np.pi
    s_in = np.sqrt(np.maximum(0.0, 1.0 - mu_in**2))
    s_out = np.sqrt(np.maximum(0.0, 1.0 - mu_out**2))
    w_in = np.array([s_in, 0.0, (1.0 if up_in else -1.0) * mu_in])
    w_out = np.stack(
        [
            s_out * np.cos(phis), s_out * np.sin(phis),
            np.full(nphi, (1.0 if up_out else -1.0) * mu_out),
        ],
        axis=-1,
    )
    Z = rotated_Z(w_out, np.broadcast_to(w_in, w_out.shape),
                  depolarization)          # [nphi, 4, 4]
    Z0 = Z.mean(axis=0)
    return Z0[:2, :2]


def doubling_slab(tau, mu_view, omega=1.0, depolarization=0.0, n_gauss=24,
                  nphi=64, dtau0=1e-6):
    """Reflected and transmitted diffuse (I, Q) of a homogeneous Rayleigh
    slab under collimated ZENITH illumination with F0 = 1 (perpendicular
    beam irradiance).

    Returns dict with 'mu' (the viewing cosines), 'refl' [n_view, 2]
    upwelling radiance at the top, 'trans' [n_view, 2] downwelling diffuse
    at the bottom, 'e' direct transmission exp(-tau), and flux diagnostics
    ('flux_refl', 'flux_trans_diffuse') for conservation checks."""
    tau = float(tau)
    mu_view = np.atleast_1d(np.asarray(mu_view, np.float64))
    xg, wg = np.polynomial.legendre.leggauss(n_gauss)
    mu_q = 0.5 * (xg + 1.0)
    w_q = 0.5 * wg
    mu = np.concatenate([mu_q, mu_view])          # view nodes carry w = 0
    w = np.concatenate([w_q, np.zeros_like(mu_view)])
    n = mu.shape[0]

    # 2x2 azimuth-averaged blocks for all (out, in) pairs
    Zr = np.empty((n, n, 2, 2))   # reflection: out up, in down
    Zt = np.empty((n, n, 2, 2))   # transmission: out down, in down
    for i in range(n):
        for j in range(n):
            Zr[i, j] = _z0_block(mu[i], True, mu[j], False, nphi, depolarization)
            Zt[i, j] = _z0_block(mu[i], False, mu[j], False, nphi, depolarization)

    # initial thin layer (single scattering), supermatrix form with the
    # 2 mu_j w_j quadrature absorbed:  M_ij = R(mu_i, mu_j) 2 mu_j w_j,
    # R_thin = omega dtau Z / (4 mu_i mu_j)
    k = int(np.ceil(np.log2(tau / dtau0)))
    dtau = tau / (2.0 ** k)
    fac = (omega * dtau / (4.0 * mu[None, :, None, None] *
                           mu[:, None, None, None])
           * (2.0 * mu[None, :, None, None] * w[None, :, None, None]))
    R = (Zr * fac).transpose(0, 2, 1, 3).reshape(2 * n, 2 * n)
    T = (Zt * fac).transpose(0, 2, 1, 3).reshape(2 * n, 2 * n)
    T = T + np.kron(np.diag(np.exp(-dtau / mu)), np.eye(2))

    # beam source vectors: radiance per unit F0, zenith beam (mu0 = 1,
    # direction -z).  Scattering angle: cos Theta = -mu_i (refl) / +mu_i
    # (trans); meridian bases need no extra rotation for a zenith beam.
    cr = rayleigh_F(-mu, depolarization)[:, :2, 0]   # (I,Q) source column
    ct = rayleigh_F(mu, depolarization)[:, :2, 0]
    r = (omega * dtau / (4.0 * np.pi * mu))[:, None] * cr
    t = (omega * dtau / (4.0 * np.pi * mu))[:, None] * ct
    r = r.reshape(-1)
    t = t.reshape(-1)
    e = np.exp(-dtau)  # mu0 = 1

    eye = np.eye(2 * n)
    for _ in range(k):
        G = np.linalg.solve(eye - R @ R, eye)
        D = G @ (t + R @ (r * e))
        U = R @ D + r * e
        r = r + T @ U
        t = T @ D + t * e
        R_new = R + T @ R @ G @ T
        T_new = T @ G @ T
        R, T, e = R_new, T_new, e * e

    r2 = r.reshape(n, 2)
    t2 = t.reshape(n, 2)
    flux_r = 2.0 * np.pi * np.sum(w * mu * r2[:, 0])
    flux_t = 2.0 * np.pi * np.sum(w * mu * t2[:, 0])
    nv = mu_view.shape[0]
    return {
        "mu": mu_view,
        "refl": r2[n - nv:],
        "trans": t2[n - nv:],
        "e": e,
        "flux_refl": flux_r,
        "flux_trans_diffuse": flux_t,
    }
