"""The two physics golds in the port, on the CPU: the adding-doubling slab
solver (the port's copy of mitsuba_tpu/utils/doubling.py) against the JAX
package's, Chandrasekhar's H-function identity, and one Rayleigh-slab
render at reduced samples against the analytic single-scattering Stokes
vector.

The renders of tests/test_rayleigh_slab_gold.py (16,384 spp, single and
multiple scattering) and tests/test_chandrasekhar_gold.py (8,192 spp) run
on the card, in chip_smoke.py's golds phase, within those tests' own
bounds. Here the single-scattering case renders 1,024 spp (16,384 lanes):
its I is held within 6% (the tests' 3% at 16x the samples; over seeds 1-3
the port's error was at most 1.6%), DoLP within 0.02, U and V as there.
"""
import numpy as np
import pytest
import torch

from mitsuba_tpu.utils import doubling as JD

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.utils import doubling as TD

OMEGA = 0.8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (ROADMAP Queue 3: MKL's first vector-math call
    from two threads can take its low-accuracy kernel on one chunk)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _rgb():
    yield
    mt.set_variant("rgb")


@pytest.mark.parametrize("tau,theta", [(0.25, 60.0), (0.5, 40.0)])
def test_doubling_copy_equals_jax_package(tau, theta):
    """The cases of tests/test_rayleigh_slab_gold.py:93, bit for bit (the
    same numpy operations), and the conservative slab's flux balance."""
    mu = [float(np.cos(np.radians(theta)))]
    got = TD.doubling_slab(tau, mu, n_gauss=24, nphi=64)
    want = JD.doubling_slab(tau, mu, n_gauss=24, nphi=64)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert abs(got["flux_refl"] + got["flux_trans_diffuse"] + got["e"] - 1.0) < 1e-4


def h_function(omega, n_nodes=64, iters=800):
    """Chandrasekhar's H-function on Gauss-Legendre nodes by fixed-point
    iteration (tests/test_chandrasekhar_gold.py's solver)."""
    x, w = np.polynomial.legendre.leggauss(n_nodes)
    mu = 0.5 * (x + 1.0)
    wq = 0.5 * w
    H = np.ones(n_nodes)
    for _ in range(iters):
        integral = ((H * wq)[None, :] / (mu[:, None] + mu[None, :])).sum(-1)
        H = 1.0 / (1.0 - 0.5 * omega * mu * integral)
    return mu, wq, H


def test_h_function_moment_identity():
    """Integral_0^1 H dmu = 2 (1 - sqrt(1 - omega)) / omega: the solver the
    card's Chandrasekhar gold is held against."""
    _, wq, H = h_function(OMEGA)
    exact = 2.0 * (1.0 - np.sqrt(1.0 - OMEGA)) / OMEGA
    assert abs((H * wq).sum() - exact) < 2e-3


def _rayleigh_slab(tau, theta_deg):
    """tests/test_rayleigh_slab_gold.py's scene: a zenith sun over a
    conservative Rayleigh slab, a radiancemeter looking up at theta."""
    st, ct = np.sin(np.radians(theta_deg)), np.cos(np.radians(theta_deg))
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 2},
        "sun": {"type": "directional", "direction": [0, 0, -1], "irradiance": 1.0},
        "slab": {"type": "cube", "to_world": [{"type": "scale", "value": [2000.0, 2000.0, 0.5]}],
                 "bsdf": {"type": "null"},
                 "interior": {"type": "homogeneous", "sigma_t": tau, "albedo": 1.0,
                              "phase": {"type": "rayleigh", "depolarization": 0.0}}},
        "sensor": {"type": "radiancemeter", "wavelength": 550.0,
                   "to_world": [{"type": "look_at", "origin": [0.0, 0.0, -2.0],
                                 "target": [2.0 * st, 0.0, -2.0 + 2.0 * ct], "up": [0, 1, 0]}],
                   "film": {"type": "hdrfilm", "width": 4, "height": 4,
                            "rfilter": {"type": "box"}}},
    }


def test_single_scatter_stokes_reduced_spp():
    tau, theta = 0.25, 60.0
    mt.set_variant("mono_polarized")
    I, Q, U, V = mt.render_1(mt.load_dict(_rayleigh_slab(tau, theta), device="cpu"), spp=1024,
                             seed=1)[:, 0].tolist()
    mu = np.cos(np.radians(theta))
    L_ref = tau * 3.0 / (16.0 * np.pi) * (1.0 + mu * mu) * np.exp(-tau) * (
        np.exp(tau * (mu - 1.0) / mu) - 1.0) / (tau * (mu - 1.0))
    dolp_ref = (1.0 - mu * mu) / (1.0 + mu * mu)
    assert abs(I - L_ref) / L_ref < 0.06, (I, L_ref)
    assert abs(abs(Q) / I - dolp_ref) < 0.02 and Q < 0, (Q / I, dolp_ref)
    assert abs(U) / I < 0.02 and abs(V) / I < 0.01
