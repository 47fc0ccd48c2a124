"""The port's volpathmis (spectral null-scattering path-integral MIS) and
the two-state medium, held against the JAX package on the CPU.

TwoStateMedium's queries are held at rtol 1e-6 (the last place of exp).
The slab renders are held lane by lane: each lane draws the JAX package's
numbers, so at least 99% of the lanes must agree to rtol 1e-4 / atol 1e-5
(a real-versus-null collision or a roulette decision can flip on one
ulp, ROADMAP Queue 3), and the image means to rtol 1e-4. The scene is
tests/test_volpathmis.py's: a null cube holding a homogeneous medium with
a per-channel sigma_t under a constant environment, at 16 x 16 @ 4 spp.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.render import media as JM
from mitsuba_tpu.render import volumes as JV
from mitsuba_tpu.render_api import _render_pass as j_render_pass

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.integrators.volpath import VolPathIntegrator
from mitsuba_tpu_torch.integrators.volpathmis import VolPathMisIntegrator
from mitsuba_tpu_torch.render import media as TM
from mitsuba_tpu_torch.render import volumes as TV
from mitsuba_tpu_torch.render_api import render_lanes

W, SPP = 16, 4
LANE_TOL = dict(rtol=1e-4, atol=1e-5)
# per-channel extinction; the spectral variants carry four channels a lane
SIGMA = {"rgb": [4.0, 1.0, 0.08], "spectral": [4.0, 1.0, 0.08, 0.5]}


@pytest.fixture(autouse=True)
def _rgb():
    yield
    mj.set_variant("rgb")
    mt.set_variant("rgb")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (ROADMAP Queue 3: MKL's first vector-math call
    from two threads can take its low-accuracy kernel on one chunk)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slab(integrator, sigma, albedo=0.9):
    return {
        "type": "scene",
        "integrator": integrator,
        "sensor": {
            "type": "perspective", "fov": 10,
            "to_world": [{"type": "look_at", "origin": [0, 0, 6], "target": [0, 0, 0],
                          "up": [0, 1, 0]}],
            "film": {"type": "hdrfilm", "width": W, "height": W, "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": SPP},
        },
        "medium1": {"type": "homogeneous", "sigma_t": sigma, "albedo": albedo,
                    "phase": {"type": "isotropic"}},
        "bounds": {"type": "cube", "bsdf": {"type": "null"},
                   "interior": {"type": "ref", "id": "medium1"}},
        "env": {"type": "constant", "radiance": 1.0},
    }


def _media(sigma, old_sigma):
    """(JAX, port) TwoStateMedium pairs with a current and an old state."""
    def jm(s):
        return JM.HomogeneousMedium(sigma_t=JV.ConstVolume(value=jnp.asarray(s, jnp.float32)),
                                    albedo=JV.ConstVolume(value=jnp.full(3, 0.8, jnp.float32)),
                                    scale=jnp.asarray(1.0, jnp.float32), phase_index=0)

    def tm(s):
        return TM.HomogeneousMedium(sigma_t=TV.ConstVolume(value=torch.tensor(s)),
                                    albedo=TV.ConstVolume(value=torch.full((3,), 0.8)),
                                    scale=torch.tensor(1.0), phase_index=0)

    return (JM.TwoStateMedium.wrap(jm(sigma), jm(old_sigma)),
            TM.TwoStateMedium.wrap(tm(sigma), tm(old_sigma)))


def test_transmittance_eval_pdf_and_twostate():
    """transmittance_eval_pdf and TwoStateMedium's current and old queries
    against the JAX package's, on random distances: scattered lanes
    (mi_t < si_t) and lanes that left the medium."""
    rng = np.random.default_rng(11)
    mi_t, si_t = rng.random((2, 64)).astype(np.float32) * 3.0
    st = rng.random((64, 3)).astype(np.float32) * 2.0
    mint = (rng.random(64) * 0.2).astype(np.float32)
    want = JM.transmittance_eval_pdf(jnp.asarray(mi_t), jnp.asarray(si_t), jnp.asarray(mint),
                                     jnp.asarray(st))
    got = TM.transmittance_eval_pdf(*(torch.from_numpy(x) for x in (mi_t, si_t, mint, st)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)

    jm, tm = _media([2.0, 1.0, 0.5], [1.0, 1.5, 3.0])
    p = np.zeros((64, 3), np.float32)
    for name in ("transmittance_eval_pdf", "transmittance_eval_pdf_old"):
        want = getattr(jm, name)(jnp.asarray(mi_t), jnp.asarray(si_t), jnp.asarray(mint),
                                 jnp.asarray(p), 3)
        got = getattr(tm, name)(*(torch.from_numpy(x) for x in (mi_t, si_t, mint, p)), 3)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, err_msg=name)
    for name in ("get_scattering_coefficients", "get_scattering_coefficients_old"):
        for g, w in zip(getattr(tm, name)(torch.from_numpy(p), 3),
                        getattr(jm, name)(jnp.asarray(p), 3)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(tm.get_majorant(torch.from_numpy(p), 3).numpy(),
                               np.asarray(jm.get_majorant(jnp.asarray(p), 3)), rtol=1e-6)
    assert tm.is_homogeneous and tm.phase_index == 0
    # wrap(m): the old state is the current one
    solo = TM.TwoStateMedium.wrap(tm.current)
    assert solo.old is solo.current


@pytest.mark.parametrize("variant", ["rgb", "spectral"])
def test_volpathmis_slab_matches_jax(variant):
    mj.set_variant(variant)
    mt.set_variant(variant)
    d = _slab({"type": "volpathmis", "max_depth": 6}, SIGMA[variant])
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    assert isinstance(ts.integrator, VolPathMisIntegrator)
    L_j, _, _, aux_j = j_render_pass(js, jnp.uint32(0), 0, SPP, SPP, 0)
    L_t, aux_t = render_lanes(ts, 0, 0, W * W * SPP, 0, SPP, SPP, 0, raw=True)
    L_j, L_t = np.asarray(L_j), L_t.numpy()
    assert L_t.shape == (W * W * SPP, len(SIGMA[variant]))
    agree = np.isclose(L_t, L_j, **LANE_TOL).all(-1)
    assert agree.mean() >= 0.99, agree.mean()
    np.testing.assert_allclose(L_t.mean(0), L_j.mean(0), rtol=1e-4)
    assert int(aux_t["n_rays"]) == int(float(aux_j["n_rays"]))
    # the extinction differs per channel, and so does the image
    assert np.ptp(L_t.mean(0)) > 0.1
    img = mt.render(ts, spp=SPP, seed=0)
    assert img.shape == (W, W, 3) and bool(torch.isfinite(img).all())


def test_use_spectral_mis_false_is_volpath_and_polarized_raises():
    d = _slab({"type": "volpathmis", "max_depth": 6, "use_spectral_mis": False}, SIGMA["rgb"])
    ts = mt.load_dict(d, device="cpu")
    assert type(ts.integrator) is VolPathIntegrator
    d_v = _slab({"type": "volpath", "max_depth": 6}, SIGMA["rgb"])
    img_v = mt.render(mt.load_dict(d_v, device="cpu"), spp=2, seed=1)
    assert torch.equal(mt.render(ts, spp=2, seed=1), img_v)
    mt.set_variant("mono_polarized")
    ts = mt.load_dict(_slab({"type": "volpathmis"}, 1.0), device="cpu")
    with pytest.raises(ValueError, match="polarized"):
        mt.render(ts, spp=1)
