"""Path regeneration in the spectral variant of the port, on the CPU: the
conversion to the film's channels at each path's flush (sRGB, or a
specfilm's sensor response functions) and its adjoint in the regenerative
PRB replay, held against the port's own wavefront render and gradient at
the reference's bounds between the two schedules (tests/test_regen.py:
rtol 3e-4, atol 3e-5 for images; rtol 1e-3, atol 1e-7 for gradients), and
the regenerative image and gradients against the JAX package's.

The slab's scene is lit by an rgb environment over an rgb floor, so the
emitted spectrum and the floor's reflectance differ from one wavelength to
another: a lane that carried the wrong wavelengths into an emitter, a BSDF
or a restarted path would change the image and the gradients.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj

import mitsuba_tpu_torch as mt

VOL_TOL = dict(rtol=3e-4, atol=3e-5)     # regenerative against wavefront image
GRAD_TOL = dict(rtol=1e-3, atol=1e-7)    # regenerative against wavefront gradient
GRAD_RTOL = 1e-4     # against the JAX package (tests/test_torch_regen_prb.py)
IMG_RTOL = 1e-4      # the regenerative image against the JAX package's
KEYS = ("slab.interior_medium.albedo.value.value", "floor.bsdf.reflectance.value")
SEED = 17


@pytest.fixture(autouse=True)
def _rgb():
    yield
    mj.set_variant("rgb")
    mt.set_variant("rgb")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variant(name):
    mj.set_variant(name)
    mt.set_variant(name)


def slab(integrator, regenerate, film=None, spp=4):
    """tests/test_regen.py:364-392's scene: a Rayleigh slab (sigma_t 1.5,
    albedo 0.9) in a null cube, 10x10, max_depth 5, 16 tracking steps;
    here under an rgb constant environment and over a diffuse rgb floor
    (the JAX package refuses an rgb volume in spectral, so the albedo
    stays a scalar); `film` replaces the hdrfilm."""
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": 5, "regenerate": regenerate,
                       "track_steps": 16, "nee_steps": 16},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": [{"type": "look_at", "origin": [0, 0, 4], "target": [0, 0, 0],
                                 "up": [0, 1, 0]}],
                   "film": film or {"type": "hdrfilm", "width": 10, "height": 10,
                                    "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "light": {"type": "constant", "radiance": {"type": "rgb", "value": [0.4, 1.0, 1.6]}},
        "slab": {"type": "cube", "to_world": [{"type": "scale", "value": [1.2, 1.2, 0.5]}],
                 "bsdf": {"type": "null"},
                 "interior": {"type": "homogeneous", "sigma_t": 1.5, "albedo": 0.9,
                              "phase": {"type": "rayleigh"}}},
        "floor": {"type": "rectangle",
                  "to_world": [{"type": "translate", "value": [0, 0, -1]},
                               {"type": "scale", "value": [3, 3, 1]}],
                  "bsdf": {"type": "diffuse",
                           "reflectance": {"type": "rgb", "value": [0.7, 0.3, 0.1]}}},
    }


SPECFILM = {"type": "specfilm", "width": 10, "height": 10, "rfilter": {"type": "box"},
            "band_green": {"type": "regular", "lambda_min": 500.0, "lambda_max": 600.0,
                           "values": [0.2, 1.0, 0.2]},
            "band_flat": {"type": "uniform", "value": 1.0}}


def _grads(d, spp=4):
    """(image, [gradient of the image mean for each of KEYS], stats) of the
    port."""
    p = mt.traverse(mt.load_dict(d, device="cpu"))
    leaves = {k: p[k].clone().requires_grad_() for k in KEYS}
    st = {}
    img = mt.render(p.update(leaves), spp=spp, seed=SEED, stats=st)
    img.mean().backward()
    return img.detach().numpy(), [leaves[k].grad.numpy() for k in KEYS], st


@pytest.fixture(scope="module")
def port_slab():
    """_grads of the port's regenerative prbvolpath on the spectral slab
    (hdrfilm), shared by the tests of this file."""
    mt.set_variant("spectral")
    try:
        return _grads(slab("prbvolpath", True))
    finally:
        mt.set_variant("rgb")


@pytest.fixture(scope="module")
def jax_slab():
    """(image, [gradient for each of KEYS]) of the JAX package's
    regenerative prbvolpath on the spectral slab (hdrfilm), by one
    jax.jit(jax.value_and_grad) with the scene closed over, shared by the
    tests of this file."""
    mj.set_variant("spectral")
    try:
        js = mj.load_dict(slab("prbvolpath", True))

        def loss(vals):
            img = mj.render(mj.traverse(js).update(dict(zip(KEYS, vals))), spp=4, seed=SEED)
            return jnp.mean(img), img

        p = mj.traverse(js)
        (_, img), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(tuple(p[k] for k in KEYS))
        return np.asarray(img), [np.asarray(x) for x in g]
    finally:
        mj.set_variant("rgb")


def test_volpath_regen_spectral_matches_wavefront_and_jax():
    """tests/test_regen.py:205-218 in the port: the spectral cbox with
    volpath (12x12 @ 4 spp, max_depth 4), regenerative against the same
    dict's wavefront render within rtol 3e-4, atol 3e-5; and the
    regenerative volpath render of the slab on a 2-SRF specfilm against
    the JAX package's within IMG_RTOL."""
    _variant("spectral")
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = 12
    d["integrator"] = {"type": "volpath", "max_depth": 4}
    img_std = mt.render(mt.load_dict(d, device="cpu"), spp=4, seed=6).numpy()
    d["integrator"]["regenerate"] = True
    st = {}
    img_reg = mt.render(mt.load_dict(d, device="cpu"), spp=4, seed=6, stats=st).numpy()
    assert img_reg.shape == (12, 12, 3) and st["wavefront_iters"] > 0
    np.testing.assert_allclose(img_reg, img_std, **VOL_TOL)
    d = slab("volpath", True, SPECFILM)
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    np.testing.assert_allclose(ts.film.srf_norms, js.film.srf_norms, rtol=1e-5)
    img_j = np.asarray(jax.jit(lambda: mj.render(js, spp=4, seed=SEED))())
    st = {}
    img = mt.render(ts, spp=4, seed=SEED, stats=st).numpy()
    assert img.shape == img_j.shape == (10, 10, 2) and st["wavefront_iters"] > 0
    np.testing.assert_allclose(img, img_j, rtol=IMG_RTOL, atol=IMG_RTOL * np.abs(img_j).max())


def test_prbvolpath_regen_spectral_grads_match_jax(port_slab, jax_slab):
    """The regenerative prbvolpath in spectral (the VJP of the sRGB
    conversion at each sample's primal radiance and wavelengths, with the
    emitter and the floor evaluated at those wavelengths): the gradients of
    the image mean for the slab's albedo and the floor's reflectance
    within GRAD_RTOL of the JAX package's regenerative gradients, and its
    primal image within IMG_RTOL of the JAX package's."""
    _variant("spectral")
    img_j, want = jax_slab
    img, got, st = port_slab
    assert st["wavefront_iters_replay"] > 0
    np.testing.assert_allclose(img, img_j, rtol=IMG_RTOL, atol=IMG_RTOL * np.abs(img_j).max())
    for k, g, g_j in zip(KEYS, got, want):
        assert np.all(g_j != 0), k
        s = np.abs(g_j).max()
        np.testing.assert_allclose(g, g_j, rtol=GRAD_RTOL, atol=GRAD_RTOL * s, err_msg=k)
    # the floor's three channels have gradients that differ
    assert np.ptp(want[1]) > 1e-3 * np.abs(want[1]).max()


@pytest.mark.parametrize("film", ["hdrfilm", "specfilm"])
def test_prbvolpath_regen_spectral_grads_match_wavefront(film, port_slab):
    """tests/test_regen.py:417-421 and :432-493 in the port: prbvolpath in
    spectral on the slab, the gradients of the image mean for the albedo
    and the floor's reflectance, the regenerative replay (the VJP of the
    sRGB conversion, or of the specfilm's two SRFs, at each sample's primal
    radiance and wavelengths) against the wavefront PRB step within rtol
    1e-3, atol 1e-7; the regenerative volpath image against the
    wavefront's within rtol 3e-4, atol 3e-5."""
    _variant("spectral")
    f = SPECFILM if film == "specfilm" else None
    nch = 2 if film == "specfilm" else 3
    img_std = mt.render(mt.load_dict(slab("volpath", False, f), device="cpu"), spp=4,
                        seed=19).numpy()
    img_reg = mt.render(mt.load_dict(slab("volpath", True, f), device="cpu"), spp=4,
                        seed=19).numpy()
    assert img_std.shape == (10, 10, nch)
    np.testing.assert_allclose(img_reg, img_std, **VOL_TOL)
    _, g_std, _ = _grads(slab("prbvolpath", False, f))
    img_r, g_reg, st = _grads(slab("prbvolpath", True, f)) if f else port_slab
    assert img_r.shape == (10, 10, nch) and st["wavefront_iters_replay"] > 0
    for k, g, g_w in zip(KEYS, g_reg, g_std):
        assert np.abs(g_w).max() > 0, k
        np.testing.assert_allclose(g, g_w, **GRAD_TOL, err_msg=k)
