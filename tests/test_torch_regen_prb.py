"""Regenerative inverse rendering in the port, on the CPU: path regeneration
with a PRB integrator (the regenerative render at the node's forward, its
replay at the backward) and polarized regeneration, held against the JAX
package and against the port's own wavefront PRB.

Regeneration changes only the schedule: each sample draws the numbers it
draws in the plain wavefront, so the regenerative gradient equals the
wavefront gradient up to the order of sums (the reference's own bound
between the two schedules is rtol 1e-3, tests/test_regen.py:93-117, :393-414;
here they agree to ~1e-6). Against the JAX package's regenerative gradient
the same paths are replayed, and the gradients agree to GRAD_RTOL 1e-4 (XLA
contracts a*b + c into FMAs on the CPU and the port does not, ROADMAP
Queue 3). Every JAX value is computed live, through jax.jit, with the
scene closed over (a traced scene costs XLA about four times the compile
time); each test computes the references it needs, so that test workers do
not repeat them.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.render.scene_loader import vol32_scene

GRAD_RTOL = 1e-4       # against the JAX package's regenerative gradient
SCHEDULE_RTOL = 1e-3   # against the port's wavefront PRB gradient
IMG_RTOL = 1e-4        # the regenerative primal against the JAX package's
VOL_TOL = dict(rtol=3e-4, atol=3e-5)   # regenerative against wavefront image
SEED = 3
AOS_KEYS = ("sea_floor.bsdf.reflectance.value", "sun.irradiance.value",
            "atmo_medium.albedo.value.value", "atmo_medium.sigma_t.value.value")


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


def _variant(name):
    mj.set_variant(name)
    mt.set_variant(name)


def cbox(integrator, regenerate, w=12, max_depth=4, **kw):
    """The Cornell box at w x w with shadow rays in their own bounce
    (tests/test_regen.py:80-90)."""
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = w
    d["integrator"] = {"type": integrator, "max_depth": max_depth, "regenerate": regenerate,
                       "defer_nee": False, **kw}
    return d


def vol(integrator, regenerate, steps=32):
    """bench.py's deep volume (a slab of sigma_t 4, albedo 0.95, HG 0.6 under
    a constant environment) at 8x8, max_depth 4; `steps` tracking steps
    (prbvolpath takes the reference's 32 whatever the dict says)."""
    d = vol32_scene(res=8, spp=4, max_depth=4, steps=steps, regenerate=regenerate)
    d["integrator"]["type"] = integrator
    return d


def rayleigh_slab(integrator, regenerate):
    """tests/test_regen.py:221-245's polarized scene at 8x8: a thin
    Rayleigh slab (sigma_t 1, albedo 0.9) under a constant environment."""
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": 4, "regenerate": regenerate},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": [{"type": "look_at", "origin": [0, 0, 4], "target": [0, 0, 0],
                                 "up": [0, 1, 0]}],
                   "film": {"type": "hdrfilm", "width": 8, "height": 8,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 8}},
        "light": {"type": "constant", "radiance": 1.0},
        "slab": {"type": "cube", "to_world": [{"type": "scale", "value": [1.0, 1.0, 0.3]}],
                 "bsdf": {"type": "null"},
                 "interior": {"type": "homogeneous", "sigma_t": 1.0, "albedo": 0.9,
                              "phase": {"type": "rayleigh"}}},
    }


def ocean(integrator, regenerate):
    """tests/test_torch_aos.py's ocean: BASELINE config 5's dict (a rough
    dielectric sea over a diffuse floor, a sun, a Rayleigh atmosphere, a
    radiancemeter) at a 4x4 film."""
    d = mt.aos_scene(res=4, integrator=integrator)
    d["integrator"]["regenerate"] = regenerate
    return d


# name: (variant, make(integrator, regenerate), PRB integrator, forward integrator, keys, spp)
CASES = {
    "prb": ("rgb", cbox, "prb", "path", ("white.reflectance.value",
                                         "light.emitter.radiance.value"), 4),
    "prb-hide_emitters": ("rgb", lambda t, r: cbox(t, r, hide_emitters=True, rr_depth=2),
                          "prb", "path", ("white.reflectance.value",
                                          "light.emitter.radiance.value"), 4),
    "prbvolpath": ("rgb", vol, "prbvolpath", "volpath",
                   ("slab.interior_medium.albedo.value.value",
                    "slab.interior_medium.sigma_t.value.value"), 4),
    "prb_polarized": ("mono_polarized", rayleigh_slab, "prb_polarized", "volpath",
                      ("slab.interior_medium.albedo.value.value",), 8),
    "prb_volpathaos-mono": ("mono", ocean, "prb_volpathaos", "volpathaos", AOS_KEYS, 8),
    "prb_volpathaos-mono_polarized": ("mono_polarized", ocean, "prb_volpathaos", "volpathaos",
                                      AOS_KEYS, 8),
}


def jax_grads(d, keys, spp):
    """(image, [gradient of the image mean for each key]) of the JAX
    package, by one jax.jit(jax.value_and_grad)."""
    js = mj.load_dict(d)

    def loss(vals):
        img = mj.render(mj.traverse(js).update(dict(zip(keys, vals))), spp=spp, seed=SEED)
        return jnp.mean(img), img

    p = mj.traverse(js)
    (_, img), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(tuple(p[k] for k in keys))
    return np.asarray(img), [np.asarray(x) for x in g]


def port_grads(d, keys, spp):
    """(image, [gradient of the image mean for each key], stats) of the
    port."""
    p = mt.traverse(mt.load_dict(d, device="cpu"))
    leaves = {k: p[k].clone().requires_grad_() for k in keys}
    stats = {}
    img = mt.render(p.update(leaves), spp=spp, seed=SEED, stats=stats)
    img.mean().backward()
    return img.detach().numpy(), [leaves[k].grad.numpy() for k in keys], stats


@pytest.mark.parametrize("name", list(CASES))
def test_regen_gradients_match_jax_and_wavefront(name):
    """Each PRB integrator with ``regenerate``: its gradients of the image
    mean against the JAX package's regenerative gradients (GRAD_RTOL) and
    the port's wavefront PRB gradients at the same seed (SCHEDULE_RTOL);
    its primal image against the JAX package's (IMG_RTOL) and, bit for bit,
    the regenerative render of its forward integrator (polarized: volpath
    and volpathaos with the Stokes rotation at each flush), which is held
    to the wavefront image (VOL_TOL). The forward and the backward primal
    cast the wavefront's rays, and the replay takes as many steps as the
    backward primal."""
    variant, make, prb, fwd, keys, spp = CASES[name]
    _variant(variant)
    img, got, stats = port_grads(make(prb, True), keys, spp)
    img_w, want_w, stats_w = port_grads(make(prb, False), keys, spp)
    img_j, want_j = jax_grads(make(prb, True), keys, spp)

    assert stats["n_rays"] == stats_w["n_rays"] > 0
    assert stats["n_rays_grad"] == stats_w["n_rays_grad"]
    assert stats["wavefront_iters_replay"] == stats["wavefront_iters_grad"] > 0
    fwd_img = mt.render(mt.load_dict(make(fwd, True), device="cpu"), spp=spp, seed=SEED)
    assert np.array_equal(fwd_img.numpy(), img) and np.isfinite(img).all()
    np.testing.assert_allclose(img, img_w, **VOL_TOL)
    scale = np.abs(img_j).max()
    np.testing.assert_allclose(img, img_j, rtol=IMG_RTOL, atol=IMG_RTOL * scale)
    if mt.current_variant().polarized:
        assert img.shape[-2] == 4 and np.abs(img[..., 1, :]).max() > 1e-4 * scale
    for k, g, g_j, g_w in zip(keys, got, want_j, want_w):
        assert np.any(g_j != 0), k
        s = np.abs(g_j).max()
        np.testing.assert_allclose(g, g_j, rtol=GRAD_RTOL, atol=GRAD_RTOL * s, err_msg=k)
        np.testing.assert_allclose(g, g_w, rtol=SCHEDULE_RTOL, atol=SCHEDULE_RTOL * s,
                                   err_msg=k)


RECORD = {"path": (lambda r: cbox("path", r, w=8), 4),
          "volpath": (lambda r: vol("volpath", r, steps=8), 4)}


@pytest.mark.parametrize("name", list(RECORD))
def test_record_samples_match_jax(name):
    """regen_render(record_samples=True): L_samples [n_pixels, spp, C], the
    radiance of each finished sample under the sample index it was started
    with, against the JAX package's aux["L_samples"] (rtol 1e-5); summed
    over the samples it is L_px; without record_samples L_px is the same."""
    make, spp = RECORD[name]
    js = mj.load_dict(make(True))
    js = js.replace(geometry=js.geometry.refresh())
    _, aux_j = jax.jit(lambda seed: js.integrator.regen_render(
        js, seed, spp, 0, record_samples=True))(jnp.uint32(SEED))
    want = np.asarray(aux_j["L_samples"])

    ts = mt.load_dict(make(True), device="cpu")
    ts = dataclasses.replace(ts, geometry=ts.geometry.refresh())
    L_px, aux = ts.integrator.regen_render(ts, SEED, spp, 0, record_samples=True)
    L_plain, _ = ts.integrator.regen_render(ts, SEED, spp, 0)
    got = aux["L_samples"].numpy()
    assert got.shape == want.shape == (ts.film.n_pixels, spp, 3)
    assert (got.sum(axis=-1) > 0).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.sum(axis=1), L_px.numpy(), rtol=1e-6, atol=1e-7)
    assert torch.equal(L_px, L_plain)
