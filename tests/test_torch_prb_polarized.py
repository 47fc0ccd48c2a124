"""The polarized volumetric PRB replay of the PyTorch port (prb_polarized)
against the JAX package on the CPU: the gradients of the Stokes vector of
a polarizing slab (a homogeneous medium whose phase blends Rayleigh with
HG, under a directional sun, seen by a radiancemeter at 90 degrees) for
sigma_t, the albedo, the HG g and the sun's irradiance, of an I-weighted
and a Q-weighted loss; the routing of prb, prb_basic and prbvolpath to it
in a polarized variant; its primal against the polarized volpath; and the
PRB node's sensor-frame rotation.

The JAX package's Stokes vector and gradients are computed live:
jax.jit(jax.grad) of the same weighted losses at the same seed, traced
once for the module (the Stokes weights an argument; tracing and
compiling its Mueller replay takes ~30 s on the CPU).

Parameters are set through traverse().update() in both packages; the
routing of the names is held against the JAX package live. The gradients
agree to rtol 1e-4 of each gradient (and 1e-4 of the largest one of its
loss, for gradients near 0), the Stokes vector to 1e-5 (XLA contracts
a*b + c into FMAs on the CPU and the port does not).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.ad.prb_polarized import PRBPolarizedVolpathIntegrator
from mitsuba_tpu_torch.ad.render_ad import _postprocess, _postprocess_adjoint

SPP, SEED = 8, 3
GRAD_RTOL = 1e-4
KEYS = ("atmo.sigma_t.value.value", "atmo.albedo.value.value", "atmo.phase_function.b.g",
        "sun.irradiance.value")
WEIGHTS = {"I": [1.0, 0.0, 0.0, 0.0], "Q": [0.0, 1.0, 0.0, 0.0]}
@pytest.fixture(autouse=True)
def _polarized():
    mj.set_variant("mono_polarized")
    mt.set_variant("mono_polarized")
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


def blend_slab(integrator="prb_polarized", max_depth=4):
    """tests/test_prb_polarized.py's slab (sigma_t 0.4, albedo 0.8, 100 x
    100 x 1, the sun straight down, a radiancemeter at (-80, 0, 0) looking
    along +x) with a phase that blends Rayleigh and HG (g 0.4) half and
    half, at a 4x4 film."""
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": max_depth},
        "atmo": {"type": "homogeneous", "albedo": 0.8, "sigma_t": 0.4,
                 "phase": {"type": "blendphase", "weight": 0.5,
                           "a": {"type": "rayleigh"}, "b": {"type": "hg", "g": 0.4}}},
        "slab": {"type": "cube", "bsdf": {"type": "null"},
                 "to_world": [{"type": "scale", "value": [50.0, 50.0, 0.5]}],
                 "interior": {"type": "ref", "id": "atmo"}},
        "sun": {"type": "directional", "direction": [0, 0, -1], "irradiance": 5.0},
        "sensor": {
            "type": "radiancemeter",
            "to_world": [{"type": "look_at", "origin": [-80, 0, 0], "target": [0, 0, 0],
                          "up": [0, 0, 1]}],
            "film": {"type": "hdrfilm", "width": 4, "height": 4, "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": SPP},
        },
    }


@pytest.fixture(scope="module")
def jax_blend():
    """w -> (the JAX package's render_1 Stokes vector of blend_slab() with
    prb_polarized at spp=SPP, seed=SEED, [4]; its gradients of
    sum(w . render_1) for KEYS): one jax.jit(jax.grad) for the module."""
    mj.set_variant("mono_polarized")
    js = mj.load_dict(blend_slab())

    def loss(vals, w):
        out = mj.render_1(mj.traverse(js).update(dict(zip(KEYS, vals))), spp=SPP, seed=SEED)
        return jnp.sum(out * w[:, None]), out

    grad = jax.jit(jax.grad(loss, has_aux=True))
    p = mj.traverse(js)
    vals = tuple(p[k] for k in KEYS)

    def get(w):
        g, stokes = grad(vals, jnp.asarray(w, jnp.float32))
        return (np.asarray(stokes)[:, 0],
                [float(np.asarray(x).reshape(-1)[0]) for x in g])

    return get


def port_grads(d, keys, w, spp=SPP, seed=SEED, stats=None):
    """(Stokes [4, C], {key: gradient of sum(w . Stokes)}) of the port."""
    p = mt.traverse(mt.load_dict(d, device="cpu"))
    leaves = {k: p[k].clone().requires_grad_() for k in keys}
    out = mt.render_1(p.update(leaves), spp=spp, seed=seed, stats=stats)
    (out * torch.tensor(w)[:, None]).sum().backward()
    return out.detach().numpy(), {k: v.grad.numpy() for k, v in leaves.items()}


def test_prb_polarized_gradients_match_jax(jax_blend):
    """The Mueller replay's gradients of the I- and the Q-weighted losses
    against the JAX package's (the Q ones need the sensor-frame adjoint and
    the Stokes-preserving suffix), and its Stokes vector."""
    d = blend_slab()
    for name, w in WEIGHTS.items():
        want_stokes, want_g = jax_blend(w)
        stats = {}
        got_stokes, got = port_grads(d, KEYS, w, stats=stats)
        np.testing.assert_allclose(got_stokes[:, 0], want_stokes, rtol=1e-5, atol=1e-6)
        assert abs(got_stokes[1, 0]) > 0.05 * got_stokes[0, 0]    # polarized at 90 degrees
        assert stats["n_rays_grad"] > stats["n_rays"] > 0
        scale = max(abs(x) for x in want_g)
        for k, want in zip(KEYS, want_g):
            assert got[k].size == 1 and np.isfinite(got[k]).all(), (name, k)
            if name == "I":
                assert want != 0.0, k
            np.testing.assert_allclose(got[k].reshape(1), [want], rtol=GRAD_RTOL,
                                       atol=GRAD_RTOL * scale, err_msg=f"{name} {k}")


def test_prb_polarized_primal_is_polarized_volpath():
    """The replay integrator's primal is the polarized volpath: render_1's
    Stokes vector bitwise, the same rays."""
    s_prb = mt.load_dict(blend_slab(), device="cpu")
    s_vol = mt.load_dict(blend_slab("volpath"), device="cpu")
    st_p, st_v = {}, {}
    a = mt.render_1(s_prb, spp=SPP, seed=9, stats=st_p)
    b = mt.render_1(s_vol, spp=SPP, seed=9, stats=st_v)
    assert a.shape == (4, 1) and torch.equal(a, b)
    assert st_p["n_rays"] == st_v["n_rays"]


def test_prb_polarized_routing():
    """tests/test_prb_polarized.py:139's names: in a polarized variant prb,
    prb_basic, prbvolpath and prb_polarized are the Mueller replay (the
    JAX package routes them the same way), with ``regenerate`` too."""
    for name in ("prb", "prb_basic", "prbvolpath", "prb_polarized"):
        assert type(mt.load_dict(blend_slab(name), device="cpu").integrator) is \
            PRBPolarizedVolpathIntegrator, name
        assert type(mj.load_dict(blend_slab(name)).integrator).__name__ == \
            "PRBPolarizedVolpathIntegrator"
    for name in ("prb", "prb_polarized"):
        d = blend_slab(name)
        d["integrator"]["regenerate"] = True
        scene = mt.load_dict(d, device="cpu")
        assert type(scene.integrator) is PRBPolarizedVolpathIntegrator, name
        assert scene.integrator.regenerate


def test_render_image_gradient_is_n_pixels_radiometer_gradient():
    """render (the [H, W, 4, C] image) with prb_polarized: the same lanes as
    render_1 at the same seed, so the image's sum and its gradient are the
    radiometer's times the pixel count."""
    key = "atmo.albedo.value.value"
    out = []
    for render in (mt.render, mt.render_1):
        p = mt.traverse(mt.load_dict(blend_slab(), device="cpu"))
        v = p[key].clone().requires_grad_()
        img = render(p.update({key: v}), spp=SPP, seed=SEED)
        img.sum().backward()
        out.append((img.detach(), v.grad))
    (img, g_img), (stokes, g_1) = out
    assert img.shape == (4, 4, 4, 1)
    np.testing.assert_allclose(img.sum((0, 1)).numpy(), 16 * stokes.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(g_img.numpy(), 16 * g_1.numpy(), rtol=1e-5)


def test_sensor_frame_adjoint():
    """The PRB node's measurement rotation and the adjoint its backward
    applies are transposes of each other, lane by lane (random Stokes
    vectors and directions, float64-free: rtol 1e-5)."""
    scene = mt.load_dict(blend_slab(), device="cpu")
    r = np.random.default_rng(4)
    d = r.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = [0.0, 0.0, 1.0]                       # the vertical fallback
    d = torch.from_numpy(d)
    L = torch.from_numpy(r.normal(size=(64, 1, 4)).astype(np.float32))
    dL = torch.from_numpy(r.normal(size=(64, 1, 4)).astype(np.float32))
    lhs = (_postprocess(scene, L, d) * dL).sum((1, 2))
    rhs = (L * _postprocess_adjoint(scene, dL, d)).sum((1, 2))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-5, atol=1e-6)
