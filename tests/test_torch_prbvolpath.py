"""The volumetric PRB replay of the PyTorch port (prbvolpath) against the
JAX package on the CPU: the gradients of a scene with a homogeneous
(HG) and an 8^3 grid medium, for the homogeneous medium's albedo, sigma_t
and HG g, the environment's radiance and the grid's sigma_t data; the
replay's primal against volpath; the routing of the names; and the refusals
the reference keeps.

Both packages load the same scene dict and take the gradient of the image
mean at the same seed (the JAX side through jax.jit(jax.grad), computed
once, in one test: tracing the JAX replay takes ~30 s). Parameters are set
through traverse().update() in both, so the grid's majorant follows its
data as the reference's parameters_changed makes it. The gradients agree
to rtol 1e-4 (the image's lanes to ~1e-6; XLA contracts a*b + c into FMAs
on the CPU and the port does not).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.ad.prbvolpath import PRBVolpathIntegrator

SPP, SEED = 4, 3
GRAD_RTOL = 1e-4
KEYS = ("hom.albedo.value.value", "hom.sigma_t.value.value", "hom.phase_function.g",
        "env.radiance.value", "right.interior_medium.sigma_t.data")


@pytest.fixture(autouse=True)
def _mono():
    mj.set_variant("mono")
    mt.set_variant("mono")
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


def two_media(integrator="prbvolpath", max_depth=3):
    """A 4x4 camera over two null cubes side by side under a constant
    environment: the left holds a homogeneous medium (sigma_t 1, albedo 0.5,
    HG g 0.5), the right an 8^3 grid of sigma_t in [0.15, 1.25) (numpy
    default_rng(0)), albedo 0.8, isotropic."""
    grid = (0.3 + 2.2 * np.random.default_rng(0).random((8, 8, 8, 1))).astype(np.float32) * 0.5
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": max_depth},
        "sensor": {
            "type": "perspective", "fov": 40,
            "to_world": [{"type": "look_at", "origin": [0, 0, 5], "target": [0, 0, 0],
                          "up": [0, 1, 0]}],
            "film": {"type": "hdrfilm", "width": 4, "height": 4, "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": SPP},
        },
        "env": {"type": "constant", "radiance": 1.0},
        "hom": {"type": "homogeneous", "sigma_t": 1.0, "albedo": 0.5,
                "phase": {"type": "hg", "g": 0.5}},
        "left": {"type": "cube", "bsdf": {"type": "null"},
                 "to_world": [{"type": "scale", "value": 0.7},
                              {"type": "translate", "value": [-0.8, 0, 0]}],
                 "interior": {"type": "ref", "id": "hom"}},
        "right": {"type": "cube", "bsdf": {"type": "null"},
                  "to_world": [{"type": "scale", "value": 0.7},
                               {"type": "translate", "value": [0.8, 0, 0]}],
                  "interior": {"type": "heterogeneous", "albedo": 0.8,
                               "sigma_t": {"type": "gridvolume", "data": grid,
                                           "bbox_min": [-1, -1, -1], "bbox_max": [1, 1, 1]}}},
    }


def jax_grads(d, keys, spp=SPP, seed=SEED):
    """(image mean, {key: gradient}) of the JAX package."""
    js = mj.load_dict(d)

    def loss(vals):
        return jnp.mean(mj.render(mj.traverse(js).update(dict(zip(keys, vals))), spp=spp,
                                  seed=seed))

    p = mj.traverse(js)
    v, g = jax.jit(jax.value_and_grad(loss))(tuple(p[k] for k in keys))
    return float(v), {k: np.asarray(x) for k, x in zip(keys, g)}


def port_grads(d, keys, spp=SPP, seed=SEED, stats=None):
    """(image mean, {key: gradient}) of the port."""
    p = mt.traverse(mt.load_dict(d, device="cpu"))
    leaves = {k: p[k].clone().requires_grad_() for k in keys}
    loss = mt.render(p.update(leaves), spp=spp, seed=seed, stats=stats).mean()
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy() for k, v in leaves.items()}


def test_prbvolpath_gradients_match_jax():
    """Every parameter kind of the replay (the albedo, sigma_t and HG g of a
    homogeneous medium, an emitter's radiance, a grid's sigma_t through its
    trilinear lookup and its majorant) against jax.grad of the same loss."""
    d = two_media()
    want_v, want = jax_grads(d, KEYS)
    stats = {}
    got_v, got = port_grads(d, KEYS, stats=stats)
    assert got_v == pytest.approx(want_v, rel=1e-5)
    assert stats["n_rays"] > 0 and stats["n_rays_grad"] > stats["n_rays"]
    for k in KEYS:
        assert np.any(want[k] != 0), k
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=GRAD_RTOL * scale,
                                   err_msg=k)


def test_prbvolpath_primal_is_volpath():
    """The PRB forward pass is the volumetric path tracer's: the same image
    bitwise, the same rays counted; its default budgets are volpath's."""
    s_prb = mt.load_dict(two_media(), device="cpu")
    s_vol = mt.load_dict(two_media("volpath"), device="cpu")
    assert isinstance(s_prb.integrator, PRBVolpathIntegrator) and s_prb.integrator.is_prb
    st_p, st_v = {}, {}
    a = mt.render(s_prb, spp=SPP, seed=5, stats=st_p)
    b = mt.render(s_vol, spp=SPP, seed=5, stats=st_v)
    assert torch.equal(a, b)
    assert st_p["n_rays"] == st_v["n_rays"]


def test_prbvolpath_radiometer_gradient_is_linear_fd():
    """render_1 takes the PRB pass too: for the environment's radiance, on
    which the image is linear, the replay's gradient equals the derivative
    of the primal at the backward pass's seed (its samples) to rtol 1e-5."""
    from mitsuba_tpu_torch.ad.render_ad import derive_seed_grad

    d = two_media()
    d["sensor"]["type"] = "radiancemeter"
    key = "env.radiance.value"
    p = mt.traverse(mt.load_dict(d, device="cpu"))
    v = p[key].clone().requires_grad_()
    mt.render_1(p.update({key: v}), spp=SPP, seed=SEED).sum().backward()
    d["integrator"]["type"] = "volpath"
    p = mt.traverse(mt.load_dict(d, device="cpu"))
    lin = mt.render_1(p.update({key: torch.ones(1)}), spp=SPP, seed=derive_seed_grad(SEED))
    np.testing.assert_allclose(v.grad.numpy(), lin.numpy(), rtol=1e-5)


def test_prbvolpath_names_and_refusals():
    """prbvolpath and prb_unpolarized are the volumetric replay, and take
    ``regenerate`` (its regenerative replay: tests/test_torch_regen_prb.py);
    the reference's refusals stand: render_forward, and prb_polarized
    outside a polarized variant."""
    for name in ("prbvolpath", "prb_unpolarized"):
        scene = mt.load_dict(two_media(name), device="cpu")
        assert type(scene.integrator) is PRBVolpathIntegrator
        assert (scene.integrator.track_steps, scene.integrator.nee_steps) == (32, 32)
    d = two_media()
    d["integrator"]["regenerate"] = True
    scene = mt.load_dict(d, device="cpu")
    assert type(scene.integrator) is PRBVolpathIntegrator and scene.integrator.regenerate
    with pytest.raises(NotImplementedError):
        mt.render_forward(mt.load_dict(two_media(), device="cpu"), key="env.radiance.value")
    with pytest.raises(ValueError, match="polarized"):
        mt.load_dict(two_media("prb_polarized"), device="cpu")
    with pytest.raises(ValueError, match="polarized"):
        mj.load_dict(two_media("prb_polarized"))
