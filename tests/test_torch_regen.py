"""The port's path regeneration (forward) held against its own wavefront
render and against the JAX package's regenerative render, on the CPU.

Regeneration changes only the schedule: every sample draws the numbers it
draws in the plain wavefront (RNG keyed by (pixel, sample), a dimension
counter per lane), so the regenerative image equals the standard one up
to the order in which a pixel's samples are summed. The tolerances are
tests/test_regen.py's: rtol 2e-4 / atol 2e-5 for ``path`` and 3e-4 / 3e-5
for ``volpath``. Against the JAX package's regenerative render the pixel
sums are added in the same order, and a pixel may differ only where an
ulp flipped a decision in one of its paths.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.render_api import _render_regen_pass as j_regen_pass

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.core.rng import RNG, lanes_rng, merge_rng
from mitsuba_tpu_torch.render.scene_loader import vol32_scene
from mitsuba_tpu_torch.render_api import _render_regen_pass as t_regen_pass

W, SPP = 16, 4
PATH_TOL = dict(rtol=2e-4, atol=2e-5)
VOL_TOL = dict(rtol=3e-4, atol=3e-5)


@pytest.fixture(autouse=True)
def _rgb():
    mj.set_variant("rgb")
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: MKL's first vector-math call from two threads
    can run its low-accuracy kernel on one chunk (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cbox(regenerate, max_depth=4):
    d = mj.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = W
    d["integrator"] = {"type": "path", "max_depth": max_depth, "regenerate": regenerate,
                       "defer_nee": False}
    return d


def vol(regenerate):
    """bench.py's deep volume (tests/test_regen.py's slab: sigma_t 4, albedo
    0.95, HG g 0.6 under a constant environment) at max_depth 4."""
    return vol32_scene(res=W, spp=SPP, max_depth=4, steps=8, regenerate=regenerate)


SCENES = {"path": (cbox, PATH_TOL), "volpath": (vol, VOL_TOL)}


@pytest.fixture(scope="module")
def jax_regen():
    """The JAX package's regenerative pixel sums and counters, made once."""
    out = {}
    for name, (make, _) in SCENES.items():
        L_px, aux = j_regen_pass(mj.load_dict(make(True)), jnp.uint32(3), SPP, 0)
        out[name] = (np.asarray(L_px), int(float(aux["n_rays"])), int(aux["wavefront_iters"]))
    return out


def test_lanes_and_merge_rng_keep_the_streams():
    lane = torch.arange(64, dtype=torch.int64) * 7919
    base = RNG(5, lane, dim=6)
    per_lane = lanes_rng(base, 64)
    assert per_lane.dim.shape == (64,)
    for a, b in zip(base.next_2d()[:2], per_lane.next_2d()[:2]):
        assert torch.equal(a, b)
    other = RNG(5, lane + 1, dim=2)
    m = torch.arange(64) % 3 == 0
    merged = merge_rng(other, per_lane, m)
    x_m, y_m, nxt = merged.next_2d()
    x_o, y_o, _ = other.next_2d()
    x_b, y_b, _ = base.next_2d()
    assert torch.equal(x_m, torch.where(m, x_o, x_b)) and torch.equal(y_m, torch.where(m, y_o, y_b))
    assert torch.equal(nxt.dim, torch.where(m, 4, 8))
    assert torch.equal(base.skip(10).next_1d()[0], RNG(5, lane, dim=16).next_1d()[0])


@pytest.mark.parametrize("name", list(SCENES))
def test_regen_matches_standard_and_jax(name, jax_regen):
    make, tol = SCENES[name]
    std = mt.render(mt.load_dict(make(False), device="cpu"), spp=SPP, seed=3).numpy()
    stats = {}
    scene = mt.load_dict(make(True), device="cpu")
    reg = mt.render(scene, spp=SPP, seed=3, stats=stats).numpy()
    assert reg.shape == (W, W, 3) and np.isfinite(reg).all() and reg.mean() > 0
    np.testing.assert_allclose(reg, std, **tol)
    Lj, rays_j, iters_j = jax_regen[name]
    np.testing.assert_allclose(reg, Lj.reshape(W, W, 3) / SPP, **tol)
    assert stats["n_rays"] == rays_j and stats["wavefront_iters"] == iters_j
    max_depth = scene.integrator.max_depth
    budget = SPP * (max_depth + 8 if name == "volpath" else max_depth)
    assert SPP <= stats["wavefront_iters"] <= budget
    # the regenerative pixel sums themselves, against the JAX package's
    L_px, aux = t_regen_pass(scene, 3, SPP, 0)
    np.testing.assert_allclose(L_px.numpy(), Lj, **tol)
    assert int(aux["n_invalid"]) == 0


def test_regen_refusals():
    """Regeneration refuses nothing any more: the PRB integrators (prb,
    prb_basic), the polarized and the spectral variants take
    ``regenerate`` and render with it (their gradients:
    tests/test_torch_regen_prb.py, tests/test_torch_spectral_regen.py); in
    spectral the surface path tracer renders its plain passes, as the JAX
    package's does."""
    mt.set_variant("spectral")
    try:
        img = mt.render(mt.load_dict(cbox(True), device="cpu"), spp=2, seed=0)
    finally:
        mt.set_variant("rgb")
    assert img.shape == (W, W, 3) and bool(torch.isfinite(img).all())
    for t in ("prb", "prb_basic"):
        d = cbox(True)
        d["integrator"]["type"] = t
        scene = mt.load_dict(d, device="cpu")
        assert scene.integrator.regenerate and scene.integrator.is_prb
        img = mt.render(scene, spp=2, seed=0)
        assert img.shape == (W, W, 3) and bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    mt.set_variant("mono_polarized")
    try:
        scene = mt.load_dict(vol32_scene(res=W, spp=SPP, max_depth=4, steps=8, regenerate=True),
                             device="cpu")
        img = mt.render(scene, spp=2, seed=0)
    finally:
        mt.set_variant("rgb")
    assert img.shape == (W, W, 4, 1) and bool(torch.isfinite(img).all())
