"""The rest of the port's render entry point against the JAX package on the
CPU: ``render``'s ``integrator=`` override, ``timeout=`` and ``cancel=``
(``CancelToken``), ``render_progressive`` and ``render_test``; ports of
tests/test_timeout_cancel.py, tests/test_cli_progressive.py::
test_render_progressive_matches_one_shot and tests/test_render_test_api.py.

The scenes keep max_depth below rr_depth, so no Russian roulette decision
can flip on a last-bit difference between the packages (XLA contracts
a*b + c into FMAs on the CPU, ROADMAP Queue 3): images agree with the JAX
package's to rtol 1e-4 / atol 1e-5, as tests/test_torch_render.py's do.
Within the port, a render stopped after its first pass, and the last
image of render_progressive, are bitwise the passes' own images, because
the film adds a pixel's samples in sample order however they are split.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.render.film import develop as j_develop
from mitsuba_tpu.render_api import _render_pass as j_render_pass

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.integrators.path import PathIntegrator

IMG_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _rgb():
    mj.set_variant("rgb")
    mt.set_variant("rgb")
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


def cbox(w=16, max_depth=3):
    """tests/test_timeout_cancel.py's scene: the Cornell box at w x w, box
    filter, path max_depth 3."""
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = w
    d["sensor"]["film"]["rfilter"] = {"type": "box"}
    d["integrator"] = {"type": "path", "max_depth": max_depth}
    return d


def jax_first_pass(d, spp_pass, spp_total, seed=0):
    """The JAX package's image of a render stopped after its first pass:
    pass 0's lanes (keyed by the whole spp_total) over the samples done."""
    js = mj.load_dict(d)
    L, _, _, aux = j_render_pass(js, jnp.uint32(seed), 0, spp_pass, spp_total, 0)
    return np.asarray(j_develop(js.film, L, spp_pass, jitter=aux.get("film_jitter")))


def first_image(scene, spp, spp_per_pass):
    """The port's image after the first pass of render_progressive."""
    return next(mt.render_progressive(scene, spp=spp, spp_per_pass=spp_per_pass, seed=0))[1]


def test_cancel_returns_partial_unbiased():
    """A token cancelled before the call: only pass 0 runs, and the image is
    its samples' mean (the JAX package's, and bitwise the first pass's); an
    untouched token changes nothing."""
    d = cbox()
    scene = mt.load_dict(d, device="cpu")
    tok = mt.CancelToken()
    tok.cancel()
    partial = mt.render(scene, spp=32, spp_per_pass=8, seed=0, cancel=tok)
    assert torch.equal(partial, first_image(scene, 32, 8))
    np.testing.assert_allclose(partial.numpy(), jax_first_pass(d, 8, 32), **IMG_TOL)
    full = mt.render(scene, spp=32, spp_per_pass=8, seed=0)
    assert torch.equal(mt.render(scene, spp=32, spp_per_pass=8, seed=0,
                                 cancel=mt.CancelToken()), full)
    assert not torch.equal(full, partial)


def test_timeout_zero_stops_after_first_pass():
    d = cbox()
    scene = mt.load_dict(d, device="cpu")
    img = mt.render(scene, spp=32, spp_per_pass=8, seed=0, timeout=0.0)
    assert torch.equal(img, first_image(scene, 32, 8))
    np.testing.assert_allclose(img.numpy(), jax_first_pass(d, 8, 32), **IMG_TOL)


def test_timeout_splits_passes_by_default():
    """With a timeout and no spp_per_pass, spp is split into passes of spp
    // 8 samples; a generous timeout renders them all: bitwise the render
    of spp_per_pass 4, and the JAX package's image."""
    d = cbox()
    scene = mt.load_dict(d, device="cpu")
    img = mt.render(scene, spp=32, seed=0, timeout=3600.0)
    assert torch.equal(img, mt.render(scene, spp=32, spp_per_pass=4, seed=0))
    want = np.asarray(mj.render(mj.load_dict(d), spp=32, spp_per_pass=4, seed=0))
    np.testing.assert_allclose(img.numpy(), want, **IMG_TOL)


def test_render_progressive_matches_one_shot():
    """render_progressive yields after every pass; its last image is the
    one-shot render's, bitwise, and the JAX package's."""
    d = cbox(w=32)
    scene = mt.load_dict(d, device="cpu")
    steps = list(mt.render_progressive(scene, spp=16, spp_per_pass=4, seed=0))
    assert [s for s, _ in steps] == [4, 8, 12, 16]
    full = mt.render(scene, spp=16, seed=0)
    assert torch.equal(steps[-1][1], full)
    assert all(bool(torch.isfinite(img).all()) for _, img in steps)
    from mitsuba_tpu.render_api import render_progressive as j_progressive

    want = list(j_progressive(mj.load_dict(d), spp=16, spp_per_pass=4, seed=0))
    assert [s for s, _ in want] == [4, 8, 12, 16]
    np.testing.assert_allclose(full.numpy(), np.asarray(want[-1][1]), **IMG_TOL)


def test_render_progressive_regenerate_yields_once():
    d = cbox()
    d["integrator"]["regenerate"] = True
    scene = mt.load_dict(d, device="cpu")
    steps = list(mt.render_progressive(scene, spp=8, spp_per_pass=2, seed=0))
    assert len(steps) == 1 and steps[0][0] == 8
    assert torch.equal(steps[0][1], mt.render(scene, spp=8, seed=0))


def two_views():
    """A wide 64x32 film split into two 32x32 views of two walls side by
    side under a constant environment, red on the camera's left and green
    on its right (the port has no batch sensor, so the views are the two
    halves of one perspective film)."""
    def wall(x, refl):
        return {"type": "rectangle",
                "to_world": [{"type": "scale", "value": 2.0},
                             {"type": "translate", "value": [x, 0, -2]}],
                "bsdf": {"type": "diffuse", "reflectance": refl}}

    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "left_wall": wall(-2.0, [0.8, 0.1, 0.1]),
        "right_wall": wall(2.0, [0.1, 0.8, 0.1]),
        "light": {"type": "constant", "radiance": 1.0},
        "sensor": {"type": "perspective", "fov": 90,
                   "to_world": [{"type": "look_at", "origin": [0, 0, 0], "target": [0, 0, -1],
                                 "up": [0, 1, 0]}],
                   "film": {"type": "hdrfilm", "width": 64, "height": 32}},
    }


def test_render_test_two_views():
    """render_test splits the film into sensor_count views and averages
    each: [views, C], the JAX package's (rtol 1e-5); view 0 sees the red
    wall, view 1 the green one, and each view is the mean of its half of a
    full render of the same samples."""
    d = two_views()
    scene = mt.load_dict(d, device="cpu")
    out = mt.render_test(scene, spp=16, seed=0, sensor_count=2)
    assert out.shape == (2, 3)
    out = out.numpy()
    assert out[0, 0] > 2.0 * out[0, 1] and out[1, 1] > 2.0 * out[1, 0], out
    want = np.asarray(mj.render_test(mj.load_dict(d), spp=16, seed=0, sensor_count=2))
    np.testing.assert_allclose(out, want, rtol=1e-5)
    img = mt.render(scene, spp=16, seed=0).numpy()
    np.testing.assert_allclose(out[0], img[:, :32].mean(axis=(0, 1)), rtol=1e-5)
    np.testing.assert_allclose(out[1], img[:, 32:].mean(axis=(0, 1)), rtol=1e-5)


def test_render_test_polarized_shape():
    """In mono_polarized render_test gives the Stokes vectors [views, 4, C]:
    the JAX package's (I to rtol 1e-5, Q/U/V to 1e-5 of I), and their mean
    over the views is render_1's."""
    _variant = "mono_polarized"
    mj.set_variant(_variant)
    mt.set_variant(_variant)
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = 32
    d["sensor"]["film"]["height"] = 16
    d["integrator"] = {"type": "volpath", "max_depth": 3}
    scene = mt.load_dict(d, device="cpu")
    out = mt.render_test(scene, spp=4, seed=0, sensor_count=2)
    assert out.shape == (2, 4, 1) and bool(torch.isfinite(out).all())
    assert bool((out[:, 0] > 0).all())
    out = out.numpy()
    want = np.asarray(mj.render_test(mj.load_dict(d), spp=4, seed=0, sensor_count=2))
    I = np.abs(want[:, 0]).max()
    np.testing.assert_allclose(out[:, 0], want[:, 0], rtol=1e-5)
    np.testing.assert_allclose(out[:, 1:], want[:, 1:], atol=1e-5 * I)
    one = mt.render_1(scene, spp=4, seed=0).numpy()
    np.testing.assert_allclose(out.mean(axis=0), one, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("form", ["dict", "instance"])
def test_render_integrator_override(form):
    """render(integrator=...) takes a scene-dict spec or an integrator
    instance and renders as a scene loaded with that integrator, bitwise;
    and as the JAX package's render with the same override."""
    d = cbox(max_depth=4)
    spec = {"type": "path", "max_depth": 2}
    scene = mt.load_dict(d, device="cpu")
    over = spec if form == "dict" else PathIntegrator(max_depth=2)
    img = mt.render(scene, spp=4, seed=1, integrator=over)
    d2 = dict(d, integrator=spec)
    assert torch.equal(img, mt.render(mt.load_dict(d2, device="cpu"), spp=4, seed=1))
    assert not torch.equal(img, mt.render(scene, spp=4, seed=1))
    assert scene.integrator.max_depth == 4
    if form == "dict":
        j_over = spec
    else:
        from mitsuba_tpu.integrators import make_integrator as j_make_integrator

        j_over = j_make_integrator(spec)
    want = np.asarray(mj.render(mj.load_dict(d), spp=4, seed=1, integrator=j_over))
    np.testing.assert_allclose(img.numpy(), want, **IMG_TOL)
