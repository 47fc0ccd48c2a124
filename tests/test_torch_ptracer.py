"""The port's particle tracer (ptracer) and the point light, held against
the JAX package on the CPU.

Every particle draws the JAX package's numbers, so the particles start at
the same points, bounce the same way and splat into the same pixels. The
start of each particle (_sample_emitter_ray) is held lane by lane at rtol
1e-6 / atol 1e-6 (the last place of sqrt, sin and cos, and XLA's fused
multiply-adds on the CPU). The image is held with allclose at rtol 1e-4 /
atol 1e-6: each pixel is a sum of splats whose order differs (the JAX
package's segment_sum, the port's index_add_, which on the card is atomics
in no fixed order), so the sums agree to their rounding, not bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.integrators import ptracer as JPT
from mitsuba_tpu.render_api import _ptracer_pass

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.integrators import ptracer as TPT

W, SPP, DEPTH = 16, 4, 3
LANE_TOL = dict(rtol=1e-6, atol=1e-6)
IMG_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _rgb():
    mj.set_variant("rgb")
    mt.set_variant("rgb")
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (ROADMAP Queue 3: MKL's first vector-math call
    from two threads can take its low-accuracy kernel on one chunk)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cbox(integrator):
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = W
    d["integrator"] = integrator
    return d


def _point_scene():
    """The cbox with a point light under its ceiling beside the area
    light, so that both branches of the emitter sampling run."""
    d = _cbox({"type": "ptracer", "max_depth": DEPTH})
    d["bulb"] = {"type": "point", "position": [0.1, 0.8, 0.2], "intensity": {"type": "rgb",
                                                                          "value": [4.0, 3.0, 2.0]}}
    return d


@pytest.mark.parametrize("scene", ["cbox", "point"])
def test_sample_emitter_ray_lane_by_lane(scene):
    d = _cbox({"type": "ptracer"}) if scene == "cbox" else _point_scene()
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    assert len(ts.emitters) == (1 if scene == "cbox" else 2)
    u = np.random.default_rng(5).random((5, 512)).astype(np.float32)
    out_j = jax.jit(lambda u: JPT._sample_emitter_ray(js, u[0], u[1:3].T, u[3:5].T, None))(u)
    ut = torch.from_numpy(u)
    out_t = TPT._sample_emitter_ray(ts, ut[0], ut[1:3].T, ut[3:5].T)
    for name, a, b in zip(("p", "d", "n_emit", "weight", "rad0", "inv_ppos"), out_j, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name, **LANE_TOL)
    if scene == "point":
        # both emitters drew particles; the point light's have no position pdf
        inv = out_t[5].numpy()
        assert (inv == 0).sum() > 100 and (inv > 0).sum() > 100


@pytest.mark.parametrize("scene", ["cbox", "point"])
def test_ptracer_image_matches_jax(scene):
    d = _cbox({"type": "ptracer", "max_depth": DEPTH}) if scene == "cbox" else _point_scene()
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    ref = np.asarray(_ptracer_pass(js, jnp.uint32(3), SPP, 0))
    stats = {}
    img = mt.render(ts, spp=SPP, seed=3, stats=stats)
    assert img.shape == (W, W, 3) and stats["n_rays"] > 0
    assert float(img.mean()) > 0.01
    np.testing.assert_allclose(img.numpy(), ref, **IMG_TOL)


def test_ptracer_routes_and_refuses():
    """render_progressive yields the one full render; the spectral and
    polarized variants are refused."""
    ts = mt.load_dict(_cbox({"type": "ptracer", "max_depth": DEPTH}), device="cpu")
    (done, img), = list(mt.render_progressive(ts, seed=1, spp=2))
    assert done == 2 and torch.equal(img, mt.render(ts, seed=1, spp=2))
    assert isinstance(ts.integrator, TPT.PTracerIntegrator)
    mt.set_variant("mono_polarized")
    with pytest.raises(ValueError):
        mt.render(mt.load_dict(_cbox({"type": "ptracer"}), device="cpu"), spp=1)


def test_point_lights_fuse_and_match_jax():
    """Five point lights fuse into one PointEmitterArray (as in the JAX
    package); a direct render of them matches the JAX package's, and the
    fused intensities are one parameter."""
    d = _cbox({"type": "direct"})
    for i in range(5):
        d[f"bulb{i}"] = {"type": "point", "position": [-0.6 + 0.3 * i, 0.8, 0.1 * i],
                         "intensity": 1.0 + i}
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    assert type(ts.emitters[-1]).__name__ == "PointEmitterArray"
    assert len(ts.emitters) == len(js.emitters) == 2
    assert "point_lights.values" in mt.traverse(ts)
    from mitsuba_tpu.render_api import _render_pass
    from mitsuba_tpu_torch.render_api import render_lanes

    L_j, _, _, _ = _render_pass(js, jnp.uint32(2), 0, 2, 2, 0)
    L_t, _ = render_lanes(ts, 2, 0, W * W * 2, 0, 2, 2, 0)
    close = np.isclose(L_t.numpy(), np.asarray(L_j), rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()
    # a differentiable intensity table
    p = mt.traverse(ts)
    v = p["point_lights.values"].clone().requires_grad_()
    mt.render(p.update({"point_lights.values": v}), spp=1, seed=0).mean().backward()
    assert v.grad is not None and float(v.grad.abs().sum()) > 0
