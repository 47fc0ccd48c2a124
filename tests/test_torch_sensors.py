"""The port's sensors and film of the material-preview slice against the
JAX package on the CPU: the thin-lens, orthographic, irradiancemeter,
distant and batch sensors' rays, the negative-lobe filters (mitchell,
catmullrom, lanczos) and their weighted develop, the crop window; and
renders through them: the batch sensor through render_test, the distant
sensor and the irradiancemeter through render_1.

Inputs are made from numpy seeds; the JAX side goes through jax.jit with
the scene closed over, or its develop op by op. sample_ray is held at
rtol 1e-6 (atol 1e-6 times the field's largest magnitude: the last place
of sqrt, sin and cos); the develop at rtol 1e-5 (its sums are ordered
differently); crop renders bit for bit against the full render's window
in the port, and at rtol 1e-4 / atol 1e-5 against the JAX package's full
render's (the lane tolerance of tests/test_torch_render.py); the means of
the sensor renders within 1e-3 relative.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.render import film as jfilm
from mitsuba_tpu.render.scene_loader import parse_sensor as j_parse_sensor

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.render import film as tfilm
from mitsuba_tpu_torch.render.scene_loader import parse_sensor as t_parse_sensor

N = 512
MEAN_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _rgb():
    mj.set_variant("rgb")
    mt.set_variant("rgb")
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what, rtol=1e-6, atol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, err_msg=what, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


LOOK = [{"type": "look_at", "origin": [0.3, 0.5, 3.5], "target": [0, 0, 0], "up": [0, 1, 0]}]
FILM = {"type": "hdrfilm", "width": 24, "height": 16}
SENSORS = {
    "thinlens": {"type": "thinlens", "fov": 35.0, "fov_axis": "y", "aperture_radius": 0.2,
                 "focus_distance": 3.0, "to_world": LOOK, "film": FILM},
    "orthographic": {"type": "orthographic", "film": FILM,
                     "to_world": LOOK + [{"type": "scale", "value": 1.5}]},
    "irradiancemeter": {"type": "irradiancemeter", "to_world": LOOK},
    "distant": {"type": "distant", "direction": [0.3, -1.0, 0.2]},
    "distant-target": {"type": "distant", "direction": [0.3, -1.0, 0.2],
                       "target": [0.1, 0.2, -0.3], "wavelength": 550.0},
    "batch": {"type": "batch", "film": {"type": "hdrfilm", "width": 32, "height": 16},
              "a": {"type": "perspective", "fov": 30.0, "to_world": LOOK,
                    "film": {"type": "hdrfilm", "width": 16, "height": 16}},
              "b": {"type": "orthographic", "to_world": LOOK,
                    "film": {"type": "hdrfilm", "width": 16, "height": 16}}},
}


@pytest.mark.parametrize("name", list(SENSORS))
def test_sample_ray_matches_jax(name):
    cam_j = j_parse_sensor(SENSORS[name])[0]
    cam_t = t_parse_sensor(SENSORS[name], "cpu")[0]
    assert type(cam_t).__name__ == type(cam_j).__name__
    u = np.random.default_rng(7).random((N, 4)).astype(np.float32)
    ray_j = jax.jit(lambda p, a: cam_j.sample_ray(p, a))(u[:, :2], u[:, 2:])
    ray_t = cam_t.sample_ray(torch.from_numpy(u[:, :2]), torch.from_numpy(u[:, 2:]))
    _close(ray_t.o, ray_j.o, f"{name} o")
    _close(ray_t.d, ray_j.d, f"{name} d")
    assert torch.isinf(ray_t.maxt).all()


@pytest.mark.parametrize("rfilter", ["mitchell", "catmullrom", "lanczos"])
def test_weighted_develop_matches_jax(rfilter):
    """The filter-weighted develop of seeded lanes and jitter, the whole
    film and a crop window (the port adds the samples of the filter's
    margin around the window, so its window is the whole film's)."""
    H, W, spp = 9, 11, 5
    rng = np.random.default_rng(2)
    vals = rng.random((H * W * spp, 3)).astype(np.float32)
    jit_ = rng.random((H * W * spp, 2)).astype(np.float32)
    fj, ft = jfilm.Film(width=W, height=H, rfilter=rfilter), tfilm.Film(W, H, rfilter)
    with jax.disable_jit():
        img_j = np.asarray(jfilm.develop(fj, jnp.asarray(vals), spp, jitter=jnp.asarray(jit_)))
    img_t = tfilm.develop(ft, torch.from_numpy(vals), spp, jitter=torch.from_numpy(jit_))
    _close(img_t, img_j, rfilter, rtol=1e-5, atol=1e-6)
    x = torch.linspace(-3.5, 3.5, 71)
    _close(tfilm.filter_eval_1d(rfilter, x), jfilm.filter_eval_1d(rfilter, jnp.asarray(x.numpy())),
           f"{rfilter} 1d")
    crop = tfilm.Film(W, H, rfilter, crop_offset=(3, 2), crop_size=(5, 4))
    x0, y0, cw, ch = crop.lane_window
    pix = np.arange(H * W).reshape(H, W)[y0:y0 + ch, x0:x0 + cw].reshape(-1)
    lanes = (pix[:, None] * spp + np.arange(spp)).reshape(-1)
    img_c = tfilm.develop(crop, torch.from_numpy(vals[lanes]), spp,
                          jitter=torch.from_numpy(jit_[lanes]))
    assert torch.equal(img_c, img_t[2:6, 3:8])


@pytest.mark.parametrize("rfilter", ["mitchell", "lanczos", "gaussian"])
def test_split_invariance_and_crop(rfilter):
    """The image is bitwise the same however spp is split into passes (the
    weighted filters sum numerator and denominator over the passes and
    divide once); a crop render is bitwise the full render's window, and
    the JAX package's full render's at the lane tolerance."""
    d = mt.spheres_scene(16, 4, {"type": "path", "max_depth": 3})
    d["sensor"]["film"]["rfilter"] = {"type": rfilter}
    ts = mt.load_dict(d, device="cpu")
    full = mt.render(ts, spp=4, seed=3)
    for spp_per_pass in (1, 3):
        assert torch.equal(mt.render(ts, spp=4, seed=3, spp_per_pass=spp_per_pass), full)
    d["sensor"]["film"].update(crop_offset_x=5, crop_offset_y=2, crop_width=7, crop_height=9)
    crop = mt.render(mt.load_dict(d, device="cpu"), spp=4, seed=3, spp_per_pass=3)
    assert crop.shape == (9, 7, 3) and torch.equal(crop, full[2:11, 5:12])
    if rfilter == "mitchell":
        del d["sensor"]["film"]["crop_width"]
        js = mj.load_dict(mt.spheres_scene(16, 4, {"type": "path", "max_depth": 3}))
        img_j = np.asarray(mj.render(js, spp=4, seed=3))
        _close(crop, img_j[2:11, 5:12], "crop vs JAX", rtol=1e-4, atol=1e-5)


def test_batch_render_test_matches_jax():
    """A batch of two perspectives over the cbox through render_test, the
    views' means against the JAX package's."""
    d = mt.cornell_box()
    views = []
    for x in (-0.6, 0.6):
        views.append({"type": "perspective", "fov": 40.0,
                      "to_world": [{"type": "look_at", "origin": [x, 0.0, 3.9],
                                    "target": [0, 0, 0], "up": [0, 1, 0]}],
                      "film": {"type": "hdrfilm", "width": 12, "height": 12}})
    d["sensor"] = {"type": "batch", "film": {"type": "hdrfilm", "width": 24, "height": 12,
                                             "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 8}, "left": views[0],
                   "right": views[1]}
    d["integrator"] = {"type": "path", "max_depth": 4}
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    got = mt.render_test(ts, spp=8, seed=1, sensor_count=2)
    want = np.asarray(mj.render_test(js, spp=8, seed=1, sensor_count=2))
    assert got.shape == (2, 3)
    _close(got, want, "batch views", rtol=MEAN_RTOL, atol=0.0)
    assert not torch.allclose(got[0], got[1])


@pytest.mark.parametrize("sensor", ["distant", "irradiancemeter", "orthographic"])
def test_sensor_renders_match_jax(sensor):
    """render_1 of the cbox through a distant sensor (with a target: the
    JAX package's loader sets no scene bounds, ROADMAP Queue 3) and an
    irradiancemeter on the floor looking up, and an orthographic render;
    their means within 1e-3 of the JAX package's."""
    d = mt.cornell_box()
    film = {"type": "hdrfilm", "width": 12, "height": 12, "rfilter": {"type": "box"}}
    d["sensor"] = {
        "distant": {"type": "distant", "direction": [0.1, -0.2, -1.0], "target": [0, -0.3, 0]},
        "irradiancemeter": {"type": "irradiancemeter",
                            "to_world": [{"type": "look_at", "origin": [0.0, -0.99, 0.0],
                                          "target": [0.0, 1.0, 0.0], "up": [0, 0, 1]}]},
        "orthographic": {"type": "orthographic",
                         "to_world": [{"type": "look_at", "origin": [0, 0, 3.9],
                                       "target": [0, 0, 0], "up": [0, 1, 0]}]},
    }[sensor]
    d["sensor"].update(film=film, sampler={"type": "independent", "sample_count": 8})
    d["integrator"] = {"type": "path", "max_depth": 4}
    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    if sensor == "orthographic":
        got = mt.render(ts, spp=8, seed=2).mean(dim=(0, 1))
        want = np.asarray(mj.render(js, spp=8, seed=2)).mean(axis=(0, 1))
    else:
        got = mt.render_1(ts, spp=8, seed=2)
        want = np.asarray(mj.render_1(js, spp=8, seed=2))
    assert float(got.min()) > 0
    _close(got, want, sensor, rtol=MEAN_RTOL, atol=0.0)
