"""The port's PRB gradient step (Slice 3) held against the JAX package on the
CPU: the seed derivation, the PRB and prb_basic gradients, the optimizers;
and the port's own invariants: the PRB primal is the path image, spp_grad's
refold is exact, and the gradient agrees with central finite differences.

Both packages load the same scene dict and the JAX scene's parameters are
carried into the port. rr_depth lies above max_depth, so that no Russian
roulette decision can flip on a last-bit difference (XLA on the CPU
contracts a*b + c into FMAs and the port does not, ROADMAP Queue 3): every
path is then the same in both packages and the per-lane radiance agrees to
about 1e-6. The gradients sum such lanes and are held at rtol 1e-5.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.ad import optimizers as j_opt
from mitsuba_tpu.ad.render_ad import derive_seed_grad as j_derive_seed_grad
from mitsuba_tpu.render.params import _tree_get, _tree_set

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.ad.render_ad import derive_seed_grad

KEYS = ("white.reflectance.value", "light.emitter.radiance.value")
W, SPP, DEPTH = 8, 4, 3
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _rgb():
    mj.set_variant("rgb")
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread. PyTorch's CPU kernels hand contiguous float
    math (sqrt, log, sin, cos, exp) to MKL's vector library in chunks, one
    per thread; when two threads make a process's first such call at once,
    MKL's lazy kernel dispatch races, and one chunk has come back from its
    low-accuracy kernel (a 4096-lane sqrt off by up to 2.98e-4 relative on
    lanes 2048-4095). One thread also keeps the suite's worker processes
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cbox(integrator="prb", w=W, depth=DEPTH):
    d = mj.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = w
    d["integrator"] = {"type": integrator, "max_depth": depth, "rr_depth": depth + 2}
    return d


def _port(d, js=None):
    """The port's scene on the CPU, with the JAX scene's parameters."""
    ts = mt.load_dict(d, device="cpu")
    if js is None:
        return ts
    p = mj.traverse(js)
    return mt.traverse(ts).update({k: np.asarray(p[k]) for k in p.keys()})


def _port_grads(scene, keys, **render_kw):
    """(image, {key: gradient of the image sum})."""
    params = mt.traverse(scene)
    leaves = {k: params[k].clone().requires_grad_() for k in keys}
    img = mt.render(params.update(leaves), **render_kw)
    img.sum().backward()
    return img.detach(), {k: v.grad for k, v in leaves.items()}


@pytest.fixture(scope="module", params=["prb", "prb_basic"])
def jax_grads(request):
    """The JAX package's gradients of the image sum for both keys, one
    compile per integrator (shared by the tests of this file)."""
    mj.set_variant("rgb")
    d = _cbox(request.param)
    js = mj.load_dict(d)
    paths = [dict(js.param_paths)[k] for k in KEYS]

    def loss(values):
        s = js
        for path, v in zip(paths, values):
            s = _tree_set(s, path, v)
        return jnp.sum(mj.render(s, spp=SPP, seed=3))

    g = jax.grad(loss)(tuple(_tree_get(js, p) for p in paths))
    return request.param, d, js, {k: np.asarray(x) for k, x in zip(KEYS, g)}


def test_derive_seed_grad_matches_jax():
    for seed in (0, 1, 3, 12345, 2**32 - 1):
        assert derive_seed_grad(seed) == int(j_derive_seed_grad(seed))
    assert derive_seed_grad(5, 9) == int(j_derive_seed_grad(5, 9)) == 9
    for f in (derive_seed_grad, j_derive_seed_grad):
        with pytest.raises(ValueError, match="seed_grad"):
            f(7, 7)


def test_prb_gradient_matches_jax(jax_grads):
    integrator, d, js, want = jax_grads
    ts = _port(d, js)
    assert ts.integrator.is_prb and ts.integrator.use_nee == (integrator == "prb")
    _, got = _port_grads(ts, KEYS, spp=SPP, seed=3)
    for k in KEYS:
        assert np.all(want[k] != 0), k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=GRAD_RTOL, err_msg=k)


def test_prb_primal_is_the_path_image():
    """The PRB forward pass is the path tracer's: the same image bitwise;
    the same rays counted."""
    img_prb, stats_prb = None, {}
    for t in ("prb", "path"):
        scene = mt.load_dict(_cbox(t), device="cpu")
        stats = {}
        img = mt.render(scene, spp=SPP, seed=9, stats=stats)
        if img_prb is None:
            img_prb, stats_prb = img, stats
    assert torch.equal(img_prb, img)
    assert stats_prb["n_rays"] == stats["n_rays"]


def test_spp_grad_refold_is_exact():
    """spp_grad == spp is the default bitwise. With spp_grad = 2 spp the
    backward pass takes the lanes of a 2 spp render at the same seed_grad
    with the refolded adjoint 1 / (2 spp): its gradient equals a 2 spp
    render's bitwise."""
    scene = mt.load_dict(_cbox(), device="cpu")
    _, g_default = _port_grads(scene, KEYS[:1], spp=SPP, seed=3)
    _, g_same = _port_grads(scene, KEYS[:1], spp=SPP, seed=3, spp_grad=SPP)
    _, g_refold = _port_grads(scene, KEYS[:1], spp=SPP, seed=3, spp_grad=2 * SPP)
    _, g_double = _port_grads(scene, KEYS[:1], spp=2 * SPP, seed=3)
    assert torch.equal(g_default[KEYS[0]], g_same[KEYS[0]])
    assert torch.equal(g_refold[KEYS[0]], g_double[KEYS[0]])
    assert not torch.equal(g_refold[KEYS[0]], g_default[KEYS[0]])


def test_spp_grad_refusals():
    scene = mt.load_dict(_cbox(), device="cpu")
    with pytest.raises(ValueError, match="single pass"):
        mt.render(scene, spp=4, spp_per_pass=2, spp_grad=8)
    with pytest.raises(ValueError, match="PRB"):
        mt.render(mt.load_dict(_cbox("path"), device="cpu"), spp=4, spp_grad=8)
    # the port's film refuses the weighted filters when it is made, so the
    # check is reached with a stand-in film that names one
    film = dataclasses.replace(scene.film)
    object.__setattr__(film, "rfilter", "mitchell")
    with pytest.raises(ValueError, match="filter"):
        mt.render(dataclasses.replace(scene, film=film), spp=4, spp_grad=8)


def test_prb_gradient_vs_central_fd():
    """The PRB gradient of white.reflectance.value against central finite
    differences with the same seed (correlated), the JAX package's bar of
    0.05 (tests/test_ad.py)."""
    d = _cbox(w=16, depth=4)
    d["sensor"]["film"]["rfilter"] = {"type": "box"}
    scene = mt.load_dict(d, device="cpu")
    key, eps, spp = KEYS[0], 2e-3, 64
    _, g = _port_grads(scene, (key,), spp=spp, seed=3)
    params = mt.traverse(scene)
    base = params[key].clone()

    def f(t):
        return float(mt.render(mt.traverse(scene).update({key: base + t}), spp=spp, seed=3).sum())

    fd = (f(eps) - f(-eps)) / (2 * eps)
    ad = float(g[key].sum())
    assert fd != 0.0
    assert abs(ad - fd) / max(abs(fd), 1e-3) < 0.05, (fd, ad)


def test_render_forward():
    """A PRB integrator has no forward mode (NotImplementedError, as in the
    JAX package); on the path integrator render_forward's JVP is the
    transpose of the tape VJP: <J t, c> = <t, J^T c>."""
    with pytest.raises(NotImplementedError):
        mt.render_forward(mt.load_dict(_cbox(), device="cpu"), key=KEYS[0])
    scene = mt.load_dict(_cbox("path", depth=2), device="cpu")
    tangent = torch.tensor([0.3, -0.2, 0.5])
    jvp = mt.render_forward(scene, tangent, KEYS[0], spp=2, seed=1)
    c = torch.from_numpy(np.random.default_rng(0).random((W, W, 3), dtype=np.float32))
    params = mt.traverse(scene)
    v = params[KEYS[0]].clone().requires_grad_()
    (mt.render(params.update({KEYS[0]: v}), spp=2, seed=1) * c).sum().backward()
    assert float((jvp * c).sum()) == pytest.approx(float((v.grad * tangent).sum()), rel=1e-5)


def test_render_forward_calling_forms():
    """The reference's parameter order, render_forward(scene, tangent=None,
    key=None, ...): positional and keyword calls agree, a missing tangent
    is ones, and neither argument (or a tangent without its key, which has
    no scene-tangent pytree here) raises ValueError."""
    scene = mt.load_dict(_cbox("path", w=4, depth=2), device="cpu")
    tangent = torch.tensor([1.0, 1.0, 1.0])
    a = mt.render_forward(scene, tangent, KEYS[0], 0, 1, 2)
    b = mt.render_forward(scene, key=KEYS[0], tangent=tangent, seed=1, spp=2)
    c = mt.render_forward(scene, key=KEYS[0], seed=1, spp=2)
    assert torch.equal(a, b) and torch.equal(a, c) and bool(a.abs().sum() > 0)
    with pytest.raises(ValueError, match="tangent` or `key"):
        mt.render_forward(scene)
    with pytest.raises(ValueError):
        mt.render_forward(scene, tangent)


def test_integrator_types():
    for t, nee in (("prb", True), ("prb_basic", False)):
        scene = mt.load_dict(_cbox(t), device="cpu")
        assert scene.integrator.is_prb and scene.integrator.use_nee is nee
    assert not getattr(mt.load_dict(_cbox("path"), device="cpu").integrator, "is_prb", False)
    assert type(mt.load_dict(_cbox("volpath"), device="cpu").integrator).__name__ == \
        "VolPathIntegrator"
    assert type(mt.load_dict(_cbox("prbvolpath"), device="cpu").integrator).__name__ == \
        "PRBVolpathIntegrator"
    assert type(mt.load_dict(_cbox("direct"), device="cpu").integrator).__name__ == \
        "DirectIntegrator"
    for t, cls in (("ptracer", "PTracerIntegrator"), ("volpathmis", "VolPathMisIntegrator"),
                   ("direct_projective", "ProjectiveIntegrator"),
                   ("prb_projective", "ProjectiveIntegrator")):
        assert type(mt.load_dict(_cbox(t), device="cpu").integrator).__name__ == cls
    bases = {t: type(mt.load_dict(_cbox(t), device="cpu").integrator.base).__name__
             for t in ("direct_projective", "prb_projective")}
    assert bases == {"direct_projective": "DirectIntegrator", "prb_projective": "PRBIntegrator"}


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _grad_sequence(n=6):
    r = np.random.default_rng(4)
    return [{"a": r.normal(size=3).astype(np.float32), "b": r.normal(size=(2, 2)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("make", [
    lambda m: m.SGD(lr=0.1),
    lambda m: m.SGD(lr=0.1, momentum=0.9),
    lambda m: m.Adam(lr=0.05),
    lambda m: m.Adam(lr=0.05, uniform=True),
], ids=["sgd", "sgd-momentum", "adam", "adam-uniform"])
def test_optimizers_match_jax(make):
    j, t = make(j_opt), make(mt.ad)
    for o in (j, t):
        o["a"] = np.array([0.5, 0.2, 0.9], np.float32)
        o["b"] = np.full((2, 2), 0.3, np.float32)
        o.set_learning_rate({"b": 0.02})
    for grads in _grad_sequence():
        jv = j.step({k: jnp.asarray(g) for k, g in grads.items()})
        tv = t.step({k: torch.from_numpy(g) for k, g in grads.items()})
        for k in grads:
            np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]), rtol=0, atol=1e-6)
