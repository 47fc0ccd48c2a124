"""Kernel K3 (the closest hit with every determinant from one matrix product)
in the port, held against the JAX package and against K1 on the CPU.

On the CPU the port's wrapper runs the plain version
(``mxu_intersect_reference``: the contraction as an explicit float32 sum).
It is held against the JAX kernel in interpret mode, as
tests/test_mxu_intersect.py runs it, and against the port's plain K1 with
that file's bounds: at most 2 prim differences per 2000 rays (grazing edge
ties) and 1e-4 absolute on t, u, v. Against the JAX kernel, whose
contraction XLA evaluates in its own order with FMAs, prim is equal and
t, u, v agree within 1e-5 max(|x|, 1) scaled by the hit's conditioning
k = 1 / (|cos| sin), as for K1 (tests/test_torch_intersect.py). The CUDA
kernel (3xTF32 on the tensor cores) is held against the plain version on
the card, in tests/test_torch_cuda.py and chip_smoke.py.

The JAX kernel carries maxt inside its contraction, so an infinite maxt
meets a zero column as 0 * inf = NaN and every lane misses; the port keeps
maxt out of the contraction. The interpret-mode comparisons therefore use a
finite maxt, as the JAX package's own test does.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mitsuba_tpu as mj
from mitsuba_tpu.ops import intersect_mxu as JM

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.ops import intersect as K1
from mitsuba_tpu_torch.ops import intersect_mxu as K3
from mitsuba_tpu_torch.render.scene_loader import mesh_scene
from mitsuba_tpu_torch.render_api import make_wavefront


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


def _soup(seed=0, T=37, N=2000, maxt_on=1e9):
    """tests/test_mxu_intersect.py's soup: mixed enabled / disabled lanes."""
    rng = np.random.default_rng(seed)
    v0, e1, e2 = (rng.uniform(-1, 1, (T, 3)).astype(np.float32) for _ in range(3))
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = np.where(rng.uniform(size=N) < 0.1, -1.0, maxt_on).astype(np.float32)
    return v0, e1, e2, o, d, maxt


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _conditioning(v0, e1, e2, prim, d):
    e1, e2 = e1[np.maximum(prim, 0)].astype(np.float64), e2[np.maximum(prim, 0)].astype(np.float64)
    n = np.cross(e1, e2)
    area = np.maximum(np.linalg.norm(n, axis=1), 1e-30)
    cos = np.abs((d * n).sum(1)) / area
    sin = area / np.maximum(np.linalg.norm(e1, axis=1) * np.linalg.norm(e2, axis=1), 1e-30)
    return np.maximum(1.0, 1.0 / np.maximum(cos * sin, 1e-30))


def test_build_mxu_cols_matches_jax():
    v0, e1, e2, *_ = _soup()
    T = v0.shape[0]
    got = K3.build_mxu_cols(*_t(v0, e1, e2)).numpy()
    want = np.asarray(JM.build_mxu_cols(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2)))
    tp_got, tp_want = got.shape[1] // 4, want.shape[1] // 4
    assert got.shape[0] == want.shape[0] == K3.K_FEAT and tp_got == 40 and tp_got % K3.N_TILE == 0
    for q in range(4):      # det, u', v', t' groups; the padding columns are zero
        np.testing.assert_allclose(got[:, q * tp_got:q * tp_got + T],
                                   want[:, q * tp_want:q * tp_want + T], rtol=1e-6, atol=1e-6)
        assert not got[:, q * tp_got + T:(q + 1) * tp_got].any()


def test_plain_k3_matches_jax_interpret():
    v0, e1, e2, o, d, maxt = _soup()
    cols = JM.build_mxu_cols(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    jt, jp, ju, jv = (np.asarray(x) for x in JM.mxu_intersect(cols, jnp.asarray(o), jnp.asarray(d),
                                                              jnp.asarray(maxt)))
    tt, tp, tu, tv = (x.numpy() for x in K3.mxu_intersect(K3.build_mxu_cols(*_t(v0, e1, e2)),
                                                          *_t(o, d, maxt)))
    assert tp.dtype == np.int32
    np.testing.assert_array_equal(tp, jp)
    hit = tp >= 0
    assert hit.sum() > 100 and (tp[maxt < 0] == -1).all()
    k = _conditioning(v0, e1, e2, tp, d)[hit]
    for a, b in ((tt, jt), (tu, ju), (tv, jv)):
        err = np.abs(a[hit] - b[hit]) / (np.maximum(np.abs(b[hit]), 1.0) * k)
        assert err.max() <= 1e-5, err.max()
    # an infinite maxt: the JAX kernel's contraction meets 0 * inf and every
    # lane misses; the port's hits are K1's
    inf = np.full_like(maxt, np.inf)
    jp_inf = np.asarray(JM.mxu_intersect(cols, jnp.asarray(o), jnp.asarray(d), jnp.asarray(inf))[1])
    assert (jp_inf == -1).all()
    table = torch.from_numpy(np.concatenate([v0, e1, e2], axis=1))
    tp_inf = K3.mxu_intersect_reference(K3.build_mxu_cols(*_t(v0, e1, e2)), *_t(o, d, inf))[1]
    k1_inf = K1.tri_intersect_reference(table, *_t(o, d, inf))[1]
    assert (tp_inf >= 0).sum() > 100 and (tp_inf != k1_inf).sum() <= 2


def _cbox_rays(n=4096):
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = 16
    scene = mt.load_dict(d, device="cpu")
    geom = scene.geometry.refresh()
    _, ray, _, _, _ = make_wavefront(scene, 3, 0, n, 0, 16, 16)
    maxt = ray.maxt.clone()
    maxt[1::3] = -float("inf")
    maxt[2::3] = 1.5
    table = K1.build_tri_table(geom)[:geom.n_real_tris].contiguous()
    return table, ray.o.contiguous(), ray.d.contiguous(), maxt


@pytest.mark.parametrize("case", ["soup", "cbox"])
def test_plain_k3_matches_plain_k1(case):
    if case == "soup":
        v0, e1, e2, o, d, maxt = _soup(1)
        table, o, d, maxt = _t(np.concatenate([v0, e1, e2], axis=1), o, d, maxt)
    else:
        table, o, d, maxt = _cbox_rays()
    cols = K3.build_mxu_cols(table[:, 0:3], table[:, 3:6], table[:, 6:9])
    got = K3.mxu_intersect(cols, o, d, maxt)
    ref = K1.tri_intersect(table, o, d, maxt)
    diff = (got[1] != ref[1]).sum().item()
    assert diff <= 2 * o.shape[0] / 2000, diff
    m = (got[1] == ref[1]) & (ref[1] >= 0)
    assert m.sum() > 100
    for a, b in ((got[0], ref[0]), (got[2], ref[2]), (got[3], ref[3])):
        assert (a[m] - b[m]).abs().max().item() < 1e-4


def test_plain_k3_ties_take_the_lowest_index():
    table = torch.tensor([[-1.0, -1.0, 0.0, 2.0, 0.0, 0.0, 0.0, 2.0, 0.0]]).repeat(3, 1)
    table[0, 2] = -5.0                                 # behind the ray
    o = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    maxt = torch.tensor([10.0, 1.0])       # the second lane's hit at t=1 is not < maxt
    cols = K3.build_mxu_cols(table[:, 0:3], table[:, 3:6], table[:, 6:9])
    t, p, u, v = K3.mxu_intersect(cols, o, d, maxt)
    assert p.tolist() == [1, -1] and t[0].item() == 1.0 and t[1].item() == float("inf")
    assert u[1].item() == 0.0 and v[1].item() == 0.0


def test_cbox_render_mma_matches_smem():
    """tests/test_mxu_intersect.py's render A/B bounds, and the mma route
    on a PRB gradient."""
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = 16
    d["integrator"] = {"type": "prb", "max_depth": 4}
    out = {}
    for inter in ("smem", "mma"):
        scene = mt.load_dict(d, device="cpu", intersector=inter)
        assert scene.geometry.intersector == inter
        params = mt.traverse(scene)
        v = params["white.reflectance.value"].clone().requires_grad_()
        img = mt.render(params.update({"white.reflectance.value": v}), spp=4, seed=0)
        img.mean().backward()
        out[inter] = img.detach(), v.grad
    np.testing.assert_allclose(out["mma"][0].numpy(), out["smem"][0].numpy(), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(out["mma"][1].numpy(), out["smem"][1].numpy(), rtol=1e-3)


def test_mma_refusals(tmp_path):
    with pytest.raises(ValueError, match="intersector"):
        mt.load_dict(mt.cornell_box(), device="cpu", intersector="wgmma")
    with pytest.raises(ValueError, match="BVH"):
        mt.load_dict(mesh_scene(tmp_path / "s.obj", k=30, res=8), device="cpu", intersector="mma")
    r = np.random.default_rng(0)
    d = mt.cornell_box()
    d["soup"] = {"type": "mesh", "vertex_positions": r.uniform(-0.5, 0.5, (1800, 3)),
                 "faces": np.arange(1800).reshape(600, 3)}
    with pytest.raises(ValueError, match="512"):
        mt.load_dict(d, device="cpu", intersector="mma")
    o, dd, maxt = torch.zeros(8, 3), torch.zeros(8, 3), torch.ones(8)
    cols = K3.build_mxu_cols(torch.zeros(513, 3), torch.zeros(513, 3), torch.zeros(513, 3))
    with pytest.raises(ValueError, match="512"):
        K3.mxu_intersect(cols, o, dd, maxt)
    with pytest.raises(ValueError):
        K3.mxu_intersect(torch.zeros(16, 36), o, dd, maxt)       # Tp not a multiple of 8
    with pytest.raises(TypeError):
        K3.mxu_intersect(torch.zeros(16, 32).double(), o, dd, maxt)
    with pytest.raises(ValueError):
        K3.mxu_intersect(*(x.to("meta") for x in (torch.zeros(16, 32), o, dd, maxt)))
