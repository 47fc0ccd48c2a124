"""The port's CUDA kernels on the card, held against their plain PyTorch
versions. Every test here is marked `gpu` and skips without a CUDA card;
the file imports no JAX, so that it runs where only PyTorch is installed:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch import native
from mitsuba_tpu_torch.ops import bvh_sweep as K2
from mitsuba_tpu_torch.ops import dma_probe as K4
from mitsuba_tpu_torch.ops import intersect as K1
from mitsuba_tpu_torch.ops import intersect_mxu as K3
from mitsuba_tpu_torch.render.scene_loader import mesh_scene
from mitsuba_tpu_torch.render_api import make_wavefront


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cbox(w=32):
    d = mt.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = w
    return d


def _soup(n_tris, n_rays, seed):
    """Triangle table with duplicated rows (ties); a quarter of the lanes
    disabled and a quarter with a finite maxt."""
    r = np.random.default_rng(seed)
    table = np.concatenate(
        [r.uniform(-3, 3, (n_tris, 3)), r.normal(0, 0.8, (n_tris, 6))], axis=1
    ).astype(np.float32)
    dup = r.choice(n_tris, n_tris // 8, replace=False)
    table[dup] = table[r.choice(n_tris, n_tris // 8)]
    o = r.uniform(-6, 6, (n_rays, 3)).astype(np.float32)
    d = r.uniform(-2, 2, (n_rays, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.full(n_rays, np.inf, np.float32)
    maxt[1::4] = -np.inf
    maxt[2::4] = r.uniform(0.5, 8.0, maxt[2::4].shape)
    return [torch.from_numpy(x) for x in (table, o, d, maxt)]


def _cbox_batch(device, share=None):
    """The cbox's camera rays at 32x32 @ 4 spp with the whole padded
    table, a third of the lanes disabled and a third with a finite maxt;
    or, with `share`, at 64x64 @ 4 spp with the route's table (the 36 real
    rows) and a random `share` of the lanes disabled (made with numpy from
    a seed), scattered over the batch as on the later bounces."""
    scene = mt.load_dict(_cbox(32 if share is None else 64), device=device)
    _, ray, _, _, _ = make_wavefront(scene, 3, 0, scene.film.n_pixels * 4, 0, 4, 4)
    geom = scene.geometry.refresh()
    table = K1.build_tri_table(geom)
    maxt = ray.maxt.clone()
    if share is None:
        maxt[1::3] = -float("inf")
        maxt[2::3] = 1.5
    else:
        off = np.random.default_rng(int(100 * share)).random(maxt.shape[0]) < share
        maxt[torch.from_numpy(off).to(maxt.device)] = -float("inf")
        table = table[:geom.n_real_tris]
    return [table, ray.o.contiguous(), ray.d.contiguous(), maxt]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cbox", "cbox50", "cbox90", "soup64", "soup200", "soup4096"])
def test_k1_kernel_bitwise_vs_plain(cuda, case):
    """K1 against its plain version, prim, t, u, v bit for bit; "cbox50"
    and "cbox90" disable a random 50% and 90% of the lanes, which the
    kernel gathers into dense queues before it sweeps."""
    if case == "cbox":
        args = _cbox_batch(cuda)
    elif case.startswith("cbox"):
        args = _cbox_batch(cuda, int(case[4:]) / 100)
    else:
        args = [x.to(cuda) for x in _soup(int(case[4:]), 1 << 16, 11)]
    before = K1.smem_intersect.launches
    got = K1.smem_intersect(*args)
    assert K1.smem_intersect.launches == before + 1
    ref = K1.tri_intersect_reference(*args)
    torch.cuda.synchronize()
    assert (ref[1] >= 0).any()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_k1_real_rows_equal_the_padded_table(cuda):
    """The route's table (the 36 real rows) and the padded 64-row table
    give the same prim, t, u, v, bit for bit."""
    padded, o, d, maxt = _cbox_batch(cuda)
    trimmed = padded[:36]
    assert padded.shape[0] == 64 and not padded[36:, 3:].any()       # e1 = e2 = 0
    got, want = K1.smem_intersect(trimmed, o, d, maxt), K1.smem_intersect(padded, o, d, maxt)
    torch.cuda.synchronize()
    assert (want[1] >= 0).any()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_cbox_render_runs_through_k1(cuda):
    scene = mt.load_dict(_cbox())
    assert scene.device.type == "cuda"
    before = K1.smem_intersect.launches
    img = mt.render(scene, spp=4, seed=0)
    assert K1.smem_intersect.launches - before == 9
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    cpu = mt.render(mt.load_dict(_cbox(), device="cpu"), spp=4, seed=0)
    # the card's and the CPU's sin, cos and log may round differently, which
    # can send a rare path elsewhere: hold 99% of the pixels
    close = torch.isclose(img.cpu(), cpu, rtol=1e-4, atol=1e-5).all(-1)
    assert close.float().mean().item() >= 0.99


def _k2_soup(device):
    """A BVH over 16,384 random triangles with duplicated rows (ties); a
    quarter of the lanes disabled and a quarter with a finite maxt."""
    table, o, d, maxt = _soup(1 << 14, 1 << 16, 12)
    nodes, order = native.build_bvh_wide(table.numpy(), max_leaf=K2.MAX_WIDE_LEAF)
    table = table[torch.from_numpy(order.astype(np.int64))]
    return [x.contiguous().to(device) for x in (torch.from_numpy(nodes), table, o, d, maxt)]


def _k2_mesh(device, tmp_path):
    """The k=30 mesh scene's camera rays at 32x32 @ 4 spp."""
    scene = mt.load_dict(mesh_scene(tmp_path / "sphere.obj", k=30, res=32), device=device)
    _, ray, _, _, _ = make_wavefront(scene, 3, 0, scene.film.n_pixels * 4, 0, 4, 4)
    geom = scene.geometry.refresh()
    return [geom.bvh_nodes, K1.build_tri_table(geom), ray.o.contiguous(), ray.d.contiguous(),
            ray.maxt.contiguous()]


@pytest.mark.gpu
@pytest.mark.parametrize("anyhit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("case", ["soup", "mesh", "mesh90", "special", "sorted"])
def test_k2_kernel_bitwise_vs_plain(cuda, case, anyhit, tmp_path):
    """K2 against its plain walk, prim, t, u, v bit for bit: on a soup, on
    the mesh's camera rays, on them with a random 90% of the lanes disabled
    ("mesh90"), with maxt 0, -1.5, -inf and NaN on four lanes in five
    ("special": a miss returns its maxt bit for bit), and on them gathered
    in the JAX package's coherence order ("sorted")."""
    args = _k2_soup(cuda) if case == "soup" else _k2_mesh(cuda, tmp_path)
    if case == "mesh90":
        off = np.random.default_rng(90).random(args[4].shape[0]) < 0.9
        args[4] = torch.where(torch.from_numpy(off).to(cuda), -float("inf"), args[4])
    elif case == "special":
        for k, x in enumerate((0.0, -1.5, -float("inf"), float("nan"))):
            args[4][k::5] = x
    elif case == "sorted":
        nodes, o, d, maxt = args[0], *args[2:]
        perm = K2.maybe_sort_order(K2.ray_sort_key(o, d, nodes[0, 0:3], nodes[0, 3:6], maxt))
        assert not torch.equal(perm.cpu(), torch.arange(perm.shape[0], dtype=torch.int32))
        args[2:] = [x[perm.long()].contiguous() for x in args[2:]]
    counter = K2.bvh_sweep_occluded if anyhit else K2.bvh_sweep_intersect
    before = counter.launches
    got = K2.bvh_sweep(*args, anyhit=anyhit)
    assert counter.launches == before + 1
    stats = {}
    ref = K2.bvh_sweep_reference(*args, anyhit=anyhit, stats=stats)
    torch.cuda.synchronize()
    assert not stats["hit_max_steps"] and (ref[1] >= 0).any()
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_mesh_render_runs_through_k2(cuda, tmp_path):
    d = mesh_scene(tmp_path / "sphere.obj", k=30, res=32)
    scene = mt.load_dict(d)
    assert scene.geometry.has_bvh and scene.geometry.bvh_nodes.device.type == "cuda"
    k1, closest, anyhit = (K1.smem_intersect.launches, K2.bvh_sweep_intersect.launches,
                           K2.bvh_sweep_occluded.launches)
    img = mt.render(scene, spp=4, seed=0)
    assert K1.smem_intersect.launches == k1
    assert K2.bvh_sweep_intersect.launches - closest == 8
    assert K2.bvh_sweep_occluded.launches - anyhit == 8
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    cpu = mt.render(mt.load_dict(d, device="cpu"), spp=4, seed=0)
    # as for the cbox: the card's transcendentals may send a rare path elsewhere
    close = torch.isclose(img.cpu(), cpu, rtol=1e-4, atol=1e-5).all(-1)
    assert close.float().mean().item() >= 0.99


# ---------------------------------------------------------------------------
# K3: the closest hit with every determinant from the tensor cores
# ---------------------------------------------------------------------------

def _conditioning(table, prim, d):
    """k = max(1, 1 / (|cos| sin)) of each lane's hit triangle."""
    rows = table[torch.clamp(prim, min=0).to(torch.int64)].double()
    e1, e2 = rows[:, 3:6], rows[:, 6:9]
    n = torch.linalg.cross(e1, e2)
    area2 = n.norm(dim=1).clamp(min=1e-30)
    sin = area2 / (e1.norm(dim=1) * e2.norm(dim=1)).clamp(min=1e-30)
    return torch.clamp(1.0 / ((d.double() * n).sum(1).abs() / area2 * sin).clamp(min=1e-30), min=1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cbox", "cbox50", "cbox90", "soup8", "soup512"])
def test_k3_kernel_vs_plain_and_k1(cuda, case):
    """K3 (3xTF32 contraction) against its plain version: prim equal but on
    at most 1 lane in 1e5, t/u/v within 1e-5 max(|x|, 1) scaled by the
    hit's conditioning; against K1: at most 2 prim differences per 2000
    rays and 1e-4 (scaled likewise on the soups, which have slivers). The
    cbox (Tp 40) also with a random 50% and 90% of its lanes disabled; the
    soups at Tp 8 and 512, the edges of the column tiling."""
    if case == "cbox":
        table, o, d, maxt = _cbox_batch(cuda)
        table = table[:36].contiguous()
    elif case.startswith("cbox"):
        table, o, d, maxt = _cbox_batch(cuda, int(case[4:]) / 100)
    else:
        table, o, d, maxt = [x.to(cuda) for x in _soup(int(case[4:]), 1 << 16, 13)]
    cols = K3.build_mxu_cols(table[:, 0:3], table[:, 3:6], table[:, 6:9])
    before = K3.mxu_intersect.launches
    got = K3.mxu_intersect(cols, o, d, maxt)
    assert K3.mxu_intersect.launches == before + 1
    ref = K3.mxu_intersect_reference(cols, o, d, maxt)
    k1 = K1.smem_intersect(table, o, d, maxt)
    torch.cuda.synchronize()
    assert (got[1][~(maxt > 0)] == -1).all() and (ref[1] >= 0).any()
    n = o.shape[0]
    for other, rate, tol in ((ref, 1e-5, 1e-5), (k1, 2 / 2000, 1e-4)):
        assert int((got[1] != other[1]).sum()) <= max(rate * n, 1)
        m = (got[1] == other[1]) & (other[1] >= 0)
        k = _conditioning(table, other[1], d)[m]
        scaled = case.startswith("soup") or other is ref
        for a, b in ((got[0], other[0]), (got[2], other[2]), (got[3], other[3])):
            scale = k * torch.clamp(b[m].abs().double(), min=1.0) if scaled else 1.0
            assert float(((a[m] - b[m]).abs() / scale).max()) <= tol


@pytest.mark.gpu
def test_k3_refusals(cuda, tmp_path):
    o, d, maxt = torch.zeros(8, 3, device=cuda), torch.zeros(8, 3, device=cuda), torch.ones(8, device=cuda)
    z = torch.zeros(513, 3, device=cuda)
    with pytest.raises(ValueError, match="512"):
        K3.mxu_intersect(K3.build_mxu_cols(z, z, z), o, d, maxt)
    with pytest.raises(ValueError, match="BVH"):
        mt.load_dict(mesh_scene(tmp_path / "s.obj", k=30, res=8), intersector="mma")


@pytest.mark.gpu
def test_prb_render_runs_through_k1_and_k3(cuda):
    """One PRB gradient step at max_depth 8 through each intersector: 34
    launches of its kernel (9 forward, 9 for the backward's primal, 8 + 8
    in the replay), none of the other's; the two gradients agree."""
    d = _cbox()
    d["integrator"] = {"type": "prb", "max_depth": 8}
    grads = {}
    for inter, kernel in (("smem", K1.smem_intersect), ("mma", K3.mxu_intersect)):
        other = K3.mxu_intersect if inter == "smem" else K1.smem_intersect
        scene = mt.load_dict(d, intersector=inter)
        params = mt.traverse(scene)
        v = params["white.reflectance.value"].clone().requires_grad_()
        before, other_before = kernel.launches, other.launches
        mt.render(params.update({"white.reflectance.value": v}), spp=4, seed=0).mean().backward()
        assert kernel.launches - before == 34 and other.launches == other_before
        grads[inter] = v.grad
    torch.testing.assert_close(grads["mma"], grads["smem"], rtol=1e-3, atol=0)


# ---------------------------------------------------------------------------
# the autograd wrappers' backward on the card
# ---------------------------------------------------------------------------

def _backward(fn, args, device, seed=3):
    """(outputs, cotangents of table, o, d) of fn on `args` moved to
    `device`, for fixed random output cotangents."""
    table, o, d, maxt = (x.to(device) for x in args[-4:])
    rest = [x.to(device) for x in args[:-4]]
    table, o, d = (x.clone().requires_grad_() for x in (table, o, d))
    t, p, u, v = fn(*rest, table, o, d, maxt)
    g = torch.from_numpy(np.random.default_rng(seed).normal(size=(3, o.shape[0])).astype(np.float32))
    cts = torch.autograd.grad((t, u, v), (table, o, d), [x.to(device) for x in g])
    return [x.detach().cpu() for x in (t, p, u, v)], [x.cpu() for x in cts]


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["smem", "mma", "bvh"])
def test_autograd_backward_on_the_card_equals_the_cpu(cuda, route):
    """The backward on CUDA tensors equals the CPU's: o and d per lane at
    rtol 1e-5, the table rows (added with index_add_, atomics on the card,
    in another order) at 1e-5 of their largest magnitude. K3's forward on
    the card (3xTF32) differs from its plain version within its bound, so
    its lanes are compared where the hit is well conditioned (k <= 10), at
    rtol 1e-4."""
    if route == "bvh":
        args = [x.cpu() for x in _k2_soup("cpu")]
        fn = K2.bvh_sweep_intersect
    else:
        args = _soup(256 if route == "mma" else 1024, 1 << 14, 21)
        fn = lambda table, o, d, maxt: K1.tri_intersect(table, o, d, maxt, route)
    out_c, ct_c = _backward(fn, args, cuda)
    out_h, ct_h = _backward(fn, args, "cpu")
    if route != "mma":
        assert all(torch.equal(a, b) for a, b in zip(out_c, out_h))
    same = out_c[1] == out_h[1]
    assert same.float().mean() > 0.999 and (out_h[1] >= 0).any()
    rtol = 1e-5
    if route == "mma":
        table, d = args[0], args[2]
        same &= _conditioning(table, out_h[1], d) <= 10
        rtol = 1e-4
    for a, b in zip(ct_c[1:], ct_h[1:]):
        torch.testing.assert_close(a[same], b[same], rtol=rtol, atol=1e-6)
    if route != "mma":
        torch.testing.assert_close(ct_c[0], ct_h[0], rtol=0, atol=1e-5 * float(ct_h[0].abs().max()))


# ---------------------------------------------------------------------------
# K4: the device-memory copy probe
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_k4_sink_equals_plain(cuda):
    x = K4.probe_array(cuda, seed=2, total_rows=1 << 16)
    for rows, ring, n_copies in ((8, 2, 5000), (64, 3, 3000), (128, 2, 777)):
        before = K4.copy_probe.launches
        got = K4.copy_probe(x, rows, ring, n_copies)
        assert K4.copy_probe.launches == before + 1
        assert int(got) == int(K4.copy_probe_reference(x, rows, n_copies))


@pytest.mark.gpu
@pytest.mark.parametrize("regenerate", [False, True], ids=["wavefront", "regenerate"])
def test_volpath_render_runs_through_k1(cuda, regenerate, monkeypatch):
    """The 32x32 @ 4 spp heterogeneous-grid volpath render (BASELINE config
    3's scene) goes through K1 on every closest hit and equals, bit for bit,
    the same render through K1's plain version."""
    from mitsuba_tpu_torch.render.scene_loader import het_vol_scene

    scene = mt.load_dict(het_vol_scene(res=32, spp=4, regenerate=regenerate))
    before = K1.smem_intersect.launches
    img = mt.render(scene, spp=4, seed=0)
    assert K1.smem_intersect.launches > before
    assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    monkeypatch.setattr(K1, "smem_intersect", K1.tri_intersect_reference)
    plain = mt.render(scene, spp=4, seed=0)
    assert torch.equal(img, plain)


# ---------------------------------------------------------------------------
# the polarized atmosphere (BASELINE config 4)
# ---------------------------------------------------------------------------

@pytest.fixture
def mono_polarized():
    mt.set_variant("mono_polarized")
    yield
    mt.set_variant("rgb")


@pytest.mark.gpu
def test_mie_bake_on_the_card_equals_the_cpu(cuda, mono_polarized):
    """Config 4's Mie phase baked on the card against the same bake on the
    CPU (complex64 on both): M11, M12, M33 and M34 within rtol 1e-4 and
    1e-6 of max|M11|, the tolerance of the CPU tests against the JAX
    package's bake."""
    from mitsuba_tpu_torch.render.media import parse_phase

    spec = mt.atmo_scene()["atmo"]["phase"]["aerosol"]
    card = parse_phase(spec, [], "aerosol", ("p",), cuda)
    host = parse_phase(spec, [], "aerosol", ("p",), "cpu")
    assert card.m11.device.type == "cuda"
    scale = float(host.m11.abs().max())
    for k in ("nodes", "m11", "m12", "m33", "m34"):
        torch.testing.assert_close(getattr(card, k).cpu(), getattr(host, k), rtol=1e-4,
                                   atol=1e-6 * scale)


@pytest.mark.gpu
def test_atmo_render_1_on_the_card_equals_the_cpu(cuda, mono_polarized):
    """Config 4's render_1 at 8x8 @ 16 spp on the card (every closest hit
    through K1) against the same render on the CPU: the same samples, so I
    within rtol 1e-3 and Q/U/V within 1e-3 I."""
    d = mt.atmo_scene(res=8, spp=16)
    before = K1.smem_intersect.launches
    got = mt.render_1(mt.load_dict(d), spp=16, seed=0)
    assert K1.smem_intersect.launches > before
    ref = mt.render_1(mt.load_dict(d, device="cpu"), spp=16, seed=0)
    assert got.shape == (4, 1) and bool(torch.isfinite(got).all())
    I = float(ref[0, 0])
    assert float(got[0, 0]) == pytest.approx(I, rel=1e-3)
    torch.testing.assert_close(got[1:].cpu(), ref[1:], rtol=0.0, atol=1e-3 * I)


# ---------------------------------------------------------------------------
# inverse radiative transfer: the volumetric PRB replays (BASELINE config 5)
# ---------------------------------------------------------------------------

def _prb_grads(scene, keys, loss):
    """(loss, {key: gradient}, K1 launches of the forward, of the
    backward)."""
    def count():
        # the plain version that stands in for K1 counts nothing
        return getattr(K1.smem_intersect, "launches", 0)

    params = mt.traverse(scene)
    leaves = {k: params[k].clone().requires_grad_() for k in keys}
    l0 = count()
    out = loss(params.update(leaves))
    l1 = count()
    out.backward()
    return out.detach(), {k: v.grad for k, v in leaves.items()}, (l1 - l0, count() - l1)


def _prb_case(name):
    """(variant, scene dict, keys, loss, grid key) of a small step of each
    volumetric PRB integrator: config 5's ocean (prb_volpathaos), the
    polarized atmosphere (prb, routed to prb_polarized) and the het-vol grid
    (prbvolpath)."""
    from mitsuba_tpu_torch.render.scene_loader import aos_scene, het_vol_scene

    if name == "prb_volpathaos":
        return ("mono_polarized", aos_scene(res=8), ["atmo_medium.sigma_t.value.value",
                                                    "sea_floor.bsdf.reflectance.value"],
                lambda s: mt.render_1(s, spp=16, seed=0).sum(), None)
    if name == "prb_polarized":
        d = mt.atmo_scene(res=8, spp=16)
        d["integrator"]["type"] = "prb"
        return ("mono_polarized", d, ["atmo.sigma_t.value.value", "atmo.albedo.value.value"],
                lambda s: mt.render_1(s, spp=16, seed=0).sum(), None)
    d = het_vol_scene(res=16, spp=4)
    d["integrator"]["type"] = "prbvolpath"
    grid = "cloud.interior_medium.sigma_t.data"
    return ("rgb", d, [grid, "cloud.interior_medium.albedo.value"],
            lambda s: mt.render(s, spp=4, seed=0).mean(), grid)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["prb_volpathaos", "prb_polarized", "prbvolpath"])
def test_volume_prb_gradient_through_k1_equals_plain(cuda, name, monkeypatch):
    """Each volumetric PRB integrator's step on the card goes through K1
    (in its forward and in its backward) and equals the same step through
    K1's plain version: the loss and the scalar-parameter gradients bit
    for bit, a grid's gradient (accumulated with atomics, in no fixed
    order) within 1e-5 of its L2 norm."""
    variant, d, keys, loss, grid = _prb_case(name)
    mt.set_variant(variant)
    try:
        scene = mt.load_dict(d)
        assert scene.integrator.is_prb
        out_k, g_k, launches = _prb_grads(scene, keys, loss)
        assert min(launches) > 0, launches
        monkeypatch.setattr(K1, "smem_intersect", K1.tri_intersect_reference)
        out_p, g_p, _ = _prb_grads(scene, keys, loss)
    finally:
        mt.set_variant("rgb")
    assert bool(torch.isfinite(out_k)) and torch.equal(out_k, out_p)
    for k in keys:
        assert bool(torch.isfinite(g_k[k]).all()) and bool((g_k[k] != 0).any()), k
        if k == grid:
            assert float((g_k[k] - g_p[k]).norm()) <= 1e-5 * float(g_p[k].norm()), k
        else:
            assert torch.equal(g_k[k], g_p[k]), k


# ---------------------------------------------------------------------------
# regenerative inverse rendering: the regenerative PRB replays
# ---------------------------------------------------------------------------

def _regen_prb_case(name):
    """(variant, scene dict, keys, spp) of a 16x16 regenerative PRB step:
    the Cornell box (prb), bench.py's deep volume (prbvolpath), config 4's
    polarized atmosphere (prb, routed to prb_polarized) and config 5's
    ocean (prb_volpathaos), each rendered as an image."""
    from mitsuba_tpu_torch.render.scene_loader import aos_scene, vol32_scene

    if name == "prb":
        d = _cbox(16)
        d["integrator"] = {"type": "prb", "max_depth": 8, "regenerate": True}
        return "rgb", d, ["white.reflectance.value"], 16
    if name == "prbvolpath":
        d = vol32_scene(res=16, spp=16, max_depth=8, regenerate=True)
        d["integrator"]["type"] = "prbvolpath"
        return "rgb", d, ["slab.interior_medium.sigma_t.value.value",
                          "slab.interior_medium.albedo.value.value"], 16
    if name == "prb_polarized":
        d = mt.atmo_scene(res=16, spp=16)
        d["integrator"].update(type="prb", regenerate=True)
        return "mono_polarized", d, ["atmo.albedo.value.value"], 16
    d = aos_scene(res=16)
    d["integrator"]["regenerate"] = True
    return "mono_polarized", d, ["atmo_medium.sigma_t.value.value"], 16


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["prb", "prbvolpath", "prb_polarized", "prb_volpathaos"])
def test_regen_prb_gradient_through_k1_equals_plain(cuda, name, monkeypatch):
    """Each PRB integrator with ``regenerate`` at 16x16 on the card goes
    through K1 in its forward and its backward (the backward primal and the
    replay) and equals the same step through K1's plain version: the loss
    and the gradients bit for bit."""
    variant, d, keys, spp = _regen_prb_case(name)
    mt.set_variant(variant)
    try:
        scene = mt.load_dict(d)
        assert scene.integrator.is_prb and scene.integrator.regenerate

        def loss(s):
            return mt.render(s, spp=spp, seed=0).mean()

        out_k, g_k, launches = _prb_grads(scene, keys, loss)
        assert min(launches) > 0, launches
        monkeypatch.setattr(K1, "smem_intersect", K1.tri_intersect_reference)
        out_p, g_p, _ = _prb_grads(scene, keys, loss)
    finally:
        mt.set_variant("rgb")
    assert bool(torch.isfinite(out_k)) and torch.equal(out_k, out_p)
    for k in keys:
        assert bool(torch.isfinite(g_k[k]).all()) and bool((g_k[k] != 0).any()), k
        assert torch.equal(g_k[k], g_p[k]), k


# ---------------------------------------------------------------------------
# surface materials and polarization optics
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("scene,variant", [("materials", "rgb"),
                                           ("polarimeter", "rgb_polarized")])
def test_materials_render_through_k1_equals_plain(cuda, scene, variant, monkeypatch):
    """The materials scene (path) and the polarimeter scene (stokes over
    volpath, Stokes image [32, 32, 4, 3]) at 32x32 @ 4 spp go through K1 on
    every closest hit and equal, bit for bit, the same renders through K1's
    plain version."""
    mt.set_variant(variant)
    try:
        make = mt.materials_scene if scene == "materials" else mt.polarimeter_scene
        s = mt.load_dict(make(32, 4))
        before = K1.smem_intersect.launches
        img = mt.render(s, spp=4, seed=0)
        assert K1.smem_intersect.launches > before
        monkeypatch.setattr(K1, "smem_intersect", K1.tri_intersect_reference)
        plain = mt.render(s, spp=4, seed=0)
    finally:
        mt.set_variant("rgb")
    shape = (32, 32, 3) if scene == "materials" else (32, 32, 4, 3)
    assert img.shape == shape and bool(torch.isfinite(img).all())
    assert float(img[..., 0, :].mean() if img.ndim == 4 else img.mean()) > 0
    assert torch.equal(img, plain)


@pytest.mark.gpu
def test_materials_prb_gradient_through_k1_equals_plain(cuda, monkeypatch):
    """A reduced materials-prb step (16x16 @ 4 spp, max_depth 8): the image
    mean's gradients for the rough conductor's alpha and the blend's
    weight through K1 (forward and backward) equal those of the same step
    through K1's plain version, bit for bit (the bound is 1e-6 relative:
    the same kernels on the same inputs, so any difference would be a
    fault)."""
    d = mt.materials_scene(16, 4, {"type": "prb", "max_depth": 8})
    keys = ["large-box.bsdf.alpha", "floor.bsdf.weight.value"]
    scene = mt.load_dict(d)

    def loss(s):
        return mt.render(s, spp=4, seed=0).mean()

    out_k, g_k, launches = _prb_grads(scene, keys, loss)
    assert min(launches) > 0, launches
    monkeypatch.setattr(K1, "smem_intersect", K1.tri_intersect_reference)
    out_p, g_p, _ = _prb_grads(scene, keys, loss)
    assert bool(torch.isfinite(out_k)) and torch.equal(out_k, out_p)
    for k in keys:
        assert bool(torch.isfinite(g_k[k]).all()) and bool((g_k[k] != 0).all()), k
        assert float((g_k[k] - g_p[k]).abs().max()) <= 1e-6 * float(g_p[k].abs().max()), k


# ---------------------------------------------------------------------------
# the spectral variants
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_spectral_cbox_through_k1_equals_plain_and_repeats(cuda, monkeypatch):
    """The spectral cbox (path, 32x32 @ 4 spp, sRGB image [32, 32, 3]) goes
    through K1 on every closest hit, equals bit for bit the same render
    through K1's plain version, and two renders in one process are bitwise
    equal."""
    mt.set_variant("spectral")
    try:
        s = mt.load_dict(_cbox())
        before = K1.smem_intersect.launches
        img = mt.render(s, spp=4, seed=0)
        assert K1.smem_intersect.launches > before
        again = mt.render(s, spp=4, seed=0)
        monkeypatch.setattr(K1, "smem_intersect", K1.tri_intersect_reference)
        plain = mt.render(s, spp=4, seed=0)
    finally:
        mt.set_variant("rgb")
    assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    assert torch.equal(img, again) and torch.equal(img, plain)


@pytest.mark.gpu
def test_spectral_prb_gradient_through_k1_equals_plain(cuda, monkeypatch):
    """A reduced spectral cbox-prb step (16x16 @ 4 spp, max_depth 8): the
    image mean's gradient for white.reflectance.value, through the XYZ ->
    sRGB measurement inside the PRB node, through K1 equals that of the
    same step through K1's plain version bit for bit, and two steps in one
    process are bitwise equal."""
    mt.set_variant("spectral")
    try:
        d = _cbox(16)
        d["integrator"] = {"type": "prb", "max_depth": 8}
        scene = mt.load_dict(d)
        keys = ["white.reflectance.value"]

        def loss(s):
            return mt.render(s, spp=4, seed=0).mean()

        out_k, g_k, launches = _prb_grads(scene, keys, loss)
        assert min(launches) > 0, launches
        out_2, g_2, _ = _prb_grads(scene, keys, loss)
        monkeypatch.setattr(K1, "smem_intersect", K1.tri_intersect_reference)
        out_p, g_p, _ = _prb_grads(scene, keys, loss)
    finally:
        mt.set_variant("rgb")
    g = g_k[keys[0]]
    assert bool(torch.isfinite(g).all()) and bool((g != 0).all())
    assert torch.equal(out_k, out_2) and torch.equal(g, g_2[keys[0]])
    assert torch.equal(out_k, out_p) and torch.equal(g, g_p[keys[0]])


@pytest.mark.gpu
def test_spectral_atmo_render_1_through_k1_equals_plain(cuda, monkeypatch):
    """BASELINE config 4 in spectral_polarized at a 16x16 film @ 16 spp:
    render_1's raw Stokes [4, 4] (the radiancemeter's 550 nm on all four
    channels) goes through K1, equals the plain route's bit for bit, two
    calls in one process are bitwise equal, and it is within 1e-5 of I of
    the same render on the CPU."""
    mt.set_variant("spectral_polarized")
    try:
        d = mt.atmo_scene(res=16, spp=16)
        s = mt.load_dict(d)
        before = K1.smem_intersect.launches
        st = mt.render_1(s, spp=16, seed=0)
        assert K1.smem_intersect.launches > before
        again = mt.render_1(s, spp=16, seed=0)
        cpu = mt.render_1(mt.load_dict(d, device="cpu"), spp=16, seed=0)
        monkeypatch.setattr(K1, "smem_intersect", K1.tri_intersect_reference)
        plain = mt.render_1(s, spp=16, seed=0)
    finally:
        mt.set_variant("rgb")
    assert st.shape == (4, 4) and bool(torch.isfinite(st).all()) and float(st[0, 0]) > 0
    assert torch.equal(st, again) and torch.equal(st, plain)
    assert bool((st == st[:, :1]).all())
    assert float((st.cpu() - cpu).abs().max()) <= 1e-5 * float(cpu[0, 0])
