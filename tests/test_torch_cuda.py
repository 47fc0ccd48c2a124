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
from mitsuba_tpu_torch.ops import intersect as K1
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


def _cbox_batch(device):
    scene = mt.load_dict(_cbox(), device=device)
    _, ray, _ = make_wavefront(scene, 3, 0, scene.film.n_pixels * 4, 0, 4, 4)
    maxt = ray.maxt.clone()
    maxt[1::3] = -float("inf")
    maxt[2::3] = 1.5
    table = K1.build_tri_table(scene.geometry.refresh())
    return [table, ray.o.contiguous(), ray.d.contiguous(), maxt]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cbox", "soup64", "soup200", "soup4096"])
def test_k1_kernel_bitwise_vs_plain(cuda, case):
    if case == "cbox":
        args = _cbox_batch(cuda)
    else:
        args = [x.to(cuda) for x in _soup(int(case[4:]), 1 << 16, 11)]
    before = K1.tri_intersect.launches
    got = K1.tri_intersect(*args)
    assert K1.tri_intersect.launches == before + 1
    ref = K1.tri_intersect_reference(*args)
    torch.cuda.synchronize()
    assert (ref[1] >= 0).any()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cbox_render_runs_through_k1(cuda):
    scene = mt.load_dict(_cbox())
    assert scene.device.type == "cuda"
    before = K1.tri_intersect.launches
    img = mt.render(scene, spp=4, seed=0)
    assert K1.tri_intersect.launches - before == 9
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
    _, ray, _ = make_wavefront(scene, 3, 0, scene.film.n_pixels * 4, 0, 4, 4)
    geom = scene.geometry.refresh()
    return [geom.bvh_nodes, K1.build_tri_table(geom), ray.o.contiguous(), ray.d.contiguous(),
            ray.maxt.contiguous()]


@pytest.mark.gpu
@pytest.mark.parametrize("anyhit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("case", ["soup", "mesh"])
def test_k2_kernel_bitwise_vs_plain(cuda, case, anyhit, tmp_path):
    args = _k2_soup(cuda) if case == "soup" else _k2_mesh(cuda, tmp_path)
    counter = K2.bvh_sweep_occluded if anyhit else K2.bvh_sweep_intersect
    before = counter.launches
    got = K2.bvh_sweep(*args, anyhit=anyhit)
    assert counter.launches == before + 1
    stats = {}
    ref = K2.bvh_sweep_reference(*args, anyhit=anyhit, stats=stats)
    torch.cuda.synchronize()
    assert not stats["hit_max_steps"] and (ref[1] >= 0).any()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_mesh_render_runs_through_k2(cuda, tmp_path):
    d = mesh_scene(tmp_path / "sphere.obj", k=30, res=32)
    scene = mt.load_dict(d)
    assert scene.geometry.has_bvh and scene.geometry.bvh_nodes.device.type == "cuda"
    k1, closest, anyhit = (K1.tri_intersect.launches, K2.bvh_sweep_intersect.launches,
                           K2.bvh_sweep_occluded.launches)
    img = mt.render(scene, spp=4, seed=0)
    assert K1.tri_intersect.launches == k1
    assert K2.bvh_sweep_intersect.launches - closest == 8
    assert K2.bvh_sweep_occluded.launches - anyhit == 8
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    cpu = mt.render(mt.load_dict(d, device="cpu"), spp=4, seed=0)
    # as for the cbox: the card's transcendentals may send a rare path elsewhere
    close = torch.isclose(img.cpu(), cpu, rtol=1e-4, atol=1e-5).all(-1)
    assert close.float().mean().item() >= 0.99
