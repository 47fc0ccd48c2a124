"""Smoke test of mitsuba_tpu_torch on one CUDA card.

Builds every hand-written kernel of the port from the sources in this
checkout (all nvcc and g++ builds started together), holds each against
its plain PyTorch version on the card, drives the two main paths through
the user entry points, and checks that each went through its kernels:

- the Cornell box, 256x256 @ 64 spp, path tracer, max_depth 8: kernel K1
  (closest hit over a triangle table);
- the large-mesh scene (the Cornell box holding a 202,800-triangle sphere,
  256x256 @ 16 spp): kernel K2, closest hit and any hit over a BVH.

Any failure raises and exits non-zero.

    python3 chip_smoke.py

Prints, before the last line, the card's name and power limit and one JSON
line {"kernels": [...]} with each kernel's launches on its main path, its
error against the plain version, its time, the plain version's time and
its lower bound on this card. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# Per-channel means of the JAX package's image of the same configuration
# (mi.cornell_box() at 256x256, spp=64, seed=0; spp_per_pass=4, which the
# JAX package's RNG keying makes equal to one pass), computed once with
# mitsuba_tpu on the CPU.
JAX_CBOX_MEANS = (0.2402133047580719, 0.14114509522914886, 0.059986136853694916)
# Per-channel means of the JAX package's image of the mesh scene
# (scripts/bench_mesh.py:mesh_scene, the OBJ written as there) at 64x64,
# spp=16, seed=0, one pass, computed once with mitsuba_tpu on the CPU:
# mi.render(mi.load_dict(d), spp=16, seed=0).mean(axis=(0, 1)) with d that
# scene's dict at res=64 (98 s). The full 256x256 render is too slow for
# XLA's while-loop traversal on the CPU.
JAX_MESH64_MEANS = (0.22338911890983582, 0.13317768275737762, 0.057030607014894485)
MEAN_RTOL = 0.03
# the 64x64 @ 16 spp render draws the same samples as the JAX image above
MESH64_MEAN_RTOL = 0.005

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit):
# fp32 outside the tensor cores, and HBM3 bandwidth. The fp32 peak counts
# an FMA as 2 operations; K1 and K2 are built with -fmad=false, so each of
# their adds and products is an instruction of its own and the rate they
# can reach is half of it. The bounds use the published peak; the logs
# also print the bound at the unfused rate.
PEAK_FP32_FLOPS = 67e12
PEAK_FP32_UNFUSED = PEAK_FP32_FLOPS / 2
PEAK_BYTES_PER_S = 3.35e12
# fp32 arithmetic per (ray, triangle) of the Moller-Trumbore test, counted
# from the kernel: 2 cross products (18), 4 dot products (20), the 3
# subtractions of tvec, the 3 scalings by 1/det, the reciprocal and u + v.
# The 6 compares are not counted.
K1_FLOPS_PER_PAIR = 46

MESH_RES, MESH_SPP, MESH_K = 256, 16, 130


def log(*args):
    print(*args, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else f"nvidia-smi failed: {out.stderr.strip()}"


def time_cuda(fn, reps, warmup=2):
    """Milliseconds per call, CUDA events around `reps` calls after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ulp_diff(a, b):
    """Largest distance in units in the last place between two float32
    tensors, over the lanes where both are finite (inf must match inf)."""
    if not torch.equal(torch.isinf(a), torch.isinf(b)):
        return float("inf")
    fin = torch.isfinite(a)
    ia = a[fin].view(torch.int32).to(torch.int64)
    ib = b[fin].view(torch.int32).to(torch.int64)
    # map the sign-magnitude float order onto the integers
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max().item()) if ia.numel() else 0


def build_all(cuda_build, native, K1, K2):
    """Every nvcc build and the g++ build of the host code, started
    together; prints each log. K2 must not spill."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        jobs = {
            "tri_intersect": pool.submit(cuda_build.build, "tri_intersect", K1.BUILD_FLAGS),
            "bvh_sweep": pool.submit(cuda_build.build, "bvh_sweep", K2.BUILD_FLAGS),
            "mtpu_native (g++)": pool.submit(cuda_build.build_host, "mtpu_native", native.SOURCES),
        }
        builds = {name: job.result() for name, job in jobs.items()}
    log(f"== build: {time.perf_counter() - t0:.2f} s wall, all started together")
    for name, b in builds.items():
        log(f"  {name}: {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if line.strip():
                log(f"    {line.strip()}")
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", builds["bvh_sweep"].log)]
    if not spills or max(spills) > 0:
        raise AssertionError(f"bvh_sweep: spills in the -Xptxas -v report {spills}")
    log("  bvh_sweep: no spills (both template instances)")


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def compare_k1(name, K1, table, o, d, maxt):
    """K1 against its plain version on the same inputs: prim bitwise, and
    t, u, v bitwise or within 2 ulp. Returns (worst ulp, max abs error)."""
    got = K1.tri_intersect(table, o, d, maxt)
    ref = K1.tri_intersect_reference(table, o, d, maxt)
    torch.cuda.synchronize()
    if not torch.equal(got[1], ref[1]):
        bad = (got[1] != ref[1]).nonzero()[:5, 0].tolist()
        raise AssertionError(f"K1 {name}: prim differs from the plain version at lanes {bad}")
    worst = max(ulp_diff(g, r) for g, r in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])))
    hit = ref[1] >= 0
    err = max(float((g[hit] - r[hit]).abs().max().item()) if hit.any() else 0.0
              for g, r in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])))
    log(f"K1 {name}: {o.shape[0]} rays x {table.shape[0]} triangles, "
        f"{int(hit.sum())} hits; prim bitwise; t/u/v worst {worst} ulp, max abs err {err}")
    if worst > 2:
        raise AssertionError(f"K1 {name}: t/u/v differ from the plain version by {worst} ulp (> 2)")
    return worst, err


def k1_bound_ms(table, maxt):
    """Least time for one K1 call on these inputs: each byte the function
    needs read once and each output byte written once, against the fp32
    operations that the active lanes need on the real (non-degenerate)
    triangles. Every lane needs its maxt and writes t, prim, u, v; only an
    active lane (maxt > 0) needs its o and d."""
    n = maxt.shape[0]
    n_active = int((maxt > 0).sum())
    nbytes = table.numel() * 4 + n * (1 + 4) * 4 + n_active * 6 * 4
    e1, e2 = table[:, 3:6], table[:, 6:9]
    n_real = int((torch.linalg.cross(e1, e2).abs().sum(-1) > 0).sum())
    flops = n_active * n_real * K1_FLOPS_PER_PAIR
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes"), n_active, n_real


def random_soup(n_tris, n_rays, seed, device):
    """Triangle soup with duplicated rows (ties), half the lanes disabled."""
    r = np.random.default_rng(seed)
    v0 = r.uniform(-3, 3, (n_tris, 3))
    e1 = r.normal(0, 0.6, (n_tris, 3))
    e2 = r.normal(0, 0.6, (n_tris, 3))
    table = np.concatenate([v0, e1, e2], axis=1).astype(np.float32)
    dup = r.choice(n_tris, n_tris // 8, replace=False)
    table[dup] = table[r.choice(n_tris, n_tris // 8)]
    o = r.uniform(-6, 6, (n_rays, 3)).astype(np.float32)
    d = r.uniform(-2, 2, (n_rays, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.full(n_rays, np.inf, np.float32)
    maxt[1::2] = -np.inf
    maxt[2::4] = r.uniform(1.0, 10.0, maxt[2::4].shape)
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (table, o, d, maxt)]


def phase_k1(mi, K1, make_wavefront):
    """K1 against its plain version, timed, on the cbox's bounce-0 batch
    and a random soup."""
    scene = mi.load_dict(mi.cornell_box())
    spp = 64
    n = scene.film.n_pixels * spp
    table = K1.build_tri_table(scene.geometry.refresh())
    _, ray, _ = make_wavefront(scene, 0, 0, n, 0, spp, spp)
    # bounce 0's fused launch: the camera rays, then the N pending shadow
    # slots, all disabled on the first bounce
    o = torch.cat([ray.o, ray.o]).contiguous()
    d = torch.cat([ray.d, ray.d]).contiguous()
    maxt = torch.cat([ray.maxt, torch.full_like(ray.maxt, -float("inf"))]).contiguous()
    worst_a, err_a = compare_k1("cbox bounce-0 batch", K1, table, o, d, maxt)
    worst_b, err_b = compare_k1("random soup", K1, *random_soup(4096, 1 << 20, 7, o.device))
    k1_ms = time_cuda(lambda: K1.tri_intersect(table, o, d, maxt), reps=50)
    plain_ms = time_cuda(lambda: K1.tri_intersect_reference(table, o, d, maxt), reps=3, warmup=1)
    maxt_all = torch.full_like(maxt, float("inf"))
    k1_all_ms = time_cuda(lambda: K1.tri_intersect(table, o, d, maxt_all), reps=50)
    bound_ms, bound_by, n_active, n_real = k1_bound_ms(table, maxt)
    bound_all_ms, _, _, _ = k1_bound_ms(table, maxt_all)
    log(f"K1 timing, cbox bounce-0 batch ({o.shape[0]} rays, {n_active} active, "
        f"{table.shape[0]} rows, {n_real} real): kernel {k1_ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}); all lanes active: kernel {k1_all_ms:.4f} ms, "
        f"bound {bound_all_ms:.4f} ms")
    return scene, {
        "name": "tri_intersect",
        "route": "cuda",
        "source": "mitsuba_tpu_torch/csrc/tri_intersect.cu",
        "replaces": "mitsuba_tpu/ops/intersect.py:33",
        "max_abs_err": max(err_a, err_b),
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "bitwise_vs_plain": max(worst_a, worst_b) == 0,
    }


def reset_launches(K1, K2):
    K1.tri_intersect.launches = 0
    K2.bvh_sweep_intersect.launches = 0
    K2.bvh_sweep_occluded.launches = 0


def phase_cbox_main(mi, K1, K2, scene, shapes_mod):
    """The cbox main path at 256x256 @ 64 spp, then the 64x64 render through
    K1 against the same render through the plain version."""
    film = scene.film
    spp = 64
    mi.render(scene, spp=1, seed=1)                       # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(K1, K2)
    stats = {}
    t0 = time.perf_counter()
    img = mi.render(scene, spp=spp, seed=0, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K1.tri_intersect.launches
    k2_launches = K2.bvh_sweep_intersect.launches + K2.bvh_sweep_occluded.launches
    peak = torch.cuda.max_memory_allocated()
    means = img.mean(dim=(0, 1)).tolist()
    log(f"== main path: cbox {film.width}x{film.height} @ {spp} spp: {wall:.3f} s wall, "
        f"{stats['n_rays']} rays, {stats['n_rays'] / wall / 1e6:.2f} Mrays/s, "
        f"peak memory {peak / 2**30:.2f} GiB, K1 launches {launches}, K2 launches {k2_launches}, "
        f"means {means}")
    if tuple(img.shape) != (film.height, film.width, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"main path: image of shape {tuple(img.shape)} is not finite")
    n_passes = 1        # render() takes all spp in one pass unless spp_per_pass is given
    if launches != 9 * n_passes or k2_launches != 0:
        raise AssertionError(f"cbox main path: K1 launched {launches} times (expected 9 per "
                             f"pass), K2 {k2_launches} times (expected 0)")
    rel = [abs(m - r) / r for m, r in zip(means, JAX_CBOX_MEANS)]
    if max(rel) > MEAN_RTOL:
        raise AssertionError(f"main path: channel means {means} vs JAX {JAX_CBOX_MEANS}: {rel}")
    log(f"  channel means within {max(rel):.4%} of the JAX package's")

    d64 = mi.cornell_box()
    d64["sensor"]["film"]["width"] = d64["sensor"]["film"]["height"] = 64
    scene64 = mi.load_dict(d64)
    img_k = mi.render(scene64, spp=4, seed=0)
    shapes_mod.tri_intersect = K1.tri_intersect_reference   # this phase only
    try:
        img_p = mi.render(scene64, spp=4, seed=0)
    finally:
        shapes_mod.tri_intersect = K1.tri_intersect
    compare_images("cbox", img_k, img_p)
    return launches


def compare_images(name, img_k, img_p):
    """The render through the kernels against the render through the plain
    versions: bitwise, or else 99.9% of the pixels at rtol 1e-5."""
    if torch.equal(img_k, img_p):
        log(f"== {name} kernel vs plain render, 64x64: bitwise equal")
        return
    eq = torch.isclose(img_k, img_p, rtol=1e-5, atol=0).all(-1).float().mean().item()
    log(f"== {name} kernel vs plain render, 64x64: {eq:.5%} of pixels equal at rtol 1e-5")
    if eq < 0.999:
        raise AssertionError(f"{name} 64x64 render: kernel and plain images differ beyond 0.1% of pixels")


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def run_k2_plain(K2, nodes, table, o, d, maxt, anyhit):
    """The plain walk on a batch, with CUDA events around it: (outputs,
    its counts, ms). It must never reach max_steps."""
    stats = {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    ref = K2.bvh_sweep_reference(nodes, table, o, d, maxt, anyhit=anyhit, stats=stats)
    end.record()
    torch.cuda.synchronize()
    if stats["hit_max_steps"]:
        raise AssertionError("K2: the plain walk reached max_steps")
    return ref, stats, start.elapsed_time(end)


def compare_k2(name, K2, nodes, table, o, d, maxt, anyhit):
    """K2 against its plain walk on the same rays: prim, t, u, v bitwise.
    Returns (max abs error (0.0), the plain walk's counts and ms)."""
    mode = "any-hit" if anyhit else "closest-hit"
    got = K2.bvh_sweep(nodes, table, o, d, maxt, anyhit=anyhit)
    ref, stats, plain_ms = run_k2_plain(K2, nodes, table, o, d, maxt, anyhit)
    if not torch.equal(got[1], ref[1]):
        bad = (got[1] != ref[1]).nonzero()[:5, 0].tolist()
        raise AssertionError(f"K2 {name} {mode}: prim differs from the plain walk at lanes {bad}")
    pairs = list(zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])))
    worst = max(ulp_diff(g, r) for g, r in pairs)
    hit = ref[1] >= 0
    err = max(float((g[hit] - r[hit]).abs().max()) if hit.any() else 0.0 for g, r in pairs)
    log(f"K2 {name} {mode}: {o.shape[0]} rays, {int((maxt > 0).sum())} active, "
        f"{int(hit.sum())} hits, {stats['steps']} steps, {stats['node_visits']} node visits, "
        f"{stats['tri_tests']} triangle tests; prim bitwise; t/u/v worst {worst} ulp")
    if worst != 0 or not all(torch.equal(g.view(torch.int32), r.view(torch.int32)) for g, r in pairs):
        raise AssertionError(f"K2 {name} {mode}: t/u/v differ from the plain walk ({worst} ulp)")
    return err, stats, plain_ms


def k2_bound_ms(K2, nodes, table, maxt, stats):
    """Least time for one K2 call on these inputs: 28 B read per active
    lane (o, d, maxt) and 4 B per disabled one, 16 B written per lane, the
    node and triangle tables read once; against a slab test per node visit
    and a Moller-Trumbore test per triangle test, as the plain walk counted
    them on the same rays. Also the operations term at the unfused rate."""
    n = maxt.shape[0]
    n_active = int((maxt > 0).sum())
    nbytes = n_active * 28 + (n - n_active) * 4 + n * 16 + nodes.numel() * 4 + table.numel() * 4
    flops = stats["node_visits"] * K2.SLAB_FLOPS + stats["tri_tests"] * K2.TRI_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes"), nbytes, flops,
            max(t_bytes, flops / PEAK_FP32_UNFUSED * 1e3))


def check_and_time_k2(name, K2, nodes, table, o, d, maxt, anyhit):
    """K2 held bitwise against the plain walk on a whole batch of the main
    path, K2 timed on it, the plain walk's time (its one run, which is also
    the comparison's and the counts'), and the bound from those counts."""
    err, stats, plain_ms = compare_k2(name, K2, nodes, table, o, d, maxt, anyhit)
    k2_ms = time_cuda(lambda: K2.bvh_sweep(nodes, table, o, d, maxt, anyhit=anyhit), reps=10)
    bound_ms, bound_by, nbytes, flops, unfused_ms = k2_bound_ms(K2, nodes, table, maxt, stats)
    log(f"K2 timing, {name} ({'any-hit' if anyhit else 'closest-hit'}, {o.shape[0]} rays, "
        f"{int((maxt > 0).sum())} active): kernel {k2_ms:.4f} ms, plain {plain_ms:.1f} ms; "
        f"{nbytes} B, {flops} flop; bound {bound_ms:.4f} ms ({bound_by}), kernel at "
        f"{bound_ms / k2_ms:.2%} of it; at the unfused fp32 rate {unfused_ms:.4f} ms, "
        f"{unfused_ms / k2_ms:.2%}")
    return err, (k2_ms, plain_ms, bound_ms, bound_by)


def mesh_batches(scene, make_wavefront, shapes_mod, warp, spawn_ray):
    """The mesh scene's bounce-0 camera rays, the shadow rays of their NEE
    toward the light, and one incoherent bounce-1 batch (cosine-weighted
    directions off the bounce-0 hits), each [n] with disabled lanes where
    the camera ray missed."""
    n = scene.film.n_pixels * MESH_SPP
    _, ray, _ = make_wavefront(scene, 0, 0, n, 0, MESH_SPP, MESH_SPP)
    geom = scene.geometry.refresh()
    si = shapes_mod.compute_surface_interaction(
        geom, ray, shapes_mod.ray_intersect_preliminary(geom, ray))
    gen = torch.Generator(device=ray.o.device).manual_seed(1)
    u = torch.rand(n, 5, generator=gen, device=ray.o.device)
    ds, _ = scene.sample_emitter_direction(si.p, u[:, 0], u[:, 1:3], si.is_valid,
                                           test_visibility=False)
    shadow = spawn_ray(si.p, si.n, ds.d, maxt=ds.dist * (1.0 - 1e-3))
    s_maxt = torch.where(si.is_valid & (ds.pdf > 0), shadow.maxt, -float("inf"))
    bounce = spawn_ray(si.p, si.n, si.to_world(warp.square_to_cosine_hemisphere(u[:, 3:5])))
    b_maxt = torch.where(si.is_valid, bounce.maxt, -float("inf"))
    c = lambda x: x.contiguous()
    return (geom, (c(ray.o), c(ray.d), c(ray.maxt)), (c(shadow.o), c(shadow.d), c(s_maxt)),
            (c(bounce.o), c(bounce.d), c(b_maxt)))


def phase_k2(mi, K1, K2, native, tmp):
    """K2 against its plain walk on a random soup, and against it and timed
    on the mesh scene's whole batches: the bounce-0 camera rays and one
    incoherent bounce-1 batch (closest hit), and the bounce-0 shadow rays
    (any hit)."""
    from mitsuba_tpu_torch.core import warp
    from mitsuba_tpu_torch.render import shapes as shapes_mod
    from mitsuba_tpu_torch.render.records import spawn_ray
    from mitsuba_tpu_torch.render.scene_loader import mesh_scene
    from mitsuba_tpu_torch.render_api import make_wavefront

    t0 = time.perf_counter()
    scene = mi.load_dict(mesh_scene(tmp / "sphere.obj", k=MESH_K, res=MESH_RES))
    geom = scene.geometry
    log(f"== mesh scene: {time.perf_counter() - t0:.2f} s to write and load, "
        f"{geom.n_tris} triangle rows, BVH {tuple(geom.bvh_nodes.shape)} nodes, "
        f"has_bvh {geom.has_bvh}, on {geom.bvh_nodes.device}")
    if not geom.has_bvh or geom.bvh_nodes.device.type != "cuda":
        raise AssertionError("mesh scene: no BVH on the card")
    geom, cam, shadow, bounce = mesh_batches(scene, make_wavefront, shapes_mod, warp, spawn_ray)
    nodes, table = geom.bvh_nodes, K1.build_tri_table(geom)
    # a random soup of 16,384 triangles, 65,536 rays, half the lanes disabled
    s_table, s_o, s_d, s_maxt = random_soup(1 << 14, 1 << 16, 11, nodes.device)
    s_nodes, order = native.build_bvh_wide(s_table.cpu().numpy(), max_leaf=K2.MAX_WIDE_LEAF)
    s_nodes = torch.from_numpy(s_nodes).to(nodes.device)
    s_table = s_table[torch.from_numpy(order.astype(np.int64)).to(nodes.device)].contiguous()
    errs = [compare_k2("random soup", K2, s_nodes, s_table, s_o, s_d, s_maxt, anyhit)[0]
            for anyhit in (False, True)]

    e0, closest = check_and_time_k2("mesh bounce-0 camera batch", K2, nodes, table, *cam, anyhit=False)
    e1, bounce1 = check_and_time_k2("mesh bounce-1 batch", K2, nodes, table, *bounce, anyhit=False)
    e2, anyhit = check_and_time_k2("mesh bounce-0 shadow batch", K2, nodes, table, *shadow, anyhit=True)
    return scene, max(errs + [e0, e1, e2]), closest, bounce1, anyhit


def render_mesh(mi, scene, spp, stats=None):
    img = mi.render(scene, spp=spp, seed=0, stats=stats)
    torch.cuda.synchronize()
    return img


def phase_mesh_main(mi, K1, K2, scene, tmp):
    """The mesh main path at 256x256 @ 16 spp through mi.render; one more
    pass with CUDA events around each K2 launch; the 64x64 @ 16 spp render
    against the JAX package's means; the 64x64 @ 4 spp render through K2
    against the same render through the plain walk."""
    from mitsuba_tpu_torch.render import shapes as shapes_mod
    from mitsuba_tpu_torch.render.scene_loader import mesh_scene

    film = scene.film
    # warm-up at the measured pass's shapes, so that the counted pass and
    # the pass timed with events below pay no first-use costs; not counted
    render_mesh(mi, scene, MESH_SPP)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(K1, K2)
    stats = {}
    t0 = time.perf_counter()
    img = render_mesh(mi, scene, MESH_SPP, stats)
    wall = time.perf_counter() - t0
    n_closest, n_any = K2.bvh_sweep_intersect.launches, K2.bvh_sweep_occluded.launches
    k1_launches = K1.tri_intersect.launches
    peak = torch.cuda.max_memory_allocated()
    means = img.mean(dim=(0, 1)).tolist()
    log(f"== main path: mesh {film.width}x{film.height} @ {MESH_SPP} spp: {wall:.3f} s wall, "
        f"{stats['n_rays']} rays, {stats['n_rays'] / wall / 1e6:.2f} Mrays/s, "
        f"peak memory {peak / 2**30:.2f} GiB, K2 launches {n_closest} closest-hit + {n_any} "
        f"any-hit, K1 launches {k1_launches}, means {means}")
    if tuple(img.shape) != (film.height, film.width, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"mesh main path: image of shape {tuple(img.shape)} is not finite")
    max_depth = scene.integrator.max_depth
    # one closest-hit launch per bounce, and one any-hit launch for each
    # bounce's shadow rays (no deferred NEE on a BVH)
    if (n_closest, n_any, k1_launches) != (max_depth, max_depth, 0):
        raise AssertionError(f"mesh main path: K2 launched {n_closest} + {n_any} times, K1 "
                             f"{k1_launches} times; expected {max_depth} + {max_depth} and 0")
    rel = [abs(m - r) / r for m, r in zip(means, JAX_MESH64_MEANS)]
    log(f"  channel means within {max(rel):.4%} of the JAX package's 64x64 means")
    if max(rel) > MEAN_RTOL:
        raise AssertionError(f"mesh main path: means {means} vs JAX {JAX_MESH64_MEANS}: {rel}")

    # where the pass spends its time: CUDA events around each K2 launch
    events = {"closest": [], "anyhit": []}

    def timed(fn, key):
        def wrapper(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            events[key].append((start, end))
            return out
        return wrapper

    shapes_mod.bvh_sweep_intersect = timed(K2.bvh_sweep_intersect, "closest")
    shapes_mod.bvh_sweep_occluded = timed(K2.bvh_sweep_occluded, "anyhit")
    try:
        t0 = time.perf_counter()
        render_mesh(mi, scene, MESH_SPP)
        wall_t = time.perf_counter() - t0
    finally:
        shapes_mod.bvh_sweep_intersect = K2.bvh_sweep_intersect
        shapes_mod.bvh_sweep_occluded = K2.bvh_sweep_occluded
    k2_ms = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in events.items()}
    per = {k: [round(s.elapsed_time(e), 4) for s, e in v] for k, v in events.items()}
    log(f"== mesh pass with K2 timed: {wall_t * 1e3:.1f} ms wall; K2 closest-hit "
        f"{k2_ms['closest']:.2f} ms ({per['closest']}), any-hit {k2_ms['anyhit']:.2f} ms "
        f"({per['anyhit']}); K2 {(k2_ms['closest'] + k2_ms['anyhit']) / (wall_t * 1e3):.2%} "
        f"of the pass's wall time")

    d64 = mesh_scene(tmp / "sphere64.obj", k=MESH_K, res=64)
    scene64 = mi.load_dict(d64)
    img64 = render_mesh(mi, scene64, MESH_SPP)
    means64 = img64.mean(dim=(0, 1)).tolist()
    rel64 = [abs(m - r) / r for m, r in zip(means64, JAX_MESH64_MEANS)]
    log(f"== mesh 64x64 @ {MESH_SPP} spp: means {means64}, within {max(rel64):.4%} of the JAX "
        f"package's (same samples)")
    if max(rel64) > MESH64_MEAN_RTOL:
        raise AssertionError(f"mesh 64x64: means {means64} vs JAX {JAX_MESH64_MEANS}: {rel64}")

    img_k = render_mesh(mi, scene64, 4)
    shapes_mod.bvh_sweep_intersect = lambda *a: K2.bvh_sweep_reference(*a)   # this phase only
    shapes_mod.bvh_sweep_occluded = lambda *a: K2.bvh_sweep_reference(*a, anyhit=True)[1] >= 0
    try:
        img_p = render_mesh(mi, scene64, 4)
    finally:
        shapes_mod.bvh_sweep_intersect = K2.bvh_sweep_intersect
        shapes_mod.bvh_sweep_occluded = K2.bvh_sweep_occluded
    compare_images("mesh", img_k, img_p)
    return n_closest, n_any


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one card", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    import mitsuba_tpu_torch as mi
    from mitsuba_tpu_torch import native
    from mitsuba_tpu_torch.ops import bvh_sweep as K2
    from mitsuba_tpu_torch.ops import cuda_build
    from mitsuba_tpu_torch.ops import intersect as K1
    from mitsuba_tpu_torch.render import shapes as shapes_mod
    from mitsuba_tpu_torch.render_api import make_wavefront

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"== device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")

    build_all(cuda_build, native, K1, K2)
    scene, k1_entry = phase_k1(mi, K1, make_wavefront)
    k1_entry["launches"] = phase_cbox_main(mi, K1, K2, scene, shapes_mod)
    del scene
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        scene, err, closest, bounce1, anyhit = phase_k2(mi, K1, K2, native, tmp)
        n_closest, n_any = phase_mesh_main(mi, K1, K2, scene, tmp)

    k2 = {"route": "cuda", "source": "mitsuba_tpu_torch/csrc/bvh_sweep.cu",
          "replaces": "mitsuba_tpu/ops/bvh_sweep.py:108", "max_abs_err": err,
          "library_ms": None, "bitwise_vs_plain": err == 0.0}
    report = {"kernels": [
        k1_entry,
        dict(name="bvh_sweep_closest", launches=n_closest, ms=closest[0], plain_ms=closest[1],
             bound_ms=closest[2], bound_by=closest[3], batch="mesh bounce-0 camera rays",
             bounce1_ms=bounce1[0], bounce1_bound_ms=bounce1[2], **k2),
        dict(name="bvh_sweep_anyhit", launches=n_any, ms=anyhit[0], plain_ms=anyhit[1],
             bound_ms=anyhit[2], bound_by=anyhit[3], batch="mesh bounce-0 shadow rays", **k2),
    ]}
    log(f"== chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
