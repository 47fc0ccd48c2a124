"""Smoke test of mitsuba_tpu_torch on one CUDA card.

Builds every hand-written kernel of the port from the sources in this
checkout, holds each against its plain PyTorch version on the card, drives
the main path (the Cornell box, 256x256 @ 64 spp, path tracer, max_depth 8)
through the user entry points, and checks that the main path went through
the kernels. Any failure raises and exits non-zero.

    python3 chip_smoke.py

Prints, before the last line, the card's name and power limit and one JSON
line {"kernels": [...]} with each kernel's launches on the main path, its
error against the plain version, its time, the plain version's time and
its lower bound on this card. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Per-channel means of the JAX package's image of the same configuration
# (mi.cornell_box() at 256x256, spp=64, seed=0; spp_per_pass=4, which the
# JAX package's RNG keying makes equal to one pass), computed once with
# mitsuba_tpu on the CPU.
JAX_CBOX_MEANS = (0.2402133047580719, 0.14114509522914886, 0.059986136853694916)
MEAN_RTOL = 0.03

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit):
# fp32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 arithmetic per (ray, triangle) of the Moller-Trumbore test, counted
# from the kernel: 2 cross products (18), 4 dot products (20), the 3
# subtractions of tvec, the 3 scalings by 1/det, the reciprocal and u + v.
# The 6 compares are not counted.
K1_FLOPS_PER_PAIR = 46


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one card", file=sys.stderr)
        sys.exit(2)
    import mitsuba_tpu_torch as mi
    from mitsuba_tpu_torch.ops import cuda_build
    from mitsuba_tpu_torch.ops import intersect as K1
    from mitsuba_tpu_torch.render import shapes as shapes_mod
    from mitsuba_tpu_torch.render_api import make_wavefront

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"== device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")

    # ---- build K1 ----
    t0 = time.perf_counter()
    b = cuda_build.build("tri_intersect", K1.BUILD_FLAGS)
    log(f"== build: {time.perf_counter() - t0:.2f} s wall")
    log(f"  tri_intersect: nvcc {b.seconds:.2f} s -> {b.path.name}")
    for line in b.log.splitlines():
        if line.strip():
            log(f"    {line.strip()}")

    # ---- K1 against its plain version, timed ----
    scene = mi.load_dict(mi.cornell_box())
    film = scene.film
    spp = 64
    n = film.n_pixels * spp
    geom = scene.geometry.refresh()
    table = K1.build_tri_table(geom)
    _, ray, _ = make_wavefront(scene, 0, 0, n, 0, spp, spp)
    # bounce 0's fused launch: the camera rays, then the N pending shadow
    # slots, all disabled on the first bounce
    o = torch.cat([ray.o, ray.o]).contiguous()
    d = torch.cat([ray.d, ray.d]).contiguous()
    maxt = torch.cat([ray.maxt, torch.full_like(ray.maxt, -float("inf"))]).contiguous()
    worst_a, err_a = compare_k1("cbox bounce-0 batch", K1, table, o, d, maxt)
    worst_b, err_b = compare_k1("random soup", K1, *random_soup(4096, 1 << 20, 7, dev))
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
    del o, d, maxt, maxt_all, ray

    # ---- main path: cbox 256x256 @ 64 spp through the user entry points ----
    mi.render(scene, spp=1, seed=1)                       # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K1.tri_intersect.launches = 0
    stats = {}
    t0 = time.perf_counter()
    img = mi.render(scene, spp=spp, seed=0, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K1.tri_intersect.launches
    peak = torch.cuda.max_memory_allocated()
    means = img.mean(dim=(0, 1)).tolist()
    log(f"== main path: cbox {film.width}x{film.height} @ {spp} spp: {wall:.3f} s wall, "
        f"{stats['n_rays']} rays, {stats['n_rays'] / wall / 1e6:.2f} Mrays/s, "
        f"peak memory {peak / 2**30:.2f} GiB, K1 launches {launches}, means {means}")
    if tuple(img.shape) != (film.height, film.width, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"main path: image of shape {tuple(img.shape)} is not finite")
    n_passes = 1        # render() takes all spp in one pass unless spp_per_pass is given
    if launches != 9 * n_passes:
        raise AssertionError(f"main path: K1 launched {launches} times, expected 9 per pass")
    rel = [abs(m - r) / r for m, r in zip(means, JAX_CBOX_MEANS)]
    if max(rel) > MEAN_RTOL:
        raise AssertionError(f"main path: channel means {means} vs JAX {JAX_CBOX_MEANS}: {rel}")
    log(f"  channel means within {max(rel):.4%} of the JAX package's")

    # ---- the main path through K1 against the same path on the plain version ----
    d64 = mi.cornell_box()
    d64["sensor"]["film"]["width"] = d64["sensor"]["film"]["height"] = 64
    scene64 = mi.load_dict(d64)
    img_k = mi.render(scene64, spp=4, seed=0)
    shapes_mod.tri_intersect = K1.tri_intersect_reference   # this phase only
    try:
        img_p = mi.render(scene64, spp=4, seed=0)
    finally:
        shapes_mod.tri_intersect = K1.tri_intersect
    if max(worst_a, worst_b) == 0:
        if not torch.equal(img_k, img_p):
            raise AssertionError("64x64 render: kernel and plain images differ")
        log("== kernel vs plain render, 64x64 @ 4 spp: bitwise equal")
    else:
        eq = torch.isclose(img_k, img_p, rtol=1e-5, atol=0).all(-1).float().mean().item()
        log(f"== kernel vs plain render, 64x64 @ 4 spp: {eq:.5%} of pixels equal at rtol 1e-5")
        if eq < 0.999:
            raise AssertionError("64x64 render: kernel and plain images differ beyond 0.1% of pixels")

    report = {"kernels": [{
        "name": "tri_intersect",
        "route": "cuda",
        "source": "mitsuba_tpu_torch/csrc/tri_intersect.cu",
        "replaces": "mitsuba_tpu/ops/intersect.py:33",
        "launches": launches,
        "max_abs_err": max(err_a, err_b),
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "bitwise_vs_plain": max(worst_a, worst_b) == 0,
    }]}
    log(smi)
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
