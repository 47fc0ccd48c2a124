"""Kernel K2 (csrc/bvh_sweep.cu, the BVH closest hit and any hit) against an
earlier version of it, timed in turns on one card in one process.

    git show <rev>:mitsuba_tpu_torch/csrc/bvh_sweep.cu > build/old/bvh_sweep.cu
    python3 scripts/torch_bench_bvh.py --old build/old

The old source is built with nvcc beside the package's (both started
together; the -Xptxas -v reports are printed); it must have the launcher
of the kernel it replaced, bvh_sweep_launch(nodes, table, o, d, maxt, n,
anyhit, t, prim, u, v, stream) over the [T, 9] table. The batches are the
large-mesh scene's (chip_smoke.py's, 256x256 @ 16 spp, 202,822 triangles):

- the bounce-0 camera rays, one incoherent bounce-1 batch and the same
  with 90% of its lanes disabled at random (closest hit), the bounce-0
  shadow rays (any hit);
- the 16 launches (8 closest hit, 8 any hit) of one mesh pass, recorded
  through the route and replayed back to back, then each launch alone
  (old and new, in turns); each launch's share of active lanes is
  printed.

The new kernel is timed as the route runs it (K2.bvh_sweep on the
geometry's 16-byte rows, Geometry.bvh_rows: its checks, the counter and
the launch), as a route with the JAX package's coherence sort would run it
(the key, the order and its host read, the batch gathered in that order,
the launch, the four results scattered back: "new sorted"), and alone (the
launch, on the batch in lane order and on the batch gathered in the
coherence order beforehand: "new sorted alone"). Old and new must agree
bit for bit (prim, t, u, v) on every batch and launch, sorted or not. The
times (CUDA events) go in turns: old, new, new sorted, new alone, new
sorted alone, then the same backwards; each version's time is the mean of
its two turns. The bounds are chip_smoke.py's
(k2_bound_ms), counted by the plain walk on the same rays. Prints the
card's name and power limit and, last, one JSON line of every time and
bound.
"""
import argparse
import ctypes
import json
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import mitsuba_tpu_torch as mi  # noqa: E402
from mitsuba_tpu_torch import native  # noqa: E402
from mitsuba_tpu_torch.core import warp  # noqa: E402
from mitsuba_tpu_torch.ops import bvh_sweep as K2  # noqa: E402
from mitsuba_tpu_torch.ops import cuda_build  # noqa: E402
from mitsuba_tpu_torch.ops import intersect as K1  # noqa: E402
from mitsuba_tpu_torch.render import shapes as shapes_mod  # noqa: E402
from mitsuba_tpu_torch.render.records import spawn_ray  # noqa: E402
from mitsuba_tpu_torch.render.scene_loader import mesh_scene  # noqa: E402
from mitsuba_tpu_torch.render_api import make_wavefront  # noqa: E402


def old_launcher(path):
    """fn(nodes, table, o, d, maxt, anyhit) -> (t, prim, u, v) through the
    old kernel's bvh_sweep_launch in the shared library at `path`."""
    fn = ctypes.CDLL(str(path)).bvh_sweep_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, vp, vp, vp, vp, vp]
    fn.restype = ci

    def run(nodes, table, o, d, maxt, anyhit):
        n = o.shape[0]
        t, u, v = (torch.empty(n, device=o.device) for _ in range(3))
        prim = torch.empty(n, dtype=torch.int32, device=o.device)
        rc = fn(nodes.data_ptr(), table.data_ptr(), o.data_ptr(), d.data_ptr(),
                maxt.data_ptr(), n, int(anyhit), t.data_ptr(), prim.data_ptr(), u.data_ptr(),
                v.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{path.name}: launch failed with CUDA error {rc}")
        return t, prim, u, v

    return run


def build_all(old_dir):
    with ThreadPoolExecutor(3) as pool:
        old = pool.submit(cuda_build.build, "bvh_sweep_old", K2.BUILD_FLAGS,
                          Path(old_dir) / "bvh_sweep.cu")
        new = pool.submit(cuda_build.build, "bvh_sweep", K2.BUILD_FLAGS)
        host = pool.submit(cuda_build.build_host, "mtpu_native", native.SOURCES)
        builds = {"old": old.result(), "new": new.result()}
        host.result()
    for k, b in builds.items():
        cs.log(f"== build {k}: {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "warning" in line.lower():
                cs.log(f"    {line.strip()}")
    return old_launcher(builds["old"].path)


def bitwise(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def in_turns(fns, reps):
    """ms of each named fn, the mean of its turns forwards and backwards."""
    order = list(fns) + list(fns)[::-1]
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(cs.time_cuda(fns[k], reps=reps))
    return {k: sum(v) / len(v) for k, v in times.items()}


def coherence_perm(nodes, o, d, maxt):
    """The JAX package's order of a batch for its kernel (int64):
    maybe_sort_order(ray_sort_key(...)) over the root box."""
    key = K2.ray_sort_key(o, d, nodes[0, 0:3], nodes[0, 3:6], maxt)
    return K2.maybe_sort_order(key).long()


def sorted_route(nodes, table, rows, o, d, maxt, anyhit):
    """A route with the coherence sort: the order, the batch gathered in
    it, the launch, the results scattered back to lane order."""
    perm = coherence_perm(nodes, o, d, maxt)
    out = K2.bvh_sweep(nodes, table, o[perm], d[perm], maxt[perm], anyhit, rows=rows)
    back = tuple(torch.empty_like(x) for x in out)
    for x, y in zip(out, back):
        y[perm] = x
    return back


def versions(old, nodes, table, rows, calls):
    """The five timed versions over `calls`, each a list of (o, d, maxt,
    anyhit)."""
    gathered = []
    for o, d, maxt, anyhit in calls:
        perm = coherence_perm(nodes, o, d, maxt)
        gathered.append((o[perm], d[perm], maxt[perm], anyhit))
    return {
        "old": lambda: [old(nodes, table, *c) for c in calls],
        "new": lambda: [K2.bvh_sweep(nodes, table, *c, rows=rows) for c in calls],
        "new sorted": lambda: [sorted_route(nodes, table, rows, *c) for c in calls],
        "new alone": lambda: [K2.launch_kernel(nodes, rows, *c) for c in calls],
        "new sorted alone": lambda: [K2.launch_kernel(nodes, rows, *c) for c in gathered],
    }


def check(old, nodes, table, rows, name, calls):
    """Old and new (in lane order and sorted) bit for bit on each call;
    returns the bounds of the calls (chip_smoke.k2_bound_ms) and their
    active shares."""
    bounds, shares = [], []
    for o, d, maxt, anyhit in calls:
        ref = old(nodes, table, o, d, maxt, anyhit)
        new = K2.bvh_sweep(nodes, table, o, d, maxt, anyhit, rows=rows)
        srt = sorted_route(nodes, table, rows, o, d, maxt, anyhit)
        if not (bitwise(new, ref) and bitwise(srt, ref)):
            raise AssertionError(f"K2 new differs from the old K2 on {name}")
        stats = {}
        K2.bvh_sweep_reference(nodes, table, o, d, maxt, anyhit, stats=stats)
        bounds.append(cs.k2_bound_ms(K2, nodes, table, maxt, stats))
        shares.append(round(float((maxt > 0).float().mean()), 4))
    return bounds, shares


def record_pass(scene):
    """(o, d, maxt, anyhit) of every K2 launch of one mesh pass, cloned as
    the route passed them."""
    fn, calls = K2.bvh_sweep, []

    def rec(nodes, table, o, d, maxt, anyhit=False, rows=None):
        calls.append((o.clone(), d.clone(), maxt.clone(), anyhit))
        return fn(nodes, table, o, d, maxt, anyhit, rows)

    K2.bvh_sweep = rec
    try:
        mi.render(scene, spp=cs.MESH_SPP, seed=0)
        torch.cuda.synchronize()
    finally:
        K2.bvh_sweep = fn
    return calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="directory with the old bvh_sweep.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_bench_bvh: no CUDA device")
    smi = cs.nvidia_smi()
    cs.log(f"== device: {torch.cuda.get_device_name(0)}; {smi}")
    old = build_all(args.old)

    with tempfile.TemporaryDirectory() as tmp:
        scene = mi.load_dict(mesh_scene(Path(tmp) / "sphere.obj", k=cs.MESH_K, res=cs.MESH_RES))
    geom, cam, shadow, bounce = cs.mesh_batches(scene, make_wavefront, shapes_mod, warp, spawn_ray)
    nodes, table = geom.bvh_nodes, K1.build_tri_table(geom)
    rows = geom.bvh_rows
    scattered = (bounce[0], bounce[1], cs.disable_share(bounce[2], 0.9, 5))
    batches = {"bounce-0 camera batch": (*cam, False), "bounce-1 batch": (*bounce, False),
               "bounce-1 batch, 90% of lanes disabled": (*scattered, False),
               "bounce-0 shadow batch (any hit)": (*shadow, True)}
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "batches": {}}
    for name, call in batches.items():
        (b,), (share,) = check(old, nodes, table, rows, name, [call])
        ms = in_turns(versions(old, nodes, table, rows, [call]), reps=10)
        result["batches"][name] = dict(active=share, ms=ms, bound_ms=b["ms"], bound_by=b["by"],
                                       bound_all46_ms=b["all46_ms"])
        cs.log(f"== {name}: active {share}, ms {ms}, bound {b['ms']:.4f} ({b['by']}; all 46 "
               f"operations a test {b['all46_ms']:.4f}); old / new {ms['old'] / ms['new']:.2f}x")

    calls = record_pass(scene)
    bounds, shares = check(old, nodes, table, rows, "the recorded pass", calls)
    ms = in_turns(versions(old, nodes, table, rows, calls), reps=5)
    bound = sum(b["ms"] for b in bounds)
    result["pass"] = dict(launches=len(calls), active=shares, ms=ms, bound_ms=bound,
                          bound_all46_ms=sum(b["all46_ms"] for b in bounds),
                          bound_ms_by_launch=[round(b["ms"], 4) for b in bounds])
    cs.log(f"== the {len(calls)} K2 launches of one mesh pass, back to back: active shares "
           f"{shares}; ms {ms}; summed bound {bound:.4f}; old / new {ms['old'] / ms['new']:.2f}x")
    by_launch = []
    for c, share in zip(calls, shares):
        fns = versions(old, nodes, table, rows, [c])
        by_launch.append({k: round(v, 4) for k, v in in_turns(
            {k: fns[k] for k in ("old", "new", "new alone", "new sorted alone")},
            reps=5).items()})
        cs.log(f"  launch {len(by_launch) - 1} ({'any' if c[3] else 'closest'} hit, active "
               f"{share}): {by_launch[-1]}")
    result["pass"]["ms_by_launch"] = by_launch
    cs.log(smi)
    cs.log(json.dumps(result))


if __name__ == "__main__":
    main()
