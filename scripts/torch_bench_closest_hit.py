"""The closest-hit kernels K1 (csrc/tri_intersect.cu) and K3
(csrc/intersect_mxu.cu) against an earlier version of each, and K3 against
another design of it, timed in turns on one card in one process.

    git show <rev>:mitsuba_tpu_torch/csrc/tri_intersect.cu > build/old/tri_intersect.cu
    git show <rev>:mitsuba_tpu_torch/csrc/intersect_mxu.cu > build/old/intersect_mxu.cu
    python3 scripts/torch_bench_closest_hit.py --old build/old [--k3-alt FILE.cu]

Every source is built with nvcc beside the package's (all builds started
together; the -Xptxas -v reports are printed). `--k3-alt` is a second
design of K3 with the same launcher (default: the wgmma design,
scripts/intersect_mxu_wgmma.cu). The batches are the Cornell box's, at
256x256 @ 64 spp as chip_smoke.py drives it:

- the bounce-0 2N batch (the camera rays, the N shadow slots disabled);
- the same rays with every lane active, and with a random 50% disabled;
- every launch of one PRB gradient step (256x256 @ 64 spp, max_depth 8,
  seed 0), recorded through each route (34 each), and every K1 launch of
  one cbox forward render (256x256 @ 64 spp, seed 0: 9), each set timed
  back to back as a sequence.

K1's versions must agree bit for bit on every batch, and each K3 version
is held against K3's plain version within chip_smoke.py's bounds (a design
that fails them is reported and not timed). The times (CUDA events) go in
turns, each version's time the mean of its two turns: K1 old on the
64-row padded table its route swept, old on the 36 real rows, new on the
36 real rows its route sweeps, then the same backwards; K3 old, new, alt,
alt, new, old. Prints the card's name and power
limit and, last, one JSON line of every time and bound.
"""
import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import mitsuba_tpu_torch as mi  # noqa: E402
from mitsuba_tpu_torch.ops import cuda_build  # noqa: E402
from mitsuba_tpu_torch.ops import intersect as K1  # noqa: E402
from mitsuba_tpu_torch.ops import intersect_mxu as K3  # noqa: E402
from mitsuba_tpu_torch.render_api import make_wavefront  # noqa: E402


def launcher(path, symbol):
    """fn(table or cols, o, d, maxt) -> (t, prim, u, v) through `symbol` of
    the shared library at `path` (K1's and K3's launchers take the same
    arguments; K3's second is Tp, a quarter of the column count)."""
    fn = getattr(ctypes.CDLL(str(path)), symbol)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, vp, vp, vp, ci, vp, vp, vp, vp, vp]
    fn.restype = ci
    per_row = 4 if symbol.startswith("mxu") else 1

    def run(tab, o, d, maxt):
        n = o.shape[0]
        t, u, v = (torch.empty(n, device=o.device) for _ in range(3))
        prim = torch.empty(n, dtype=torch.int32, device=o.device)
        rows = tab.shape[1] // 4 if per_row == 4 else tab.shape[0]
        rc = fn(tab.data_ptr(), rows, o.data_ptr(), d.data_ptr(), maxt.data_ptr(), n,
                t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{path.name}: launch failed with CUDA error {rc}")
        return t, prim, u, v

    return run


def build_all(old_dir, k3_alt):
    jobs = {
        "K1 old": ("tri_intersect_old", Path(old_dir) / "tri_intersect.cu", K1.BUILD_FLAGS),
        "K1 new": ("tri_intersect", None, K1.BUILD_FLAGS),
        "K3 old": ("intersect_mxu_old", Path(old_dir) / "intersect_mxu.cu", K3.BUILD_FLAGS),
        "K3 new": ("intersect_mxu", None, K3.BUILD_FLAGS),
        "K3 alt": ("intersect_mxu_alt", Path(k3_alt), K3.BUILD_FLAGS),
    }
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(cuda_build.build, name, flags, src)
                for k, (name, src, flags) in jobs.items()}
        builds = {k: f.result() for k, f in futs.items()}
    for k, b in builds.items():
        cs.log(f"== build {k}: {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "warning" in line.lower():
                cs.log(f"    {line.strip()}")
    sym = {"K1": "tri_intersect_launch", "K3": "mxu_intersect_launch"}
    return {k: launcher(b.path, sym[k[:2]]) for k, b in builds.items()}


def record(intersector, backward):
    """Inputs of every closest-hit launch of one pass through
    `intersector`, cloned as they were passed: the PRB gradient step
    (`backward`) or the cbox forward render (the path integrator)."""
    d = cs.prb_dict(mi, cs.PRB_RES, cs.PRB_SPP, 8) if backward else mi.cornell_box()
    scene = mi.load_dict(d, intersector=intersector)
    owner, name = (K1, "smem_intersect") if intersector == "smem" else (K3, "mxu_intersect")
    fn, calls = getattr(owner, name), []

    def rec(*args):
        calls.append(tuple(a.clone() for a in args))
        return fn(*args)

    rec.launches = fn.launches
    setattr(owner, name, rec)
    try:
        if backward:
            cs.grad_step(mi, scene, 0, cs.PRB_SPP)
        else:
            mi.render(scene, spp=64, seed=0)
        torch.cuda.synchronize()
    finally:
        setattr(owner, name, fn)
    return scene, calls


def in_turns(fns, order, reps):
    """ms of each named fn, the mean of its turns in `order`."""
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(cs.time_cuda(fns[k], reps=reps))
    return {k: sum(v) / len(v) for k, v in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="directory with the old tri_intersect.cu "
                    "and intersect_mxu.cu")
    ap.add_argument("--k3-alt", default=str(ROOT / "scripts" / "intersect_mxu_wgmma.cu"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_bench_closest_hit: no CUDA device")
    smi = cs.nvidia_smi()
    cs.log(f"== device: {torch.cuda.get_device_name(0)}; {smi}")
    run = build_all(args.old, args.k3_alt)

    scene = mi.load_dict(mi.cornell_box())
    n = scene.film.n_pixels * 64
    geom = scene.geometry.refresh()
    t64 = K1.build_tri_table(geom)
    t36 = t64[:geom.n_real_tris]
    cols = K3.build_mxu_cols(t36[:, 0:3], t36[:, 3:6], t36[:, 6:9])
    _, ray, _, _, _ = make_wavefront(scene, 0, 0, n, 0, 64, 64)
    o = torch.cat([ray.o, ray.o]).contiguous()
    d = torch.cat([ray.d, ray.d]).contiguous()
    maxt0 = torch.cat([ray.maxt, torch.full_like(ray.maxt, -float("inf"))]).contiguous()
    maxt_all = torch.full_like(maxt0, float("inf"))
    batches = {"cbox bounce-0 batch": maxt0, "every lane active": maxt_all,
               "50% of lanes disabled at random": cs.disable_share(maxt_all, 0.5, 3)}
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "K1": {}, "K3": {}}

    k3_ok = ["K3 old", "K3 new", "K3 alt"]
    for name, maxt in batches.items():
        ref = run["K1 old"](t64, o, d, maxt)
        for got, what in ((run["K1 new"](t36, o, d, maxt), "new"), (run["K1 old"](t36, o, d, maxt), "old, 36 rows")):
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"K1 {what} differs from the old K1 on {name}")
        plain = K3.mxu_intersect_reference(cols, o, d, maxt)
        for k in list(k3_ok):
            try:
                cs.compare_hits(f"{k}, {name}", run[k](cols, o, d, maxt), plain, t36, d,
                                cs.K3_PRIM_RATE, cs.K3_RTOL, True)
            except (AssertionError, RuntimeError) as e:
                cs.log(f"!! {k} fails on {name}: {e}; not timed")
                k3_ok.remove(k)
        del plain
        k1 = in_turns({"old, 64 rows": lambda: run["K1 old"](t64, o, d, maxt),
                       "old, 36 rows": lambda: run["K1 old"](t36, o, d, maxt),
                       "new, 36 rows": lambda: run["K1 new"](t36, o, d, maxt)},
                      ["old, 64 rows", "old, 36 rows", "new, 36 rows", "new, 36 rows",
                       "old, 36 rows", "old, 64 rows"], reps=50)
        k3 = in_turns({k: (lambda k=k: run[k](cols, o, d, maxt)) for k in k3_ok},
                      k3_ok + k3_ok[::-1], reps=50)
        b = cs.k1_bound_ms(cs.k1_work(t36, o, d, maxt))
        b1, u1 = b["ms"], b["unfused_ms"]
        b3 = cs.k3_bound_ms(cs.k3_work(cols, o, d, maxt))[0]
        result["K1"][name] = dict(ms=k1, bound_ms=b1, bound_unfused_ms=u1)
        result["K3"][name] = dict(ms=k3, bound_ms=b3)
        cs.log(f"== {name}: K1 {k1} (bound {b1:.4f}, unfused {u1:.4f}); K3 {k3} (bound {b3:.4f})")

    for inter, key, what in (("smem", "K1", "cbox forward pass launches"),
                             ("smem", "K1", "PRB step launches"),
                             ("mma", "K3", "PRB step launches")):
        step_scene, calls = record(inter, what.startswith("PRB"))
        if inter == "smem":
            full = K1.build_tri_table(step_scene.geometry.refresh())
            for tab, co, cd, cm in calls:
                got, ref = run["K1 new"](tab, co, cd, cm), run["K1 old"](full, co, cd, cm)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"K1 new differs from the old K1 on the {what}")
            fns = {"old, 64 rows": lambda: [run["K1 old"](full, *c[1:]) for c in calls],
                   "old, 36 rows": lambda: [run["K1 old"](*c) for c in calls],
                   "new, 36 rows": lambda: [run["K1 new"](*c) for c in calls]}
            order = ["old, 64 rows", "old, 36 rows", "new, 36 rows", "new, 36 rows",
                     "old, 36 rows", "old, 64 rows"]
            bounds = [cs.k1_bound_ms(cs.k1_work(*c)) for c in calls]
            bound, unfused = sum(b["ms"] for b in bounds), sum(b["unfused_ms"] for b in bounds)
        else:
            fns = {k: (lambda k=k: [run[k](*c) for c in calls]) for k in k3_ok}
            order = k3_ok + k3_ok[::-1]
            bound = unfused = sum(cs.k3_bound_ms(cs.k3_work(*c))[0] for c in calls)
        ms = in_turns(fns, order, reps=5)
        result[key][what] = dict(launches=len(calls), ms=ms, bound_ms=bound,
                                 bound_unfused_ms=unfused)
        cs.log(f"== {what}, {len(calls)} {key} launches summed: {ms} (bound {bound:.4f}, "
               f"unfused {unfused:.4f})")
        del calls

    cs.log(smi)
    cs.log(json.dumps(result))


if __name__ == "__main__":
    main()
