"""Where the time goes in one volpath pass of mitsuba_tpu_torch on a CUDA
card: torch.profiler over one render (after a warm-up render) of
bench.py's heterogeneous volume (96x96 @ 16 spp, max_depth 12, 16 tracking
steps), its deep homogeneous slab (128x128 @ 16 spp, max_depth 32) or its
polarized atmosphere (BASELINE config 4: mono_polarized, render_1 of a
64x64 radiancemeter film @ 64 spp, max_depth 8), with a profiler range
around each layer of the integrator.

    python3 scripts/torch_profile_volpath.py [--scene het|vol32|atmo] [--regenerate]

The ranges are put around the layers from here, for this run only (the
package carries no instrumentation): "ray_intersect" (every closest hit,
K1 and the surface interaction), "track_segment" (delta tracking of a
segment), "estimate_transmittance" (NEE: its crossings' closest hits and
"track_segment_ratio", the ratio tracking), "emitter_sample" and, in a
polarized variant, the Mueller layer: "phase_eval_pdf_pol" (the phase
matrices of NEE and of the sampled direction, rotated to the world) and
"phase_sample_pol" (the sampled direction's weight), and
"to_sensor_mueller" (the lanes' Stokes vectors into the sensor frame). Prints
the wall time, the device kernel time and busy share (kernel time over
wall; the kernels of one stream do not overlap), the kernel launches,
K1's launches and time, each range's host time, calls and the kernels
launched inside it, and the 12 kernels that take the most device time.
The last line is the same as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOP = 12


def _device_us(ev):
    return getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)


def _ranged(name, fn):
    def wrapper(*args, **kw):
        with record_function(name):
            return fn(*args, **kw)
    return wrapper


def _kernels_below(ev):
    """Device kernels launched by an event and by everything below it."""
    return len(getattr(ev, "kernels", ())) + sum(_kernels_below(c) for c in ev.cpu_children)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("het", "vol32", "atmo"), default="het")
    ap.add_argument("--regenerate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_volpath: needs a CUDA card")
    import mitsuba_tpu_torch as mi
    from mitsuba_tpu_torch import render_api
    from mitsuba_tpu_torch.integrators import volpath
    from mitsuba_tpu_torch.render import scene as scene_mod
    from mitsuba_tpu_torch.render.scene_loader import atmo_scene, het_vol_scene, vol32_scene

    if args.scene == "atmo":
        if args.regenerate:
            sys.exit("torch_profile_volpath: the polarized atmosphere has no regenerative path")
        mi.set_variant("mono_polarized")
        scene = mi.load_dict(atmo_scene())
        render = mi.render_1
    else:
        make = het_vol_scene if args.scene == "het" else vol32_scene
        scene = mi.load_dict(make(regenerate=args.regenerate))
        render = mi.render
    spp = scene.spp
    layers = ("track_segment", "track_segment_ratio", "estimate_transmittance")
    scene_layers = {"ray_intersect": "ray_intersect",
                    "sample_emitter_direction": "emitter_sample",
                    "phase_eval_pdf_pol": "phase_eval_pdf_pol",
                    "phase_sample_pol": "phase_sample_pol"}
    saved = {name: getattr(volpath, name) for name in layers}
    saved_scene = {name: getattr(scene_mod.Scene, name) for name in scene_layers}
    saved_rotation = render_api.to_sensor_mueller
    for name, fn in saved.items():
        setattr(volpath, name, _ranged(name, fn))
    for name, label in scene_layers.items():
        setattr(scene_mod.Scene, name, _ranged(label, saved_scene[name]))
    render_api.to_sensor_mueller = _ranged("to_sensor_mueller", saved_rotation)
    try:
        render(scene, spp=spp, seed=1)            # warm-up: build, load, allocator
        torch.cuda.synchronize()
        stats = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            img = render(scene, spp=spp, seed=0, stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(volpath, name, fn)
        for name, fn in saved_scene.items():
            setattr(scene_mod.Scene, name, fn)
        render_api.to_sensor_mueller = saved_rotation
        mi.set_variant("rgb")
    assert bool(torch.isfinite(img).all())

    names = layers + tuple(scene_layers.values()) + ("to_sensor_mueller",)
    # the ranges' own device spans are not kernels: leave them out of the sums
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in names]
    total_us = sum(_device_us(e) for e in rows)
    launches = sum(e.count for e in rows)
    k1 = [e for e in rows if "tri_intersect" in e.key]
    k1_us = sum(_device_us(e) for e in k1)
    ranges = {}
    for ev in prof.events():
        if ev.name in names and ev.device_type == DeviceType.CPU:
            r = ranges.setdefault(ev.name, dict(calls=0, host_ms=0.0, kernels=0))
            r["calls"] += 1
            r["host_ms"] += ev.cpu_time_total / 1e3
            r["kernels"] += _kernels_below(ev)
    film = scene.film
    out = dict(
        device=torch.cuda.get_device_name(0), scene=args.scene, regenerate=args.regenerate,
        res=f"{film.width}x{film.height}", spp=spp, lanes=film.n_pixels * spp, wall_ms=wall * 1e3,
        n_rays=stats["n_rays"], wavefront_iters=stats.get("wavefront_iters"),
        device_ms=total_us / 1e3, busy_share=total_us / 1e3 / (wall * 1e3), launches=launches,
        k1_launches=sum(e.count for e in k1), k1_ms=k1_us / 1e3, ranges=ranges,
        top=[dict(kernel=e.key[:90], count=e.count, ms=_device_us(e) / 1e3)
             for e in sorted(rows, key=_device_us, reverse=True)[:TOP]],
    )
    print(f"{out['device']}: {args.scene} {out['res']} @ {spp} spp, regenerate "
          f"{args.regenerate}, profiled wall {wall * 1e3:.1f} ms, {stats['n_rays']} rays, "
          f"wavefront iterations {out['wavefront_iters']}")
    print(f"device kernel time {out['device_ms']:.1f} ms over {launches} launches (busy share "
          f"{out['busy_share']:.1%}, mean {total_us / max(launches, 1):.2f} us per launch)")
    print(f"K1 tri_intersect: {out['k1_launches']} launches, {out['k1_ms']:.3f} ms "
          f"({k1_us / max(total_us, 1):.2%} of device time)")
    for name, r in ranges.items():
        print(f"range {name:<24} calls {r['calls']:>6} host {r['host_ms']:>9.1f} ms "
              f"kernels {r['kernels']:>8}")
    for t in out["top"]:
        print(f"{t['kernel']:<90} {t['count']:>7} {t['ms']:>9.3f} ms")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
