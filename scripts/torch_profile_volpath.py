"""Where the time goes in one volpath pass, or one PRB gradient step, of
mitsuba_tpu_torch on a CUDA card: torch.profiler over one render (after a
warm-up render) of bench.py's heterogeneous volume (96x96 @ 16 spp,
max_depth 12, 16 tracking steps), its deep homogeneous slab (128x128 @ 16
spp, max_depth 32), its polarized atmosphere (BASELINE config 4:
mono_polarized, render_1 of a 64x64 radiancemeter film @ 64 spp, max_depth
8) or its atmosphere-ocean scene (BASELINE config 5: mono_polarized,
volpathaos render_1 of a 32x32 film @ 64 spp, max_depth 4), with a
profiler range around each layer of the integrator; or of the surface
materials: the materials scene (rgb, path at 256x256 @ 64 spp, max_depth
8) or the polarimeter (rgb_polarized, stokes over volpath at 256x256 @ 64
spp in passes of 16 spp), with a range around each BSDF's methods too.

    python3 scripts/torch_profile_volpath.py [--scene het|vol32|atmo|aos|materials|polarimeter]
                                             [--regenerate] [--prb]

With --prb the profiled call is one gradient step instead (the scene's
PRB integrator: prbvolpath for het and vol32, prb_polarized for atmo,
prb_volpathaos for aos, as bench.py's config 5): the gradient of the
render's sum (het, vol32: its mean) for the medium's sigma_t (aos: the
atmosphere's), its forward pass and its backward pass (the PRB node's
own primal pass, then the replay). With --regenerate the render (and
with --prb the step: its forward, the backward's primal and the replay)
runs the regenerative loops; the polarized scenes then render the image,
since the radiometer is one wavefront pass.

The ranges are put around the layers from here, for this run only (the
package carries no instrumentation): "ray_intersect" (every closest hit,
K1 and the surface interaction), "track_segment" (delta tracking of a
segment), "estimate_transmittance" (NEE: its crossings' closest hits and
"track_segment_ratio", the ratio tracking; "estimate_transmittance_aos",
the bent shadow walk of the atmosphere-ocean integrators),
"emitter_sample", "bsdf_eval_pdf" and "bsdf_sample" (the BSDF dispatch;
with --scene materials or polarimeter also one range per BSDF class and
method, "bsdf:<class>.<method>", so that a BSDF nested in a wrapper shows
inside its wrapper's range) and, in a polarized variant, the Mueller layer:
"phase_eval_pdf_pol" (the phase matrices of NEE and of the sampled
direction, rotated to the world), "phase_sample_pol" (the sampled
direction's weight), "bsdf_eval_pdf_pol" and "bsdf_sample_pol" (the
BSDFs' Mueller matrices), and "to_sensor_mueller" (the lanes' Stokes
vectors into the sensor frame). With --prb also "primal" (each primal
pass, or regenerative loop: the forward's, then the backward's), "replay"
(the backward's replay), "replay_segment" (each of its segments), "autograd_grad" (each
segment's vector-Jacobian product), and the phase and BSDF evaluations
made with gradients enabled (the replay's attached terms) under their
name with "_attached". Prints the wall time, the device kernel time and
busy share (kernel time over wall; the kernels of one stream do not
overlap), the kernel launches, K1's launches and time, each range's host
time, calls, the kernels launched inside it and their device time, and
the 12 kernels that take the most device time. The last line is the same as one JSON object.
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


def _kernel_us_below(ev):
    """Device time (us) of those kernels."""
    return (sum(k.duration for k in getattr(ev, "kernels", ()))
            + sum(_kernel_us_below(c) for c in ev.cpu_children))


def _ranged_attached(name, fn):
    """A range named `name`, with "_attached" where gradients are enabled."""
    def wrapper(*args, **kw):
        with record_function(name + ("_attached" if torch.is_grad_enabled() else "")):
            return fn(*args, **kw)
    return wrapper


PRB_TYPES = {"het": "prbvolpath", "vol32": "prbvolpath", "atmo": "prb", "aos": "prb_volpathaos",
             "materials": "prb", "polarimeter": "prb"}
SIGMA_T = {"het": "cloud.interior_medium.sigma_t.data",
           "vol32": "slab.interior_medium.sigma_t.value.value",
           "atmo": "atmo.sigma_t.value.value", "aos": "atmo_medium.sigma_t.value.value",
           "materials": "large-box.bsdf.alpha",
           "polarimeter": "back.bsdf.diffuse_reflectance.value"}
BSDF_METHODS = ("eval", "pdf", "sample", "sample_pol", "eval_pdf_mueller")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=tuple(PRB_TYPES), default="het")
    ap.add_argument("--regenerate", action="store_true")
    ap.add_argument("--prb", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_volpath: needs a CUDA card")
    import mitsuba_tpu_torch as mi
    from mitsuba_tpu_torch import render_api
    from mitsuba_tpu_torch.ad import prb, prb_volpathaos, prbvolpath, render_ad
    from mitsuba_tpu_torch.integrators import volpath, volpathaos
    from mitsuba_tpu_torch.render import scene as scene_mod
    from mitsuba_tpu_torch.render.scene_loader import (aos_scene, atmo_scene, het_vol_scene,
                                                       vol32_scene)

    spp_per_pass = None
    if args.scene in ("materials", "polarimeter"):
        mi.set_variant("rgb" if args.scene == "materials" else "rgb_polarized")
        make = mi.materials_scene if args.scene == "materials" else mi.polarimeter_scene
        d = make(256, 64, {"type": "path", "max_depth": 8, "regenerate": args.regenerate})
        spp = 64
        spp_per_pass = 16 if args.scene == "polarimeter" and not args.regenerate else None
        render = mi.render
    elif args.scene in ("atmo", "aos"):
        mi.set_variant("mono_polarized")
        d = atmo_scene() if args.scene == "atmo" else aos_scene(integrator="volpathaos")
        d["integrator"]["regenerate"] = args.regenerate
        spp = 64
        # the radiometer is one wavefront pass: regeneration renders the image
        render = mi.render if args.regenerate else mi.render_1
    else:
        make = het_vol_scene if args.scene == "het" else vol32_scene
        d = make(regenerate=args.regenerate)
        spp = 16
        render = mi.render
    if args.prb:
        d["integrator"]["type"] = PRB_TYPES[args.scene]
    scene = mi.load_dict(d)
    key = SIGMA_T[args.scene]

    kw = {} if spp_per_pass is None else {"spp_per_pass": spp_per_pass}

    def call(seed, stats=None):
        if not args.prb:
            # no parameter requires grad: the ranges carry no "_attached"
            with torch.no_grad():
                return render(scene, spp=spp, seed=seed, stats=stats, **kw)
        params = mi.traverse(scene)
        v = params[key].clone().requires_grad_()
        out = render(params.update({key: v}), spp=spp, seed=seed, stats=stats, **kw)
        (out.sum() if render is mi.render_1 else out.mean()).backward()
        return v.grad

    layers = ("track_segment", "track_segment_ratio", "estimate_transmittance",
              "estimate_transmittance_aos")
    scene_layers = {"ray_intersect": "ray_intersect",
                    "sample_emitter_direction": "emitter_sample",
                    "phase_eval_pdf_pol": "phase_eval_pdf_pol",
                    "phase_sample_pol": "phase_sample_pol",
                    "bsdf_eval_pdf_pol": "bsdf_eval_pdf_pol",
                    "bsdf_sample_pol": "bsdf_sample_pol",
                    "phase_eval_pdf": "phase_eval_pdf",
                    "bsdf_eval_pdf": "bsdf_eval_pdf",
                    "bsdf_sample": "bsdf_sample",
                    "ray_intersect_and_test": "ray_intersect"}
    # each module that calls a layer by its own name, and what to range there
    patches = [(m, name, _ranged(name, getattr(m, name)))
               for m in (volpath, volpathaos, prbvolpath, prb_volpathaos) for name in layers
               if hasattr(m, name)]
    patches += [(scene_mod.Scene, name, _ranged_attached(label, getattr(scene_mod.Scene, name)))
                for name, label in scene_layers.items()]
    patches += [(render_api, "to_sensor_mueller",
                 _ranged("to_sensor_mueller", render_api.to_sensor_mueller)),
                (render_ad, "_primal", _ranged("primal", render_ad._primal)),
                (prbvolpath, "vjp_into", _ranged("autograd_grad", prbvolpath.vjp_into)),
                (prbvolpath.VolumeReplay, "sample_backward",
                 _ranged("replay", prbvolpath.VolumeReplay.sample_backward)),
                (prbvolpath.VolumeReplay, "_bwd_bounce",
                 _ranged("replay_segment", prbvolpath.VolumeReplay._bwd_bounce))]
    bsdf_ranges = ()
    if args.scene in ("materials", "polarimeter"):
        # every BSDF class of the scene, wrappers' children included
        classes = {type(x) for b in scene.bsdfs
                   for x in (b, getattr(b, "nested", None), getattr(b, "bsdf_a", None),
                             getattr(b, "bsdf_b", None)) if x is not None}
        pairs = [(c, m) for c in sorted(classes, key=lambda c: c.__name__) for m in BSDF_METHODS
                 if hasattr(c, m)]
        bsdf_ranges = tuple(f"bsdf:{c.__name__}.{m}" for c, m in pairs)
        patches += [(c, m, _ranged_attached(f"bsdf:{c.__name__}.{m}", getattr(c, m)))
                    for c, m in pairs]
        patches += [(prb.PRBIntegrator, "sample_backward",
                     _ranged("replay", prb.PRBIntegrator.sample_backward)),
                    (prb, "vjp_into", _ranged("autograd_grad", prb.vjp_into))]
    if args.prb and args.regenerate:
        patches += [(volpath, "volpath_regen_render",
                     _ranged("primal", volpath.volpath_regen_render)),
                    (prbvolpath, "volumetric_regen_backward",
                     _ranged("replay", prbvolpath.volumetric_regen_backward))]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, fn in patches:
        setattr(owner, name, fn)
    try:
        call(1)                                   # warm-up: build, load, allocator
        torch.cuda.synchronize()
        stats = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            img = call(0, stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        mi.set_variant("rgb")
    assert bool(torch.isfinite(img).all())

    names = (layers + tuple(scene_layers.values())
             + tuple(v + "_attached" for v in scene_layers.values())
             + ("to_sensor_mueller", "primal", "autograd_grad", "replay", "replay_segment")
             + bsdf_ranges + tuple(r + "_attached" for r in bsdf_ranges))
    # the ranges' own device spans are not kernels: leave them out of the sums
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in names]
    total_us = sum(_device_us(e) for e in rows)
    launches = sum(e.count for e in rows)
    k1 = [e for e in rows if "tri_intersect" in e.key]
    k1_us = sum(_device_us(e) for e in k1)
    ranges, primal_calls = {}, []
    for ev in prof.events():
        if ev.name in names and ev.device_type == DeviceType.CPU:
            r = ranges.setdefault(ev.name, dict(calls=0, host_ms=0.0, kernels=0, device_ms=0.0))
            r["calls"] += 1
            r["host_ms"] += ev.cpu_time_total / 1e3
            r["kernels"] += _kernels_below(ev)
            r["device_ms"] += _kernel_us_below(ev) / 1e3
            if ev.name == "primal":
                primal_calls.append(dict(start_us=ev.time_range.start,
                                         host_ms=ev.cpu_time_total / 1e3,
                                         kernels=_kernels_below(ev),
                                         device_ms=_kernel_us_below(ev) / 1e3))
    # the forward's primal first, then the backward's
    primal_calls.sort(key=lambda c: c.pop("start_us"))
    film = scene.film
    out = dict(
        device=torch.cuda.get_device_name(0), scene=args.scene, regenerate=args.regenerate,
        prb=args.prb, integrator=type(scene.integrator).__name__,
        res=f"{film.width}x{film.height}", spp=spp, lanes=film.n_pixels * spp, wall_ms=wall * 1e3,
        n_rays=stats["n_rays"], n_rays_grad=stats.get("n_rays_grad"),
        wavefront_iters=stats.get("wavefront_iters"),
        device_ms=total_us / 1e3, busy_share=total_us / 1e3 / (wall * 1e3), launches=launches,
        k1_launches=sum(e.count for e in k1), k1_ms=k1_us / 1e3, ranges=ranges,
        primal_calls=primal_calls,
        top=[dict(kernel=e.key[:90], count=e.count, ms=_device_us(e) / 1e3)
             for e in sorted(rows, key=_device_us, reverse=True)[:TOP]],
    )
    print(f"{out['device']}: {args.scene} {out['res']} @ {spp} spp, {out['integrator']}, "
          f"regenerate {args.regenerate}, PRB step {args.prb}, profiled wall {wall * 1e3:.1f} "
          f"ms, {stats['n_rays']} rays (backward {out['n_rays_grad']}), wavefront iterations "
          f"{out['wavefront_iters']}")
    print(f"device kernel time {out['device_ms']:.1f} ms over {launches} launches (busy share "
          f"{out['busy_share']:.1%}, mean {total_us / max(launches, 1):.2f} us per launch)")
    print(f"K1 tri_intersect: {out['k1_launches']} launches, {out['k1_ms']:.3f} ms "
          f"({k1_us / max(total_us, 1):.2%} of device time)")
    for i, c in enumerate(primal_calls):
        print(f"primal pass {i} ({'forward' if i == 0 else 'backward'}): host "
              f"{c['host_ms']:.1f} ms, kernels {c['kernels']}, device {c['device_ms']:.1f} ms")
    for name, r in ranges.items():
        print(f"range {name:<24} calls {r['calls']:>6} host {r['host_ms']:>9.1f} ms "
              f"kernels {r['kernels']:>8} device {r['device_ms']:>8.1f} ms")
    for t in out["top"]:
        print(f"{t['kernel']:<90} {t['count']:>7} {t['ms']:>9.3f} ms")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
