"""The JAX package's values that chip_smoke.py holds the material-preview
phases to (spheres, spheres-prb, manylights, sensors, spheres-mesh),
computed with mitsuba_tpu on the CPU, and the pixels of the spheres scene
whose lanes part between the two packages.

Prints one JSON object (and writes it to build/slice13_constants.json):
- spheres: spheres_scene(64, 16) (path max_depth 8, mitchell) at seed 0:
  the lanes of the JAX package run op by op (jax.disable_jit(), so that
  XLA fuses nothing) against the port's on the CPU (rtol 1e-4, atol
  1e-5); "parting" the row-major pixels within the filter's radius (2) of
  a parting lane's pixel, whose develop the lane reaches; "kept_means"
  the JAX package's developed image's means over the other pixels, and
  "means" over all of them;
- spheres_prb: the image mean's gradient for the envmap's data (its sum,
  and its 8 largest texels by magnitude, flat indices) and for the diffuse
  sphere's reflectance, spheres_scene(64, 16) with prb max_depth 4, seed
  0, through jax.jit(jax.value_and_grad);
- manylights: the 64x64 @ 16 spp means of manylights_scene with path
  (max_depth 8) and with ptracer (max_depth 8), and of the ptracer with
  the collimated panel (beam=True), through jax.jit;
- orthographic: the cbox seen by an orthographic sensor, 64x64 @ 16 spp;
  batch: render_test of two perspectives side by side (two 64x64 views @
  16 spp); projector: projector_scene(64, 16) means;
- atmo_distant, atmo_irradiancemeter: in mono_polarized, render_1 of
  atmo_scene(32, 64) with its radiancemeter replaced by a distant sensor
  (direction (0.2, 0, -1), target (0, 0, 0)) and by an irradiancemeter at
  (0, 0, -1.5) looking up: the Stokes vectors [4, 1];
- spheres_mesh: mesh_scene(k=130, res=64) with an analytic sphere and the
  envmap, 64x64 @ 4 spp means (the BVH's plain walk on the CPU).

The dicts are chip_smoke.py's (its spheres_mesh_dict, sensor dicts). Run
on the CPU, ~10 minutes:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_backend_optimization_level=1 \\
        python3 scripts/torch_slice13_constants.py
"""
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch

import chip_smoke as cs

RES, SPP = 64, 16


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parting_pixels(mj, mt, d):
    """(parting pixels, JAX image means over the others, JAX image means)
    of the dict at seed 0, one pass of SPP."""
    import jax
    import jax.numpy as jnp
    from mitsuba_tpu.render.film import develop
    from mitsuba_tpu.render_api import render_lanes as j_render_lanes
    from mitsuba_tpu_torch.render_api import render_lanes as t_render_lanes

    js, ts = mj.load_dict(d), mt.load_dict(d, device="cpu")
    n = RES * RES * SPP
    with jax.disable_jit():
        Lj, _, _, aux = j_render_lanes(js, jnp.uint32(0), 0, n, 0, SPP, SPP, 0)
        img = np.asarray(develop(js.film, Lj, SPP, jitter=aux["film_jitter"]))
    Lt = t_render_lanes(ts, 0, 0, n, 0, SPP, SPP, 0)[0].numpy()
    bad = ~np.isclose(Lt, np.asarray(Lj), rtol=1e-4, atol=1e-5).all(-1)
    bad_px = np.zeros((RES, RES), bool)
    for p in np.unique(np.nonzero(bad)[0] // SPP):
        y, x = divmod(int(p), RES)
        bad_px[max(y - 2, 0):y + 3, max(x - 2, 0):x + 3] = True
    keep = ~bad_px.reshape(-1)
    log(f"spheres: {int(bad.sum())} parting lanes, {int(bad_px.sum())} pixels set aside")
    flat = img.reshape(RES * RES, -1)
    return (np.nonzero(~keep)[0].tolist(), flat[keep].mean(0).tolist(),
            flat.mean(0).tolist())


def main():
    torch.set_num_threads(1)
    import jax
    import jax.numpy as jnp
    import mitsuba_tpu as mj
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu.render_api import _ptracer_pass

    out = {}
    mj.set_variant("rgb")
    mt.set_variant("rgb")
    t0 = time.time()
    parting, kept, means = parting_pixels(mj, mt, mt.spheres_scene(RES, SPP))
    out["spheres"] = dict(parting=parting, kept_means=kept, means=means)
    log(f"spheres {time.time() - t0:.1f} s")

    t0 = time.time()
    keys = list(cs.SPHERES_PRB_KEYS)
    js = mj.load_dict(mt.spheres_scene(RES, SPP, {"type": "prb", "max_depth": 4}))

    def loss(v):
        return jnp.mean(mj.render(mj.traverse(js).update(dict(zip(keys, v))), spp=SPP, seed=0))

    pj = mj.traverse(js)
    val, g = jax.jit(jax.value_and_grad(loss))(tuple(pj[k] for k in keys))
    g_env = np.asarray(g[0]).reshape(-1)
    top = np.argsort(-np.abs(g_env))[:8]
    out["spheres_prb"] = dict(loss=float(val), env_sum=float(g_env.astype(np.float64).sum()),
                              env_top=[[int(i), float(g_env[i])] for i in top],
                              reflectance=np.asarray(g[1]).tolist())
    log(f"spheres_prb {time.time() - t0:.1f} s")

    def jit_means(d):
        s = mj.load_dict(d)
        return np.asarray(jax.jit(lambda: mj.render(s, spp=SPP, seed=0))()).mean(
            axis=(0, 1)).tolist()

    t0 = time.time()
    out["manylights"] = dict(
        path=jit_means(mt.manylights_scene(RES, SPP)),
        ptracer=np.asarray(_ptracer_pass(mj.load_dict(mt.manylights_scene(
            RES, SPP, cs.PTRACER_INTEGRATOR)), jnp.uint32(0), SPP, 0)).mean(axis=(0, 1)).tolist(),
        ptracer_beam=np.asarray(_ptracer_pass(mj.load_dict(mt.manylights_scene(
            RES, SPP, cs.PTRACER_INTEGRATOR, beam=True)), jnp.uint32(0), SPP, 0)).mean(
            axis=(0, 1)).tolist())
    out["orthographic"] = jit_means(cs.orthographic_dict(mt, RES, SPP))
    out["projector"] = jit_means(mt.projector_scene(RES, SPP))
    bs = mj.load_dict(cs.batch_dict(mt, RES, SPP))
    out["batch"] = np.asarray(mj.render_test(bs, spp=SPP, seed=0, sensor_count=2)).tolist()
    log(f"manylights, sensors {time.time() - t0:.1f} s")

    t0 = time.time()
    mj.set_variant("mono_polarized")
    for name in ("distant", "irradiancemeter"):
        s = mj.load_dict(cs.atmo_sensor_dict(mt, name))
        out[f"atmo_{name}"] = np.asarray(jax.jit(
            lambda: mj.render_1(s, spp=cs.ATMO_SENSOR_SPP, seed=0))()).tolist()
    mj.set_variant("rgb")
    log(f"atmo sensors {time.time() - t0:.1f} s")

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        s = mj.load_dict(cs.spheres_mesh_dict(mt, os.path.join(tmp, "s.obj"), RES))
        out["spheres_mesh"] = np.asarray(mj.render(s, spp=4, seed=0)).mean(axis=(0, 1)).tolist()
    log(f"spheres_mesh {time.time() - t0:.1f} s")

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "slice13_constants.json"), "w") as f:
        json.dump(out, f)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
