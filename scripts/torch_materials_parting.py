"""Where the port on the CPU parts from the JAX package on the materials
scene's PRB step at max_depth 8 (64x64 @ 16 spp, the gradients of the
image mean for the rough conductor's alpha and the blend's weight).

Prints, as one JSON line:
- the port's gradients on the CPU, and the JAX package's through jax.jit
  (XLA contracts products into FMAs there);
- the lanes of the backward pass's primal (seed_grad of seed 0) whose
  radiance parts (beyond rtol 1e-4, atol 1e-5) between the port and the
  JAX package run op by op (jax.disable_jit), with PyTorch's own
  transcendental functions and with each of them rounded correctly
  (evaluated in float64): how many, and the first few lane indices.

The JAX package's op-by-op gradient takes ~13 minutes on the CPU and is
quoted in chip_smoke.py (JAX_MATERIALS_PRB64_DEPTH4_GRAD's comment), not
recomputed here. Run on the CPU, ~3 minutes:

    JAX_PLATFORMS=cpu python3 scripts/torch_materials_parting.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

KEYS = ["large-box.bsdf.alpha", "floor.bsdf.weight.value"]
RES, SPP, DEPTH = 64, 16, 8
FUNCS = ("sqrt", "rsqrt", "exp", "log", "sin", "cos", "acos", "asin", "atan2", "atan", "tan",
         "log1p", "expm1")


def port_grads(mt):
    p = mt.traverse(mt.load_dict(mt.materials_scene(RES, SPP, {"type": "prb",
                                                                "max_depth": DEPTH}),
                                 device="cpu"))
    vals = {k: p[k].detach().clone().requires_grad_() for k in KEYS}
    mt.render(p.update(vals), spp=SPP, seed=0).mean().backward()
    return [float(vals[k].grad) for k in KEYS]


def jax_jit_grads(mj, mt):
    import jax
    import jax.numpy as jnp

    js = mj.load_dict(mt.materials_scene(RES, SPP, {"type": "prb", "max_depth": DEPTH}))

    def loss(v):
        return jnp.mean(mj.render(mj.traverse(js).update(dict(zip(KEYS, v))), spp=SPP, seed=0))

    g = jax.jit(jax.grad(loss))(tuple(mj.traverse(js)[k] for k in KEYS))
    return [float(np.asarray(x).reshape(-1)[0]) for x in g]


def port_lanes(mt, seed, rounded=()):
    """The port's lanes, with the functions in `rounded` evaluated in
    float64 and rounded once to float32."""
    from mitsuba_tpu_torch.render_api import render_lanes

    saved = {name: getattr(torch, name) for name in rounded}
    for name, f in saved.items():
        setattr(torch, name, lambda x, *a, f=f, **k: f(x.double(), *a, **k).float()
                if torch.is_tensor(x) and x.dtype == torch.float32 else f(x, *a, **k))
    try:
        ts = mt.load_dict(mt.materials_scene(RES, SPP, {"type": "prb", "max_depth": DEPTH}),
                          device="cpu")
        return render_lanes(ts, seed, 0, RES * RES * SPP, 0, SPP, SPP, 0)[0].numpy()
    finally:
        for name, f in saved.items():
            setattr(torch, name, f)


def main():
    import jax
    import jax.numpy as jnp
    import mitsuba_tpu as mj
    from mitsuba_tpu.render_api import render_lanes as j_render_lanes

    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.ad.render_ad import derive_seed_grad

    torch.set_num_threads(1)
    out = {"port_grads": port_grads(mt), "jax_jit_grads": jax_jit_grads(mj, mt)}
    seed = derive_seed_grad(0)
    js = mj.load_dict(mt.materials_scene(RES, SPP, {"type": "prb", "max_depth": DEPTH}))
    with jax.disable_jit():
        Lj = np.asarray(j_render_lanes(js, jnp.uint32(seed), 0, RES * RES * SPP, 0, SPP, SPP,
                                       0)[0])
    for name, rounded in (("pytorch", ()), ("sin", ("sin",)), ("all", FUNCS)):
        Lt = port_lanes(mt, seed, rounded)
        parts = np.nonzero(~np.isclose(Lt, Lj, rtol=1e-4, atol=1e-5).all(-1))[0]
        out[f"lanes_parting_{name}"] = {"count": int(parts.size), "of": int(Lt.shape[0]),
                                        "first": parts[:8].tolist()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
