"""Hold the projective gradients of mitsuba_tpu_torch against central
differences, pass by pass: what chip_smoke.py's projective phase runs
once, swept, to tell an estimator's noise from its bias. Each case is the
derivative of sum(image) for a uniform scale of a shape
(chip_smoke.scale_offset), AD against FD (eps 1e-2) at the same seed.

    python3 scripts/torch_projective_fd.py cbox [--sppi 4,64,256] [--seeds 6]
        the Cornell box at 256x256, prb_projective max_depth 4, sppp 4, the
        small box: AD at 64 spp over seeds 7, 11, 13, ... at each sppi; FD
        at 256 spp (seeds 7, 11) and 1024 (seed 7); the interior term
        alone (sppp = sppi = 0) and with the primary silhouettes (sppi 0)
    python3 scripts/torch_projective_fd.py crease
        the missing crease term: the Cornell box's floor and small box
        alone at 64x64 (box filter), direct_projective, a point light at
        the camera (no shadow moves): AD and FD of the image summed over
        the pixels inside the box's image, two pixels away from every
        silhouette, where only the interior term and the boxes' creases act
    python3 scripts/torch_projective_fd.py cube
        tests/test_projective.py's silhouette scene with a flat cube for the
        occluder (24x24, direct_projective sppp 16): AD at 64 spp (seeds 7,
        11) against FD at 512

`--unwelded` rebuilds the edge tables by vertex index, as the JAX
package keys them (``edge_table(..., weld_vertices=False)``), so that each
edge of a cube is two open ones.

On the card by default (`--device cpu` for the CPU, at the same sizes: the
cbox sweep takes hours there). Prints the device (and the card's name and
power limit) and one JSON line per case.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import mitsuba_tpu_torch as mi  # noqa: E402
from mitsuba_tpu_torch.render import shapes  # noqa: E402


def emit(case, **out):
    print(json.dumps({"case": case, **out}), flush=True)


def load(d, device, unwelded):
    """The scene of dict d, its edge tables keyed by vertex index where
    `unwelded`."""
    scene = mi.load_dict(d, device=device)
    if not unwelded:
        return scene
    g = scene.geometry
    T = g.n_real_tris
    tables = shapes.edge_table(g.tri_face[:T].cpu().numpy(), g.tri_shape[:T].cpu().numpy(),
                               g.vertices.detach().cpu().numpy(), weld_vertices=False)
    fields = dict(zip(("edge_v", "edge_f", "edge_shape", "edge_fv"),
                      (torch.from_numpy(x).to(g.vertices.device) for x in tables)))
    return dataclasses.replace(scene, geometry=dataclasses.replace(g, **fields))


def cbox(device, sppi_list, n_seeds, unwelded):
    d, key, spp, fd_spp = cs.projective_scenes(mi)["cbox"]
    seeds = [7, 11, 13, 17, 19, 23, 29, 31][:n_seeds]
    for sppi in sppi_list:
        d["integrator"] = dict(d["integrator"], sppi=sppi)
        scene = load(d, device, unwelded)
        ads = [cs.projective_ad(mi, scene, key, spp, s) for s in seeds]
        emit("cbox", unwelded=unwelded, sppi=sppi, seeds=seeds, ad=ads,
             ad_mean=sum(ads) / len(ads))
    scene = mi.load_dict(d, device=device)
    emit("cbox", fd_spp=fd_spp, fd=[cs.projective_fd(mi, scene, key, fd_spp, s) for s in (7, 11)])
    emit("cbox", fd_spp=4 * fd_spp, fd=[cs.projective_fd(mi, scene, key, 4 * fd_spp, 7)])
    for sppp, sppi in ((0, 0), (4, 0)):
        d["integrator"] = dict(d["integrator"], sppp=sppp, sppi=sppi)
        scene = load(d, device, unwelded)
        emit("cbox", unwelded=unwelded, sppp=sppp, sppi=sppi,
             ad=[cs.projective_ad(mi, scene, key, spp, s) for s in seeds[:2]])


def crease_scene(device, emissive):
    d, key, _, _ = cs.projective_scenes(mi)["cbox"]
    d["sensor"]["film"].update(width=64, height=64, rfilter={"type": "box"})
    for name in ("large-box", "back", "green-wall", "red-wall", "ceiling", "light"):
        del d[name]
    if emissive:
        black = {"type": "diffuse", "reflectance": 0.0}
        d["floor"].update(bsdf=black, emitter={"type": "area", "radiance": 1.0})
        d["small-box"].update(bsdf=black, emitter={"type": "area", "radiance": 3.0})
    else:
        d["lamp"] = {"type": "point", "position": [0, 0.05, 3.8], "intensity": 3.0}
    d["integrator"] = {"type": "direct_projective", "sppp": 16, "sppi": 16}
    return mi.load_dict(d, device=device), key


def crease(device):
    # the box's pixels: where the emissive box outshines the emissive floor,
    # eroded by two pixels
    se, _ = crease_scene(device, True)
    mask = (mi.render(se, spp=4, seed=0, integrator=se.integrator.base)[..., 0] > 2.0).float()
    for _ in range(2):
        mask = mask * torch.roll(mask, 1, 0) * torch.roll(mask, -1, 0) \
            * torch.roll(mask, 1, 1) * torch.roll(mask, -1, 1)
    scene, key = crease_scene(device, False)
    base, off = cs.scale_offset(mi, scene, key)

    def masked(s, spp, seed, integrator=None):
        sc = mi.traverse(scene).update({key: base + s * off})
        return (mi.render(sc, spp=spp, seed=seed, integrator=integrator) * mask[..., None]).sum()

    eps = cs.PROJ_FD_EPS
    fd = (float(masked(eps, 128, 7, scene.integrator.base))
          - float(masked(-eps, 128, 7, scene.integrator.base))) / (2 * eps)
    ads = []
    for seed in (7, 11):
        t = torch.zeros((), device=base.device, requires_grad=True)
        sc = mi.traverse(scene).update({key: base + t * off})
        (mi.render(sc, spp=16, seed=seed) * mask[..., None]).sum().backward()
        ads.append(float(t.grad))
    emit("crease", pixels=int(mask.sum()), fd=fd, ad=ads)


def cube(device, unwelded):
    d, key, spp, fd_spp = cs.projective_scenes(mi)["cube"]
    scene = load(d, device, unwelded)
    emit("cube", unwelded=unwelded, open_edges=int((scene.geometry.edge_f[:, 1] < 0).sum()),
         fd=cs.projective_fd(mi, scene, key, fd_spp, 7),
         ad=[cs.projective_ad(mi, scene, key, spp, s) for s in (7, 11)])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", choices=("cbox", "crease", "cube"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sppi", default="4,64,256")
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--unwelded", action="store_true")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("torch_projective_fd: no CUDA device (pass --device cpu for the CPU)")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"device: {torch.cuda.get_device_name(0)}; {smi.stdout.strip()}", flush=True)
    else:
        torch.set_num_threads(min(8, os.cpu_count() or 1))
        print(f"device: {device} (the CPU: no device time)", flush=True)
    t0 = time.perf_counter()
    if args.case == "cbox":
        cbox(device, [int(x) for x in args.sppi.split(",")], args.seeds, args.unwelded)
    elif args.case == "crease":
        crease(device)
    else:
        cube(device, args.unwelded)
    print(f"seconds: {time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
