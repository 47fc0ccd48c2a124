"""Hold the port's rgb, mono and polarized renders and gradients on the CPU
bit for bit against those of another commit's port: the guard for a change
that threads a new argument (the spectral variants' wavelengths) through the
evaluation surface and must leave every other variant as it was.

Eleven cases, each at a small size, one intra-op thread:
- rgb: the Cornell box (path, 16x16 @ 4 spp); its prb gradient of the image
  mean for white.reflectance.value (max_depth 6, 2 spp); the heterogeneous
  volume (volpath, 8x8 @ 2 spp); the deep slab with regeneration (volpath)
  and its regenerative prbvolpath gradient for the albedo; the materials
  scene with path and with direct (8x8 @ 4 spp);
- mono_polarized: BASELINE config 4's Stokes vector (render_1, 4x4 @ 8 spp);
  the ocean's prb_volpathaos gradient of render_1 for the atmosphere's
  sigma_t (4x4 @ 4 spp);
- rgb_polarized: the polarimeter scene (8x8 @ 4 spp);
- mono: the Cornell box (16x16 @ 4 spp).

Unpacks `git archive REV` into build/bitwise/<REV>, runs the cases once
against that tree and once against this checkout's working tree (each in a
process of its own), writes each side's tensors to build/bitwise/, prints
one line per case (equal, or the largest difference) and exits 1 if one
case differs. Run from anywhere, ~1 minute on the CPU:

    python3 scripts/torch_bitwise_vs_parent.py HEAD~1
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "bitwise")


def cases(mt):
    """{name: tensor} of the eleven cases, rendered by the package mt."""
    import torch
    from mitsuba_tpu_torch.render.scene_loader import het_vol_scene, vol32_scene

    def cbox(res=16, integ=None):
        d = mt.cornell_box()
        d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = res
        if integ:
            d["integrator"] = integ
        return d

    def grad(d, key, render, spp):
        p = mt.traverse(mt.load_dict(d, device="cpu"))
        v = p[key].clone().requires_grad_()
        out = render(p.update({key: v}), spp=spp, seed=0)
        (out.mean() if out.ndim > 2 else out.sum()).backward()
        return v.grad

    out = {}
    mt.set_variant("rgb")
    out["rgb cbox path"] = mt.render(mt.load_dict(cbox(), device="cpu"), spp=4)
    out["rgb cbox prb gradient"] = grad(cbox(integ={"type": "prb", "max_depth": 6}),
                                        "white.reflectance.value", mt.render, 2)
    out["rgb het-vol volpath"] = mt.render(
        mt.load_dict(het_vol_scene(res=8, spp=2), device="cpu"), spp=2)
    out["rgb vol32 regenerative volpath"] = mt.render(
        mt.load_dict(vol32_scene(res=8, spp=2, max_depth=6, regenerate=True), device="cpu"),
        spp=2)
    d = vol32_scene(res=8, spp=2, max_depth=6, regenerate=True)
    d["integrator"]["type"] = "prbvolpath"
    out["rgb vol32 regenerative prbvolpath gradient"] = grad(
        d, "slab.interior_medium.albedo.value.value", mt.render, 2)
    out["rgb materials path"] = mt.render(mt.load_dict(mt.materials_scene(8, 4), device="cpu"),
                                          spp=4)
    out["rgb materials direct"] = mt.render(
        mt.load_dict(mt.materials_scene(8, 4, {"type": "direct"}), device="cpu"), spp=4)
    mt.set_variant("mono_polarized")
    out["mono_polarized atmo render_1"] = mt.render_1(
        mt.load_dict(mt.atmo_scene(res=4, spp=8), device="cpu"), spp=8)
    out["mono_polarized aos prb_volpathaos gradient"] = grad(
        mt.aos_scene(res=4), "atmo_medium.sigma_t.value.value", mt.render_1, 4)
    mt.set_variant("rgb_polarized")
    out["rgb_polarized polarimeter"] = mt.render(
        mt.load_dict(mt.polarimeter_scene(8, 4), device="cpu"), spp=4)
    mt.set_variant("mono")
    out["mono cbox path"] = mt.render(mt.load_dict(cbox(), device="cpu"), spp=4)
    mt.set_variant("rgb")
    return {k: v.detach().clone() for k, v in out.items()}


def worker(tree, path):
    """Render the cases with the port of `tree` and save them to `path`."""
    sys.path.insert(0, tree)
    import torch
    import mitsuba_tpu_torch as mt

    src = os.path.dirname(os.path.abspath(mt.__file__))
    if os.path.dirname(src) != os.path.abspath(tree):
        raise SystemExit(f"imported {src}, not the port of {tree}")
    torch.set_num_threads(1)
    torch.save(cases(mt), path)


def main(rev):
    import torch

    tree = os.path.join(OUT, rev.replace("/", "_").replace("~", "-").replace("^", "-"))
    subprocess.run(["rm", "-rf", tree], check=True)
    os.makedirs(tree)
    archive = subprocess.run(["git", "-C", ROOT, "archive", rev], check=True,
                             capture_output=True).stdout
    subprocess.run(["tar", "-x", "-C", tree], input=archive, check=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    saved = {}
    for name, src in (("rev", tree), ("work", ROOT)):
        saved[name] = os.path.join(OUT, f"{name}.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", src,
                        saved[name]], check=True, env=env, cwd=OUT)
    old, new = torch.load(saved["rev"]), torch.load(saved["work"])
    differing = 0
    for k in old:
        a, b = old[k], new[k]
        same = a.shape == b.shape and torch.equal(a, b)
        differing += not same
        what = ("equal" if same else f"differs: shapes {tuple(a.shape)} {tuple(b.shape)}"
                if a.shape != b.shape else f"differs by {float((a - b).abs().max()):.3e}")
        print(f"{k} {tuple(b.shape)}: {what}")
    print(f"{len(old) - differing} of {len(old)} cases bit for bit {rev}'s")
    return 1 if differing else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "HEAD"))
