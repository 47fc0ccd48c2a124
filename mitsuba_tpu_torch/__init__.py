"""mitsuba_tpu_torch: the PyTorch/CUDA port of mitsuba_tpu for NVIDIA Hopper.

Module paths mirror the JAX package's, so each module has its counterpart
there. The package imports torch and numpy, never jax, flax or mitsuba_tpu.
Hot loops that the JAX package wrote as Pallas kernels for the TPU are CUDA
kernels written by hand (``csrc/``), built with nvcc at first use.

Entry points run on the card unless the caller names another device:

    import mitsuba_tpu_torch as mi
    mi.set_variant("llvm_ad_rgb")
    scene = mi.load_dict(mi.cornell_box())          # on "cuda"
    img = mi.render(scene, spp=64)                  # [H, W, 3] on scene.device

The polarized Rayleigh + Mie atmosphere (BASELINE config 4) as a radiometer:

    mi.set_variant("mono_polarized")
    stokes = mi.render_1(mi.load_dict(mi.atmo_scene()), spp=64)   # [4, 1]

Glass, metal, plastic and polarization optics (a polarizer and a
quarter-wave plate in front of the camera), seen as Stokes images:

    mi.set_variant("rgb_polarized")
    img = mi.render(mi.load_dict(mi.polarimeter_scene()), spp=64)   # [H, W, 4, 3]

The spectral variants: four hero wavelengths a lane, rgb data upsampled
by the rgb2spec model, each lane's spectrum contracted to linear sRGB (or
a specfilm's response functions); BASELINE config 4 as BASELINE names it:

    mi.set_variant("spectral_polarized")
    stokes = mi.render_1(mi.load_dict(mi.atmo_scene()), spp=64)   # [4, 4] raw

The material preview: analytic spheres under an envmap, through a lens:

    img = mi.render(mi.load_dict(mi.spheres_scene()), spp=64)

Gradients: write a parameter that requires grad and call backward, through
the path integrator's tape or the PRB integrators' replay; BASELINE config
5's retrieval gradient, the atmosphere's extinction seen through a rough
ocean surface:

    mi.set_variant("mono_polarized")
    params = mi.traverse(mi.load_dict(mi.aos_scene()))       # prb_volpathaos
    v = params["atmo_medium.sigma_t.value.value"].clone().requires_grad_()
    mi.render_1(params.update({"atmo_medium.sigma_t.value.value": v}), spp=64).sum().backward()

    params = mi.traverse(scene)
    v = params["white.reflectance.value"].clone().requires_grad_()
    mi.render(params.update({"white.reflectance.value": v}), spp=64).mean().backward()
"""
from .variant import set_variant, variant, variants, current_variant, Variant
from .core.rng import RNG
from .core.transform import Transform, build_transform
from .render.scene_loader import (load_dict, cornell_box, atmo_scene, aos_scene, materials_scene,
                                  polarimeter_scene, spheres_scene, manylights_scene,
                                  projector_scene)
from .render.params import traverse, SceneParameters
from .render_api import (CancelToken, render, render_1, render_forward, render_progressive,
                         render_test)
from . import ad

__version__ = "0.1.0"
