"""Smoke test of mitsuba_tpu_torch on one CUDA card.

Builds every hand-written kernel of the port from the sources in this
checkout (all nvcc and g++ builds started together), holds each against
its plain PyTorch version on the card, drives the main paths through the
user entry points, and checks that each went through its kernels:

- the Cornell box, 256x256 @ 64 spp, path tracer, max_depth 8: kernel K1
  (closest hit over a triangle table);
- the large-mesh scene (the Cornell box holding a 202,800-triangle sphere,
  256x256 @ 16 spp): kernel K2, closest hit and any hit over a BVH;
- the Cornell box's PRB gradient step, 256x256 @ 64 spp, max_depth 8, the
  gradient of white.reflectance.value for the image mean: kernel K1, then
  again with intersector="mma": kernel K3 (the closest hit with every
  determinant from the tensor cores); the 64x64 gradient against the JAX
  package's, and ten Adam steps at 16x16;
- kernel K4, the device-memory copy probe, swept over its configurations;
- participating media (BASELINE config 3, bench.py's het_vol_fwd_mrays
  scene): volpath over a 32^3 heterogeneous grid in a null cube under a
  constant environment, 96x96 @ 16 spp, max_depth 12: kernel K1 on every
  segment and NEE crossing; its means against the JAX package's, the
  same dict with path regeneration against it, and the 32x32 render
  through K1 against the same render through the plain version, bitwise;
- bench.py's vol32_regen_speedup scene (a homogeneous slab, 128x128 @ 16
  spp, volpath max_depth 32), rendered as a wavefront and with path
  regeneration, the two images held together and their times compared;
- the polarized Rayleigh + Mie atmosphere (BASELINE config 4, bench.py's
  atmo_msamples scene) in the mono_polarized variant: render_1 of a
  radiancemeter's 64x64 film @ 64 spp in one pass (262,144 lanes), volpath
  max_depth 8 under a directional sun, the Mie phase baked on the card
  (held against the same bake on the CPU): kernel K1 on every segment and
  NEE crossing of the null slab; the Stokes vector against the JAX
  package's, and every K1 launch of one pass against the plain version,
  bitwise;
- inverse radiative transfer, each a PRB gradient step timed (one warm-up
  and two timed steps), its gradient against the JAX package's, every K1
  launch of one step held bit for bit against the plain version, and a
  reduced step through K1 against the same step through the plain
  version: BASELINE config 5 (bench.py's aos scene: a rough-dielectric
  ocean under a Rayleigh atmosphere and a directional sun), the gradient
  of sum(render_1) at 32x32 @ 64 spp for the atmosphere's sigma_t through
  prb_volpathaos in mono_polarized, with volpathaos's Stokes vector of the
  same dict; the polarized atmosphere above through prb_polarized
  (sigma_t and albedo); and the het-vol scene through prbvolpath (the
  32^3 grid's sigma_t and the albedo of the image mean);
- regenerative inverse rendering: bench.py's vol32 dict with prbvolpath
  and regenerate (128x128 @ 16 spp, max_depth 32), the gradient of the
  image mean for the slab's sigma_t and albedo (one warm-up step with
  every K1 launch held bit for bit against the plain version, one timed
  step: the iterations and K1 launches of the forward, the backward primal
  and the replay), its gradients within 1e-3 of the same dict's wavefront
  prbvolpath step and its image within the regeneration tolerance; reduced
  regenerative steps against their wavefront steps (the cbox with prb, the
  polarized Rayleigh slab with volpath and prb_polarized, config 5's
  ocean with prb_volpathaos);
- the rest of render() on the cbox at 256x256 @ 64 spp: the integrator
  override, CancelToken, timeout and render_progressive, each bitwise
  against the render it must equal;
- surface materials and polarization optics, through K1: the materials
  scene (render/scene_loader.py:materials_scene: a gold rough conductor,
  bk7 glass, a two-sided rough plastic, a diffuse/silver blend and a mask
  in the Cornell box) at 256x256 @ 64 spp, path max_depth 8, with every K1
  launch of one render held bit for bit against the plain version and its
  64x64 @ 16 spp means against the JAX package's; its PRB step (prb,
  256x256 @ 64 spp) for the conductor's alpha and the blend's weight, the
  64x64 @ 16 spp gradients against the JAX package's; the polarimeter
  (polarimeter_scene: polarized plastic and smooth gold seen through a
  linear polarizer and a quarter-wave plate) in rgb_polarized, stokes over
  volpath at 256x256 @ 64 spp, every K1 launch of one render held bit for
  bit, its 64x64 @ 16 spp Stokes means against the JAX package's and its
  optics checked (DoLP behind the polarizer, V behind the retarder); its
  PRB step (prb_polarized, reduced to 64x64 @ 16 spp) for the plastic's
  diffuse reflectance; and the direct, depth, aov and moment integrators
  on the materials scene at 256x256 @ 64 spp;
- the last integrators and the visibility gradients, through K1: the
  particle tracer (ptracer) on the cbox at 256x256 @ 64 spp (4,194,304
  particles, max_depth 8), its mean below the light held against path's;
  volpathmis on the het-vol configuration (96x96 @ 16 spp), its means
  against volpath's, and tests/test_volpathmis.py's furnace; the
  projective gradients (prb_projective on the cbox at 256x256, max_depth 4,
  the small box scaled; direct_projective on tests/test_projective.py's
  silhouette and point-shadow scenes and on a flat cube), each held
  against central differences, the flat cube's one vertex copy against a
  one-sided difference, with every K1 launch of an AD step bitwise against
  the plain version and every K1 backward (hit_vjp) against torch.func.vjp
  of the plain Moller-Trumbore; and the two physics golds
  (tests/test_rayleigh_slab_gold.py in mono_polarized at 16,384 spp,
  tests/test_chandrasekhar_gold.py in mono at 8,192 spp), each within its
  test's bound;
- the material preview and the new emitters and sensors: spheres_scene
  (three analytic spheres, a sphere light, a spot, an envmap, a thin lens,
  a mitchell filter) at 256x256 @ 64 spp through K1 and the sphere pass,
  every K1 launch of one render held bit for bit, a crop window bit for
  bit the full render's window, the 64x64 @ 16 spp means against the JAX
  package's; its prb step (the envmap's data and a sphere's reflectance),
  the 64x64 gradients at max_depth 4 against the JAX package's; the cbox
  lit by 8 fused panels through path and ptracer (and a collimated
  panel); the orthographic, batch (render_test), distant and
  irradiancemeter (over config 4's atmosphere) sensors and the projector;
  and the large mesh with an analytic sphere and the envmap through K2,
  every K2 launch of one render held bit for bit against the plain walk.

Any failure raises and exits non-zero.

    python3 chip_smoke.py

Prints, before the last line, the card's name and power limit and one JSON
line {"kernels": [...]} with each kernel's launches on its main path, its
error against the plain version, its time, the plain version's time and
its lower bound on this card; for K1 and K3 also the launches of one PRB
step, for K2 those of one mesh pass, their summed time (CUDA events around
each launch) and their summed bounds, each computed from that launch's
own inputs. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# Per-channel means of the JAX package's image of the same configuration
# (mi.cornell_box() at 256x256, spp=64, seed=0; spp_per_pass=4, which the
# JAX package's RNG keying makes equal to one pass), computed once with
# mitsuba_tpu on the CPU.
JAX_CBOX_MEANS = (0.2402133047580719, 0.14114509522914886, 0.059986136853694916)
# Per-channel means of the JAX package's image of the mesh scene
# (scripts/bench_mesh.py:mesh_scene, the OBJ written as there) at 64x64,
# spp=16, seed=0, one pass, computed once with mitsuba_tpu on the CPU:
# mi.render(mi.load_dict(d), spp=16, seed=0).mean(axis=(0, 1)) with d that
# scene's dict at res=64 (98 s). The full 256x256 render is too slow for
# XLA's while-loop traversal on the CPU.
JAX_MESH64_MEANS = (0.22338911890983582, 0.13317768275737762, 0.057030607014894485)
# The JAX package's PRB gradient of white.reflectance.value for the image
# mean of the Cornell box at 64x64, spp=16, seed=0, prb with max_depth 8,
# computed once with mitsuba_tpu on the CPU:
# jax.grad(lambda v: mi.render(_tree_set(scene, path, v), spp=16, seed=0).mean())
# with `path` the parameter's path in scene.param_paths (6.8 s).
JAX_PRB64_GRAD = (0.09090301394462585, 0.04229336231946945, 0.015745891258120537)
PRB64_GRAD_RTOL = 0.01
# Per-channel means of the JAX package's image of bench.py's heterogeneous
# volume (render/scene_loader.py:het_vol_scene: 96x96, spp=16, seed=0,
# volpath max_depth 12, 16 tracking steps), computed once with mitsuba_tpu
# on the CPU: mi.render(mi.load_dict(het_vol_scene()), spp=16, seed=0)
# .mean(axis=(0, 1)) (15.4 s). The port draws the same samples.
JAX_HETVOL_MEANS = (0.8984217047691345, 0.8984217047691345, 0.8984217047691345)
HETVOL_MEAN_RTOL = 0.01
HETVOL_PASSES = 4
# The JAX package's Stokes vector (I, Q, U, V) of bench.py's polarized
# atmosphere (render/scene_loader.py:atmo_scene: mono_polarized, 64x64
# radiancemeter film, render_1 at spp=64, seed=0, one pass), computed once
# with mitsuba_tpu on the CPU (XLA_FLAGS=--xla_backend_optimization_level=1):
# mi.render_1(mi.load_dict(atmo_scene(64, 64)), spp=64, seed=0)[:, 0]
# (126.7 s, the bake and the compile included). The port draws the same
# samples: I within ATMO_I_RTOL, Q/U/V within ATMO_QUV_ATOL * I.
JAX_ATMO_STOKES = (0.5410645604133606, -0.36343690752983093, -1.172064003185369e-05,
                   8.731047273613513e-06)
ATMO_I_RTOL, ATMO_QUV_ATOL = 1e-3, 1e-3
ATMO_RES, ATMO_SPP, ATMO_PASSES = 64, 64, 3
# BASELINE config 5 and the two other inverse paths (PRB steps, the
# gradient of one loss each). The JAX package's gradients (and the aos
# primal's Stokes vector, which is volpathaos's render_1 at the same seed)
# were computed once with mitsuba_tpu on the CPU
# (XLA_FLAGS=--xla_backend_optimization_level=1), as
#   jax.jit(jax.value_and_grad(loss, has_aux=True))(values)
# with loss(values) = (sum or mean of the render, the render) of
# mi.traverse(scene).update(dict(zip(keys, values))) at seed 0:
# - aos: render/scene_loader.py:aos_scene() (bench.py:268-312's dict),
#   mono_polarized, prb_volpathaos max_depth 4, sum(render_1(spp=64)),
#   the gradient of atmo_medium.sigma_t.value.value, and the Stokes vector
#   (91.3 s);
JAX_AOS_GRAD = -0.19625383615493774
JAX_AOS_STOKES = (0.44527584314346313, -0.005421748384833336, -0.00029123417334631085, 0.0)
# - atmo: atmo_scene(64, 64) with prb (so prb_polarized) max_depth 8,
#   mono_polarized, sum(render_1(spp=64)), the gradients of
#   atmo.sigma_t.value.value and atmo.albedo.value.value (47.8 s);
JAX_ATMO_PRB_GRAD = (0.6898428797721863, 0.3288531005382538)
# - hetvol: het_vol_scene(96, 16) with prbvolpath (max_depth 12; its
#   tracking budgets are the reference's defaults, 32 steps), rgb,
#   mean(render(spp=16)), the gradients of the grid's
#   cloud.interior_medium.sigma_t.data (its float64 sum, and its 8 voxels
#   of largest |gradient|: flat index and value) and of
#   cloud.interior_medium.albedo.value (28.2 s). The largest voxel is the
#   grid's maximum, which sets the majorant (traverse().update() re-derives
#   it from the data in both packages).
JAX_HETVOL_GRID_SUM = -0.06630628709661401
JAX_HETVOL_GRID_TOP = ((3119, -0.0004919688799418509), (22455, -6.546457734657452e-05),
                       (30683, -5.7239292800659314e-05), (30817, -5.561613943427801e-05),
                       (28571, -4.987575448467396e-05), (26305, -4.7096298658289015e-05),
                       (27886, -4.6997840399853885e-05), (16702, -4.6054348786128685e-05))
JAX_HETVOL_ALBEDO_GRAD = 0.8701326847076416
# The card draws the same samples (the forward paths above agree with the
# JAX package to ~1e-7): scalar gradients and the grid's sum within 1e-3
# relative, the grid's largest voxels within 1e-2 (each sums few lanes),
# the aos Stokes vector within 1e-3 (I relative; Q/U/V relative to I).
# The aos gradient lies 1.8e-4 away, on the CPU as on the card: 4 of its
# 65,536 backward lanes meet the sea floor on the seam of its two
# triangles, where the JAX package's FMA-contracted intersector misses
# both and the port hits one.
PRB_VOL_GRAD_RTOL = 1e-3
PRB_VOL_VOXEL_RTOL = 1e-2
AOS_STOKES_TOL = 1e-3
# the kernel route against the plain route on the card: the grid's
# gradient (summed with atomics, in no fixed order) within 1e-5 of its L2
# norm; everything else bitwise
GRID_PLAIN_TOL = 1e-5
AOS_RES, AOS_SPP = 32, 64
HETVOL_PRB_RES, HETVOL_PRB_SPP = 96, 16
PRB_VOL_STEPS = 2
# the Mie bake on the card against the same bake on the CPU (complex64 on
# both): the four tables within rtol 1e-4 and 1e-6 of max|M11|, the
# tolerance of the CPU tests against the JAX package's bake
BAKE_RTOL, BAKE_ATOL_REL = 1e-4, 1e-6
# the regenerative image against the wavefront image (tests/test_regen.py's
# volpath tolerance: the same samples, summed in another order)
REGEN_RTOL, REGEN_ATOL = 3e-4, 3e-5
# a regenerative PRB gradient against the wavefront PRB gradient at the same
# seeds, relative to its largest element (the reference's bound between the
# two schedules, tests/test_regen.py:93-117, :393-414)
REGEN_GRAD_RTOL = 1e-3
# Surface materials and polarization optics (render/scene_loader.py:
# materials_scene, polarimeter_scene). From the fifth bounce on, a few lanes
# take another path in the JAX package than in the port, by last-bit
# differences (ROADMAP Queue 3): a ray from inside the glass box meets its
# bottom face and the coplanar floor at the same t, and rounding picks the
# one it hits; and XLA fuses products into sums in the jitted bounce loop,
# whose last bits a chain of reflections inside the glass amplifies. One
# firefly among them moves a 64x64 @ 16 spp mean by up to 2.4e-3. So the
# JAX values below are the JAX package's run op by op on the CPU (under
# jax.disable_jit(), where XLA fuses nothing across ops), over the pixels
# where no lane's path parts from the port's on the CPU. The pixel lists
# (row-major indices into the 64x64 film) were found by comparing every
# lane's radiance of the two packages' render_lanes (rtol 1e-4, atol 1e-5),
# four passes of 16 spp (pass_base 0, 16, 32, 48 of spp_total 64) in four
# processes; on the other pixels the port's CPU means equal the JAX
# package's to the last bit. Computed once with mitsuba_tpu on the CPU at
# seed 0, for each pass p:
#   with jax.disable_jit():
#       L, _, _, _ = render_lanes(mi.load_dict(scene(64, 64)), jnp.uint32(0),
#                                 0, 64 * 64 * 16, 16 * p, 16, 64, 0)
#   then the per-pixel sums of the four passes over 64, and their mean over
#   the pixels not listed
# - the materials scene (rgb, path max_depth 8), per channel (~125 s a pass;
#   the whole image's means are 0.1770867109298706, 0.1148795336484909,
#   0.04903002083301544, the port's on the CPU 4.5e-4 from them in red):
MATERIALS64_PARTING_PIXELS = (70, 74, 89, 91, 102, 103, 105, 123, 132, 135, 146, 154, 157, 163,
    168, 169, 174, 181, 185, 198, 199, 200, 212, 218, 230, 236, 238, 244, 245, 246, 252, 261,
    262, 263, 272, 281, 283, 289, 295, 298, 307, 337, 341, 352, 353, 355, 356, 362, 363, 365,
    374, 392, 401, 410, 415, 416, 418, 419, 430, 436, 438, 440, 465, 466, 475, 479, 480, 487,
    502, 534, 540, 544, 554, 555, 589, 603, 606, 619, 622, 650, 678, 679, 739, 740, 742, 754,
    795, 812, 815, 835, 836, 837, 904, 934, 1032, 1050, 1054, 1063, 1081, 1083, 1116, 1158, 1186,
    1214, 1218, 1227, 1285, 1340, 1401, 1477, 1538, 1632, 1659, 1668, 1706, 1711, 1751, 1801,
    1812, 1813, 1851, 1951, 1956, 1986, 2010, 2013, 2044, 2061, 2116, 2142, 2168, 2196, 2206,
    2246, 2324, 2331, 2333, 2335, 2362, 2393, 2394, 2397, 2438, 2461, 2463, 2527, 2537, 2582,
    2591, 2642, 2648, 2656, 2657, 2659, 2660, 2661, 2662, 2663, 2719, 2720, 2721, 2722, 2723,
    2724, 2725, 2726, 2727, 2728, 2729, 2730, 2733, 2788, 2791, 2793, 2796, 2797, 2823, 2870,
    2871, 2901, 2966, 2970, 3035, 3069, 3099, 3100, 3102, 3161, 3164, 3202, 3223, 3230, 3293,
    3325, 3356, 3387, 3416, 3453, 3593, 3615, 3616, 3621, 3679, 3683, 3684, 3688, 3737, 3740,
    3744, 3797, 3821, 3882, 3883, 3954, 3956)
JAX_MATERIALS64_KEPT_MEANS = (0.16329382359981537, 0.10464709252119064, 0.0441729910671711)
# - the polarimeter (rgb_polarized, stokes over volpath max_depth 8), rows I,
#   Q, U, V of 3 channels (~420 s a pass; the whole image's I is
#   (0.1198125, 0.0825288, 0.0352961)):
POLARIMETER64_PARTING_PIXELS = (94, 103, 116, 139, 163, 166, 187, 198, 216, 218, 226, 227, 243,
    263, 279, 313, 394, 398, 410, 421, 423, 424, 427, 485, 491, 577, 613, 624, 644, 661, 671,
    677, 728, 741, 749, 804, 862, 969, 1019, 1338, 1853, 1988, 1991, 2121, 2169, 2487, 2493,
    2591, 2661, 2663, 2720, 2722, 2723, 2724, 2725, 2726, 2727, 2728, 2729, 2788, 2789, 2791,
    2792, 2793, 2795, 2796, 3012, 3290, 3353, 3355, 3562, 3615, 3680, 3683, 3744, 3749, 3800,
    3816, 3819, 3882, 3883)
JAX_POLARIMETER64_KEPT_STOKES = (
    (0.11956474930047989, 0.08242115378379822, 0.035243887454271317),
    (-0.021096810698509216, -0.015579000115394592, -0.006997226737439632),
    (-0.018266716971993446, -0.01667453534901142, -0.007708600722253323),
    (-6.803748692618683e-05, -3.2073778129415587e-05, -2.8246968213352375e-06),
)
# - the materials scene's PRB gradients of the image mean for
#   MATERIALS_PRB_KEYS at 64x64 @ 16 spp, prb max_depth 4, the whole image:
#   with jax.disable_jit(): jax.value_and_grad(loss)(values), loss(values) =
#   the mean of mi.render(mi.traverse(scene).update(dict(zip(keys,
#   values))), spp=16, seed=0) (793 s; the port's CPU gradients within
#   1.3e-6 and 0). Below the Russian roulette (rr_depth 5) no lane's path
#   parts; at max_depth 8 the two packages' gradients part by 8.8% (alpha)
#   and 0.9% (weight), and by 0.24% and 0.018% with rr_depth 100, while
#   the images agree to 3.5e-5 (PERF.md section 7):
JAX_MATERIALS_PRB64_DEPTH4_GRAD = (-0.0053257145918905735, -0.015754077583551407)
# the 64x64 means (Q, U, V relative to I) and gradients against the JAX
# package's
MATERIALS_RTOL = 1e-3
# The spectral variants (spectral, spectral_polarized). The JAX package's
# values, computed once with mitsuba_tpu on the CPU
# (XLA_FLAGS=--xla_backend_optimization_level=1), in the spectral variant:
# - the cbox (mi.cornell_box(), path max_depth 8) at 64x64, spp=16, seed=0:
#   mi.render(mi.load_dict(d), spp=16, seed=0).mean(axis=(0, 1)) (10.4 s);
JAX_SPECTRAL_CBOX64_MEANS = (0.2357284426689148, 0.14337600767612457, 0.06117020919919014)
# - the same dict with prb max_depth 4: the gradient of the image mean for
#   white.reflectance.value, jax.jit(jax.value_and_grad(loss, has_aux=True))
#   of loss(v) = (mean of mi.render(mi.traverse(scene).update({KEY: v}),
#   spp=16, seed=0), the image) (27.6 s);
JAX_SPECTRAL_PRB64_DEPTH4_GRAD = (0.045912668108940125, 0.038948509842157364, 0.01508698146790266)
# - in spectral_polarized, BASELINE config 4 (atmo_scene(64, 64)): the raw
#   Stokes [4, 4] (Stokes-major; the radiancemeter's 550 nm on all four
#   channels) of mi.render_1(mi.load_dict(atmo_scene(64, 64)), spp=64,
#   seed=0) (126.9 s).
JAX_SPECTRAL_ATMO_STOKES = tuple(
    (v,) * 4 for v in (0.5410645008087158, -0.36343690752983093, -1.1720664588210639e-05,
                       8.731049092602916e-06))
SPECTRAL_RTOL = 1e-3
SPECTRAL_RENDERS = 2
SPECTRAL_ATMO_PASSES = 2
SPECTRAL_REGEN_RES, SPECTRAL_REGEN_SPP = 32, 8
# an rgb environment, whose upsampled spectrum differs between wavelengths
SPECTRAL_REGEN_RADIANCE = {"type": "rgb", "value": [0.4, 1.0, 1.6]}
MATERIALS_RES, MATERIALS_SPP, MATERIALS_PASSES = 256, 64, 2
MATERIALS_PRB_KEYS = ("large-box.bsdf.alpha", "floor.bsdf.weight.value")
POLARIMETER_SPP_PER_PASS, POLARIMETER_RENDERS = 16, 1
MEANS64_SPP = 64
POLARIMETER_PRB_RES, POLARIMETER_PRB_SPP = 64, 16
# the K3 route's gradient against the K1 route's, same seed, per channel
MMA_GRAD_RTOL = 1e-3
MEAN_RTOL = 0.03
# the 64x64 @ 16 spp render draws the same samples as the JAX image above
MESH64_MEAN_RTOL = 0.005

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit):
# fp32 outside the tensor cores, and HBM3 bandwidth. The fp32 peak counts
# an FMA as 2 operations; K1 and K2 are built with -fmad=false, so each of
# their adds and products is an instruction of its own and the rate they
# can reach is half of it. The bounds use the published peak; the logs
# also print the bound at the unfused rate.
PEAK_FP32_FLOPS = 67e12
PEAK_FP32_UNFUSED = PEAK_FP32_FLOPS / 2
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 arithmetic per (ray, triangle) of the Moller-Trumbore test, counted
# from the kernel: 2 cross products (18), 4 dot products (20), the 3
# subtractions of tvec, the 3 scalings by 1/det, the reciprocal and u + v.
# The 6 compares are not counted. K1 stops a pair early where the rest
# could not change the result: after det (pvec and det, 14) when
# |det| <= 1e-12, after u (24) when u < 0 or u > 1; its bound counts what
# each pair of the run's inputs needs.
K1_FLOPS_PER_PAIR = 46
K1_FLOPS_DET = 14
K1_FLOPS_U = 24

# K3 per (active ray, real triangle): the contraction over the 10
# geometric feature slots for the 4 quantities (det, u', v', t'), 2 flops a
# product, 3 products each in the 3xTF32 split, on the tensor cores; and the
# epilogue's fp32 reciprocal, 3 scalings and u + v on the CUDA cores (the
# compares not counted)
K3_TF32_FLOPS_PER_PAIR = 3 * 2 * 10 * 4
K3_FP32_FLOPS_PER_PAIR = 5
# K3 against its plain version: prim may differ only at grazing ties (both
# hit at the same t within 1e-5, or the differing hit lies within 1e-4 of a
# triangle edge in barycentrics), on at most 1 lane in 1e5; t, u, v on equal
# prims within 1e-5 * max(|x|, 1) scaled by the hit's conditioning
# k = max(1, 1 / (|cos| sin)) (cos between ray and normal, sin of the angle
# between the edges): the 3xTF32 products round to about 2^-22 of each
# operand, where fp32 rounds to 2^-24, and a grazing ray or a sliver
# triangle amplifies that by k
K3_PRIM_RATE = 1e-5
K3_RTOL = 1e-5
# K3 against K1: tests/test_mxu_intersect.py's bounds, at most 2 prim
# differences per 2000 rays and 1e-4 absolute on t, u, v (scaled by k and
# max(|x|, 1) on the random soup, whose slivers and grazing rays the 2000-ray
# test does not meet)
K3_K1_PRIM_RATE = 2 / 2000
K3_K1_ATOL = 1e-4

MESH_RES, MESH_SPP, MESH_K = 256, 16, 130
PRB_RES, PRB_SPP, PRB_ITERS = 256, 64, 3
KEY = "white.reflectance.value"


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


def build_all(cuda_build, native, K1, K2, K3):
    """Every nvcc build and the g++ build of the host code, started
    together; prints each log. K2 must not spill."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        jobs = {
            "tri_intersect": pool.submit(cuda_build.build, "tri_intersect", K1.BUILD_FLAGS),
            "bvh_sweep": pool.submit(cuda_build.build, "bvh_sweep", K2.BUILD_FLAGS),
            "intersect_mxu": pool.submit(cuda_build.build, "intersect_mxu", K3.BUILD_FLAGS),
            "dma_probe": pool.submit(cuda_build.build, "dma_probe"),
            "mtpu_native (g++)": pool.submit(cuda_build.build_host, "mtpu_native", native.SOURCES),
        }
        builds = {name: job.result() for name, job in jobs.items()}
    log(f"== build: {time.perf_counter() - t0:.2f} s wall, all started together")
    for name, b in builds.items():
        log(f"  {name}: {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if line.strip():
                log(f"    {line.strip()}")
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", builds["bvh_sweep"].log)]
    if not spills or max(spills) > 0:
        raise AssertionError(f"bvh_sweep: spills in the -Xptxas -v report {spills}")
    log("  bvh_sweep: no spills (both template instances)")


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def compare_k1(name, K1, table, o, d, maxt):
    """K1 against its plain version on the same inputs: prim, t, u, v
    bitwise. Returns (worst ulp (0), max abs error (0.0))."""
    got = K1.smem_intersect(table, o, d, maxt)
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
    if worst != 0 or not all(torch.equal(g.view(torch.int32), r.view(torch.int32))
                             for g, r in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3]))):
        raise AssertionError(f"K1 {name}: t/u/v differ from the plain version ({worst} ulp)")
    return worst, err


def k1_work(table, o, d, maxt, chunk=1 << 20):
    """What one K1 call does on these inputs, counted on the card without
    a synchronisation, so that it can run between the launches of a step:
    the lanes and the table's elements, and as 0-d tensors the active lanes
    (maxt > 0), the real (non-degenerate) rows and the fp32 operations of
    each active lane against each real row: 14 where |det| <= 1e-12, 24
    where u < 0 or u > 1 (or NaN), 46 for the rest (pvec, det and u in the
    kernel's order)."""
    real = torch.linalg.cross(table[:, 3:6], table[:, 6:9]).abs().sum(-1) > 0
    v0, e1, e2 = table[:, 0:3], table[:, 3:6], table[:, 6:9]
    flops = torch.zeros((), dtype=torch.int64, device=table.device)
    for r0 in range(0, o.shape[0], chunk):
        ro, rd = o[r0:r0 + chunk, :, None], d[r0:r0 + chunk, :, None]
        pairs = (maxt[r0:r0 + chunk] > 0)[:, None] & real
        pvx = rd[:, 1] * e2[:, 2] - rd[:, 2] * e2[:, 1]
        pvy = rd[:, 2] * e2[:, 0] - rd[:, 0] * e2[:, 2]
        pvz = rd[:, 0] * e2[:, 1] - rd[:, 1] * e2[:, 0]
        det = e1[:, 0] * pvx + e1[:, 1] * pvy + e1[:, 2] * pvz
        ok = det.abs() > 1e-12
        u = ((ro[:, 0] - v0[:, 0]) * pvx + (ro[:, 1] - v0[:, 1]) * pvy
             + (ro[:, 2] - v0[:, 2]) * pvz) * torch.where(ok, 1.0 / det, 0.0)
        n_det = (pairs & ~ok).sum()
        n_full = (pairs & ok & (u >= 0) & (u <= 1)).sum()
        flops += (K1_FLOPS_DET * n_det + K1_FLOPS_PER_PAIR * n_full
                  + K1_FLOPS_U * (pairs.sum() - n_det - n_full))
    return dict(n=maxt.shape[0], table_numel=table.numel(), n_active=(maxt > 0).sum(),
                n_real=real.sum(), flops=flops)


def k1_bound_ms(work):
    """Least time for one K1 call from its k1_work: each byte the function
    needs read once and each output byte written once, against the fp32
    operations that the active lanes need on the real triangles with K1's
    early stops. Every lane needs its maxt and writes t, prim, u, v; only
    an active lane needs its o and d. Returns a dict: "ms" at the published
    fp32 peak, "by" what sets it, "unfused_ms" at the unfused rate that
    -fmad=false allows, and the same two with all 46 operations on every
    pair ("all_pairs_ms", "all_pairs_unfused_ms"), which credits no early
    stop."""
    n, n_active, n_real, flops = (int(work[k]) for k in ("n", "n_active", "n_real", "flops"))
    nbytes = work["table_numel"] * 4 + n * (1 + 4) * 4 + n_active * 6 * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    all_ops = n_active * n_real * K1_FLOPS_PER_PAIR / PEAK_FP32_FLOPS * 1e3
    return dict(ms=max(t_bytes, t_ops), by="operations" if t_ops >= t_bytes else "bytes",
                unfused_ms=max(t_bytes, 2 * t_ops), all_pairs_ms=max(t_bytes, all_ops),
                all_pairs_unfused_ms=max(t_bytes, 2 * all_ops), n_active=n_active,
                n_real=n_real, flops=flops)


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


def disable_share(maxt, share, seed):
    """maxt with a random `share` of the lanes (made from `seed`) disabled."""
    gen = torch.Generator(device=maxt.device).manual_seed(seed)
    off = torch.rand(maxt.shape, generator=gen, device=maxt.device) < share
    return torch.where(off, -float("inf"), maxt)


def phase_k1(mi, K1, make_wavefront):
    """K1 against its plain version on the cbox's bounce-0 batch (with the
    main path's table, the 36 real rows; and the padded 64-row table, whose
    result must not differ by a bit), on it with every lane active and with
    a random 50% and 90% of its lanes disabled, and on a 4096-triangle
    soup; K1 timed on the 36-row and the 64-row table, all active and 50%
    scattered."""
    scene = mi.load_dict(mi.cornell_box())
    spp = 64
    n = scene.film.n_pixels * spp
    geom = scene.geometry.refresh()
    table64 = K1.build_tri_table(geom)
    table = table64[:geom.n_real_tris]
    _, ray, _, _, _ = make_wavefront(scene, 0, 0, n, 0, spp, spp)
    # bounce 0's fused launch: the camera rays, then the N pending shadow
    # slots, all disabled on the first bounce
    o = torch.cat([ray.o, ray.o]).contiguous()
    d = torch.cat([ray.d, ray.d]).contiguous()
    maxt = torch.cat([ray.maxt, torch.full_like(ray.maxt, -float("inf"))]).contiguous()
    maxt_all = torch.full_like(maxt, float("inf"))
    maxt50 = disable_share(maxt_all, 0.5, 3)
    maxt90 = disable_share(maxt_all, 0.9, 4)
    results = [compare_k1(name, K1, table, o, d, m) for name, m in (
        ("cbox bounce-0 batch", maxt), ("cbox batch, every lane active", maxt_all),
        ("cbox batch, 50% of lanes disabled at random", maxt50),
        ("cbox batch, 90% of lanes disabled at random", maxt90))]
    results.append(compare_k1("random soup", K1, *random_soup(4096, 1 << 20, 7, o.device)))
    trimmed, padded = K1.smem_intersect(table, o, d, maxt), K1.smem_intersect(table64, o, d, maxt)
    if not all(torch.equal(a, b) for a, b in zip(trimmed, padded)):
        raise AssertionError("K1: the 36-row table's result differs from the 64-row table's")
    log(f"K1 cbox bounce-0 batch: {table.shape[0]}-row and {table64.shape[0]}-row tables "
        "give the same prim, t, u, v bit for bit")

    k1_ms = time_cuda(lambda: K1.smem_intersect(table, o, d, maxt), reps=50)
    k1_64_ms = time_cuda(lambda: K1.smem_intersect(table64, o, d, maxt), reps=50)
    plain_ms = time_cuda(lambda: K1.tri_intersect_reference(table, o, d, maxt), reps=3, warmup=1)
    k1_all_ms = time_cuda(lambda: K1.smem_intersect(table, o, d, maxt_all), reps=50)
    k1_50_ms = time_cuda(lambda: K1.smem_intersect(table, o, d, maxt50), reps=50)
    b0, b_all, b50 = (k1_bound_ms(k1_work(table, o, d, m)) for m in (maxt, maxt_all, maxt50))

    def bounds(b):
        return (f"bound {b['ms']:.4f} ms ({b['by']}; {b['unfused_ms']:.4f} ms at the unfused "
                f"fp32 rate; all 46 operations on every pair: {b['all_pairs_ms']:.4f} / "
                f"{b['all_pairs_unfused_ms']:.4f} ms)")

    log(f"K1 timing, cbox bounce-0 batch ({o.shape[0]} rays, {b0['n_active']} active, "
        f"{table.shape[0]} rows, {b0['n_real']} real, {b0['flops']} flop): kernel {k1_ms:.4f} "
        f"ms ({table64.shape[0]}-row table: {k1_64_ms:.4f} ms), plain {plain_ms:.3f} ms, "
        f"{bounds(b0)}, kernel at {b0['unfused_ms'] / k1_ms:.2%} of the unfused bound; every "
        f"lane active: kernel {k1_all_ms:.4f} ms, {bounds(b_all)}; 50% of lanes disabled at "
        f"random: kernel {k1_50_ms:.4f} ms, {bounds(b50)}")
    worst = max(w for w, _ in results)
    return scene, (o, d, maxt), {
        "name": "tri_intersect",
        "route": "cuda",
        "source": "mitsuba_tpu_torch/csrc/tri_intersect.cu",
        "replaces": "mitsuba_tpu/ops/intersect.py:33",
        "max_abs_err": max(e for _, e in results),
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": b0["ms"],
        "bound_by": b0["by"],
        "library_ms": None,
        "bound_unfused_ms": b0["unfused_ms"],
        "bound_all_pairs_ms": b0["all_pairs_ms"],
        "bound_all_pairs_unfused_ms": b0["all_pairs_unfused_ms"],
        "bitwise_vs_plain": worst == 0,
        "ms_64_row_table": k1_64_ms,
        "all_active_ms": k1_all_ms,
        "all_active_bound_ms": b_all["ms"],
        "scattered50_ms": k1_50_ms,
        "scattered50_bound_ms": b50["ms"],
    }


def reset_launches(K1, K2, K3):
    K1.smem_intersect.launches = 0
    K2.bvh_sweep_intersect.launches = 0
    K2.bvh_sweep_occluded.launches = 0
    K3.mxu_intersect.launches = 0


@contextlib.contextmanager
def plain_versions(K1, K2, K3):
    """Inside, every kernel's wrapper runs its plain version, on the card:
    the renders through the kernels are held against these."""
    saved = K1.smem_intersect, K3.mxu_intersect, K2.bvh_sweep
    K1.smem_intersect = K1.tri_intersect_reference
    K3.mxu_intersect = K3.mxu_intersect_reference
    K2.bvh_sweep = lambda nodes, table, o, d, maxt, anyhit=False, rows=None: (
        K2.bvh_sweep_reference(nodes, table, o, d, maxt, anyhit))
    try:
        yield
    finally:
        K1.smem_intersect, K3.mxu_intersect, K2.bvh_sweep = saved


def phase_cbox_main(mi, K1, K2, K3, scene):
    """The cbox main path at 256x256 @ 64 spp, then the 64x64 render through
    K1 against the same render through the plain version."""
    film = scene.film
    spp = 64
    mi.render(scene, spp=1, seed=1)                       # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(K1, K2, K3)
    stats = {}
    t0 = time.perf_counter()
    img = mi.render(scene, spp=spp, seed=0, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K1.smem_intersect.launches
    k2_launches = K2.bvh_sweep_intersect.launches + K2.bvh_sweep_occluded.launches
    peak = torch.cuda.max_memory_allocated()
    means = img.mean(dim=(0, 1)).tolist()
    log(f"== main path: cbox {film.width}x{film.height} @ {spp} spp: {wall:.3f} s wall, "
        f"{stats['n_rays']} rays, {stats['n_rays'] / wall / 1e6:.2f} Mrays/s, "
        f"peak memory {peak / 2**30:.2f} GiB, K1 launches {launches}, K2 launches {k2_launches}, "
        f"means {means}")
    if tuple(img.shape) != (film.height, film.width, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"main path: image of shape {tuple(img.shape)} is not finite")
    n_passes = 1        # render() takes all spp in one pass unless spp_per_pass is given
    if launches != 9 * n_passes or k2_launches != 0:
        raise AssertionError(f"cbox main path: K1 launched {launches} times (expected 9 per "
                             f"pass), K2 {k2_launches} times (expected 0)")
    rel = [abs(m - r) / r for m, r in zip(means, JAX_CBOX_MEANS)]
    if max(rel) > MEAN_RTOL:
        raise AssertionError(f"main path: channel means {means} vs JAX {JAX_CBOX_MEANS}: {rel}")
    log(f"  channel means within {max(rel):.4%} of the JAX package's")

    d64 = mi.cornell_box()
    d64["sensor"]["film"]["width"] = d64["sensor"]["film"]["height"] = 64
    scene64 = mi.load_dict(d64)
    img_k = mi.render(scene64, spp=4, seed=0)
    with plain_versions(K1, K2, K3):
        img_p = mi.render(scene64, spp=4, seed=0)
    compare_images("cbox", img_k, img_p)
    return launches


def compare_images(name, img_k, img_p):
    """The render through the kernels against the render through the plain
    versions: bitwise, or else 99.9% of the pixels at rtol 1e-5."""
    if torch.equal(img_k, img_p):
        log(f"== {name} kernel vs plain render, 64x64: bitwise equal")
        return
    eq = torch.isclose(img_k, img_p, rtol=1e-5, atol=0).all(-1).float().mean().item()
    log(f"== {name} kernel vs plain render, 64x64: {eq:.5%} of pixels equal at rtol 1e-5")
    if eq < 0.999:
        raise AssertionError(f"{name} 64x64 render: kernel and plain images differ beyond 0.1% of pixels")


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def conditioning(table, prim, d):
    """k = max(1, 1 / (|cos| sin)) of each lane's hit triangle (1 on a
    miss): cos between the ray and the normal, sin between the edges."""
    rows = table[torch.clamp(prim, min=0).to(torch.int64)].double()
    e1, e2 = rows[:, 3:6], rows[:, 6:9]
    n = torch.linalg.cross(e1, e2)
    area2 = n.norm(dim=1).clamp(min=1e-30)
    cos = (d.double() * n).sum(1).abs() / area2
    sin = area2 / (e1.norm(dim=1) * e2.norm(dim=1)).clamp(min=1e-30)
    k = torch.clamp(1.0 / (cos * sin).clamp(min=1e-30), min=1.0)
    return torch.where(prim >= 0, k, 1.0)


def compare_hits(name, got, ref, table, d, prim_rate, tol, scaled):
    """Closest hits `got` against `ref` on the same rays: prim may differ
    only at grazing ties (both hit at the same t within 1e-5, or a
    differing hit lies within 1e-4 k of a triangle edge), on at most
    prim_rate of the lanes; t, u, v on equal prims within tol, times
    k max(|x|, 1) when `scaled`. Returns (prim differences, max abs error,
    worst error over its bound)."""
    n = d.shape[0]
    diff = got[1] != ref[1]
    idx = diff.nonzero()[:, 0]
    if idx.numel():
        tg, tr = got[0][idx], ref[0][idx]
        both = (got[1][idx] >= 0) & (ref[1][idx] >= 0)
        same_t = both & ((tg - tr).abs() <= 1e-5 * torch.clamp(tr.abs(), min=1.0))

        def near_edge(res):
            u, v = res[2][idx], res[3][idx]
            k = conditioning(table, res[1][idx], d[idx])
            return (res[1][idx] >= 0) & (torch.minimum(torch.minimum(u, v), 1 - u - v) <= 1e-4 * k)

        ties = same_t | near_edge(got) | near_edge(ref)
        if not bool(ties.all()):
            bad = idx[~ties][:5].tolist()
            raise AssertionError(f"K3 {name}: prim differs away from a grazing tie at lanes {bad}")
    if idx.numel() > prim_rate * n:
        raise AssertionError(f"K3 {name}: prim differs on {idx.numel()} of {n} lanes "
                             f"(> {prim_rate:g} of them)")
    m = ~diff & (ref[1] >= 0)
    k = conditioning(table, ref[1], d)[m]
    err = worst = 0.0
    for a, b in ((got[0], ref[0]), (got[2], ref[2]), (got[3], ref[3])):
        e = (a[m] - b[m]).abs()
        if not e.numel():
            continue
        err = max(err, float(e.max()))
        scale = (k * torch.clamp(b[m].abs(), min=1.0)) if scaled else 1.0
        worst = max(worst, float((e / scale).max()) / tol)
    log(f"K3 {name}: {n} rays, {int((ref[1] >= 0).sum())} hits; prim differs on "
        f"{idx.numel()} lanes (grazing ties); t/u/v max abs err {err:.3g}, worst "
        f"{worst:.3f} of the bound ({tol:g}{' x k max(|x|,1)' if scaled else ' absolute'})")
    if worst > 1.0:
        raise AssertionError(f"K3 {name}: t/u/v beyond the bound ({worst:.3f} of it)")
    return idx.numel(), err, worst


def k3_check(name, K1, K3, table, o, d, maxt, scaled_vs_k1):
    """K3 on one batch against its plain version and against K1."""
    cols = K3.build_mxu_cols(table[:, 0:3], table[:, 3:6], table[:, 6:9])
    got = K3.mxu_intersect(cols, o, d, maxt)
    ref = K3.mxu_intersect_reference(cols, o, d, maxt)
    k1 = K1.smem_intersect(table, o, d, maxt)
    torch.cuda.synchronize()
    if not bool((got[1][~(maxt > 0)] == -1).all()):
        raise AssertionError(f"K3 {name}: a disabled lane hit")
    _, err, _ = compare_hits(f"{name} vs plain", got, ref, table, d, K3_PRIM_RATE, K3_RTOL, True)
    compare_hits(f"{name} vs K1", got, k1, table, d, K3_K1_PRIM_RATE, K3_K1_ATOL, scaled_vs_k1)
    return cols, err


def k3_work(cols, o, d, maxt):
    """What one K3 call does on these inputs, counted on the card without
    a synchronisation: the lanes and the column table's elements, and as
    0-d tensors the active lanes and the real triangles (non-zero det
    columns)."""
    tp = cols.shape[1] // 4
    return dict(n=maxt.shape[0], cols_numel=cols.numel(), n_active=(maxt > 0).sum(),
                n_real=(cols[:, :tp] != 0).any(0).sum())


def k3_bound_ms(work):
    """Least time for one K3 call from its k3_work: o, d, maxt read and t,
    prim, u, v written for an active lane (44 B), maxt and the outputs for
    a disabled one (20 B), the column table once; against the 3xTF32
    products on the tensor cores and the epilogue on the CUDA cores for
    every active lane and real triangle (the two units run side by side,
    so the larger of their times). Returns (ms, what sets it, (bytes ms,
    TF32 ms, fp32 ms), real triangles)."""
    n, n_active, n_real = (int(work[k]) for k in ("n", "n_active", "n_real"))
    nbytes = work["cols_numel"] * 4 + n_active * 44 + (n - n_active) * 20
    pairs = n_active * n_real
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_tc = pairs * K3_TF32_FLOPS_PER_PAIR / PEAK_TF32_FLOPS * 1e3
    t_fp = pairs * K3_FP32_FLOPS_PER_PAIR / PEAK_FP32_FLOPS * 1e3
    return (max(t_bytes, t_tc, t_fp), "operations" if max(t_tc, t_fp) >= t_bytes else "bytes",
            (t_bytes, t_tc, t_fp), n_real)


def phase_k3(K1, K3, scene, batch):
    """K3 against its plain version and K1 on the cbox's bounce-0 2N batch
    (the main path's table: the 36 real rows), on it with 10% more of the
    lanes disabled, on it with every lane active and a random 50% and 90%
    disabled, and on a 512-triangle soup with duplicated rows (ties); K3,
    K1, the plain version and the contraction alone in torch.matmul timed
    on the cbox batch, K3 also all active and 50% scattered."""
    geom = scene.geometry.refresh()
    table = K1.build_tri_table(geom)[:geom.n_real_tris]
    o, d, maxt = batch
    cols, err_a = k3_check("cbox bounce-0 batch", K1, K3, table, o, d, maxt, False)
    maxt10 = disable_share(maxt, 0.1, 5)
    maxt_all = torch.full_like(maxt, float("inf"))
    maxt50 = disable_share(maxt_all, 0.5, 3)
    errs = [err_a] + [k3_check(name, K1, K3, table, o, d, m, False)[1] for name, m in (
        ("cbox batch, 10% more disabled", maxt10),
        ("cbox batch, 50% of lanes disabled at random", maxt50),
        ("cbox batch, 90% of lanes disabled at random", disable_share(maxt_all, 0.9, 4)))]
    s_table, s_o, s_d, s_maxt = random_soup(512, 1 << 20, 7, o.device)
    errs.append(k3_check("512-triangle soup", K1, K3, s_table, s_o, s_d, s_maxt, True)[1])

    k3_ms = time_cuda(lambda: K3.mxu_intersect(cols, o, d, maxt), reps=50)
    k1_ms = time_cuda(lambda: K1.smem_intersect(table, o, d, maxt), reps=50)
    k3_all_ms = time_cuda(lambda: K3.mxu_intersect(cols, o, d, maxt_all), reps=50)
    k3_50_ms = time_cuda(lambda: K3.mxu_intersect(cols, o, d, maxt50), reps=50)
    plain_ms = time_cuda(lambda: K3.mxu_intersect_reference(cols, o, d, maxt), reps=3, warmup=1)
    torch.backends.cuda.matmul.allow_tf32 = False      # the fp32 product, stated and set
    feat = K3.mxu_features(o, d, maxt)
    lib_ms = time_cuda(lambda: torch.matmul(feat, cols), reps=10)
    del feat
    torch.cuda.empty_cache()
    bound_ms, bound_by, (t_bytes, t_tc, t_fp), n_real = k3_bound_ms(k3_work(cols, o, d, maxt))
    bound_all_ms = k3_bound_ms(k3_work(cols, o, d, maxt_all))[0]
    bound_50_ms = k3_bound_ms(k3_work(cols, o, d, maxt50))[0]
    log(f"K3 timing, cbox bounce-0 batch ({o.shape[0]} rays, {int((maxt > 0).sum())} active, "
        f"{n_real} triangles, Tp {cols.shape[1] // 4}): kernel {k3_ms:.4f} ms, K1 on the same "
        f"{table.shape[0]}-row table {k1_ms:.4f} ms, plain {plain_ms:.2f} ms, torch.matmul "
        f"contraction only (fp32, TF32 off) {lib_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
        f"bytes {t_bytes:.4f}, TF32 products {t_tc:.4f}, fp32 epilogue {t_fp:.4f}), kernel at "
        f"{bound_ms / k3_ms:.2%} of it; every lane active: kernel {k3_all_ms:.4f} ms, bound "
        f"{bound_all_ms:.4f} ms; 50% of lanes disabled at random: kernel {k3_50_ms:.4f} ms, "
        f"bound {bound_50_ms:.4f} ms")
    return {
        "name": "mxu_intersect",
        "route": "cuda",
        "source": "mitsuba_tpu_torch/csrc/intersect_mxu.cu",
        "replaces": "mitsuba_tpu/ops/intersect_mxu.py:82",
        "max_abs_err": max(errs),
        "ms": k3_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
        "library_call": "torch.matmul(feat, cols) in fp32, TF32 off: the contraction only",
        "k1_same_table_ms": k1_ms,
        "all_active_ms": k3_all_ms,
        "all_active_bound_ms": bound_all_ms,
        "scattered50_ms": k3_50_ms,
        "scattered50_bound_ms": bound_50_ms,
    }


# ---------------------------------------------------------------------------
# PRB: the gradient step
# ---------------------------------------------------------------------------

def prb_dict(mi, res, spp, max_depth):
    d = mi.cornell_box()
    d["sensor"]["film"]["width"] = d["sensor"]["film"]["height"] = res
    d["sensor"]["sampler"]["sample_count"] = spp
    d["integrator"] = {"type": "prb", "max_depth": max_depth}
    return d


def grad_step(mi, scene, seed, spp, stats=None):
    """(image, gradient of KEY) of loss = image mean, as bench.py's headline."""
    params = mi.traverse(scene)
    v = params[KEY].clone().requires_grad_()
    img = mi.render(params.update({KEY: v}), spp=spp, seed=seed, stats=stats)
    img.mean().backward()
    return img.detach(), v.grad


@contextlib.contextmanager
def timed_launches(module, name, work, launches):
    """Inside, CUDA events around each call of module.<name>, kept with
    `work` of the call's inputs (k1_work or k3_work, enqueued after the
    call), from which its bound is computed after the run. The kernel's
    wrapper counts its launches on the module's name, so the count moves to
    the stand-in and back."""
    fn = getattr(module, name)

    def wrapper(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        launches.append((start, end, work(*args)))
        return out

    wrapper.launches = fn.launches
    setattr(module, name, wrapper)
    try:
        yield
    finally:
        fn.launches = wrapper.launches
        setattr(module, name, fn)


def run_prb(mi, K1, K2, K3, intersector):
    """The PRB gradient step at 256x256 @ 64 spp through `intersector`:
    one warm-up iteration, PRB_ITERS timed ones (seed = iteration), then
    one with CUDA events around each closest-hit launch, whose summed time
    is held against the summed bounds of the same launches."""
    scene = mi.load_dict(prb_dict(mi, PRB_RES, PRB_SPP, 8), intersector=intersector)
    grad_step(mi, scene, 0, PRB_SPP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(K1, K2, K3)
    walls, rays, grads = [], [], []
    for it in range(PRB_ITERS):
        stats = {}
        t0 = time.perf_counter()
        img, g = grad_step(mi, scene, it, PRB_SPP, stats)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        rays.append((stats["n_rays"], stats["n_rays_grad"]))
        grads.append(g)
        if tuple(img.shape) != (PRB_RES, PRB_RES, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"prb {intersector}: image of shape {tuple(img.shape)} not finite")
        if not bool(torch.isfinite(g).all()) or not bool((g != 0).all()):
            raise AssertionError(f"prb {intersector}: gradient {g.tolist()}")
    launches = dict(K1=K1.smem_intersect.launches, K3=K3.mxu_intersect.launches,
                    K2=K2.bvh_sweep_intersect.launches + K2.bvh_sweep_occluded.launches)
    peak = torch.cuda.max_memory_allocated()
    for it, (wall, (n_fwd, n_grad)) in enumerate(zip(walls, rays)):
        log(f"== main path: cbox prb {PRB_RES}x{PRB_RES} @ {PRB_SPP} spp, intersector "
            f"{intersector!r}, iteration {it}: {wall:.3f} s wall, rays forward {n_fwd} + "
            f"backward {n_grad} (primal at seed_grad and replay) = {n_fwd + n_grad}, "
            f"{(n_fwd + n_grad) / wall / 1e6:.2f} Mrays/s fwd+bwd counted; bench.py's 3x forward "
            f"approximation {3 * n_fwd / wall / 1e6:.2f} Mrays/s; gradient {grads[it].tolist()}")
    log(f"  {PRB_ITERS} iterations: launches {launches}, {launches['K1'] / PRB_ITERS:.0f} K1 "
        f"and {launches['K3'] / PRB_ITERS:.0f} K3 per iteration; peak memory {peak / 2**30:.2f} GiB")
    used, unused = ("K1", "K3") if intersector == "smem" else ("K3", "K1")
    if launches[used] == 0 or launches[unused] != 0 or launches["K2"] != 0:
        raise AssertionError(f"prb {intersector}: launches {launches}")
    if intersector == "smem":
        owner, kernel, work = K1, "smem_intersect", k1_work

        def bounds(w):
            b = k1_bound_ms(w)
            return b["ms"], b["unfused_ms"]
    else:
        owner, kernel, work = K3, "mxu_intersect", k3_work

        def bounds(w):
            return (k3_bound_ms(w)[0],) * 2
    timed = []
    with timed_launches(owner, kernel, work, timed):
        t0 = time.perf_counter()
        grad_step(mi, scene, 0, PRB_SPP)
        torch.cuda.synchronize()
        wall_t = time.perf_counter() - t0
    per = [(start.elapsed_time(end), *bounds(w)) for start, end, w in timed]
    k_ms, b_ms, u_ms = (sum(x[c] for x in per) for c in range(3))
    # the share is of a timed iteration's wall: the counts slow this one
    share = k_ms / (sorted(walls)[len(walls) // 2] * 1e3)
    log(f"  one more iteration with events around each {kernel} launch (and the count of its "
        f"work after it): {wall_t * 1e3:.1f} ms wall, {len(per)} launches, {k_ms:.2f} ms in the "
        f"kernel ({share:.2%} of a timed iteration's median wall); summed bound {b_ms:.4f} ms"
        + (f" ({u_ms:.4f} ms at the unfused fp32 rate)" if intersector == "smem" else "")
        + f", gap {k_ms - b_ms:.4f} ms; per launch (ms, bound): "
        + ", ".join(f"({m:.4f}, {b:.4f})" for m, b, _ in per))
    step = dict(launches_per_step=len(per), step_ms=k_ms, step_bound_ms=b_ms)
    if intersector == "smem":
        step["step_bound_unfused_ms"] = u_ms
    return grads[0], launches, walls, rays, peak, share, step


def phase_prb_main(mi, K1, K2, K3):
    """The slice's main path through K1 and through K3; the K3 route's
    gradient held against the K1 route's at the same seed."""
    g_smem, l_smem, walls, rays, peak, share_k1, step_k1 = run_prb(mi, K1, K2, K3, "smem")
    g_mma, l_mma, walls_m, _, _, share_k3, step_k3 = run_prb(mi, K1, K2, K3, "mma")
    rel = ((g_mma - g_smem).abs() / g_smem.abs()).tolist()
    log(f"== prb gradient, K3 route vs K1 route (seed 0): {g_mma.tolist()} vs {g_smem.tolist()}, "
        f"relative difference {rel}")
    if max(rel) > MMA_GRAD_RTOL:
        raise AssertionError(f"prb: K3 route's gradient differs from K1 route's by {rel}")
    return l_smem, l_mma, step_k1, step_k3, dict(
        walls=walls, rays=rays, peak=peak, share_k1=share_k1, walls_mma=walls_m,
        share_k3=share_k3)


def phase_prb64(mi, K1, K2, K3):
    """The 64x64 @ 16 spp gradient against the JAX package's, and the
    kernel route's gradient against the plain route's, bitwise."""
    scene = mi.load_dict(prb_dict(mi, 64, 16, 8))
    img_k, g_k = grad_step(mi, scene, 0, 16)
    with plain_versions(K1, K2, K3):
        img_p, g_p = grad_step(mi, scene, 0, 16)
    rel = [abs(a - b) / abs(b) for a, b in zip(g_k.tolist(), JAX_PRB64_GRAD)]
    log(f"== prb 64x64 @ 16 spp gradient {g_k.tolist()}, within {max(rel):.4%} of the JAX "
        f"package's {JAX_PRB64_GRAD}; kernel vs plain route: gradient bitwise "
        f"{torch.equal(g_k, g_p)}, image bitwise {torch.equal(img_k, img_p)}")
    if max(rel) > PRB64_GRAD_RTOL:
        raise AssertionError(f"prb 64x64: gradient {g_k.tolist()} vs JAX {JAX_PRB64_GRAD}: {rel}")
    if not (torch.equal(g_k, g_p) and torch.equal(img_k, img_p)):
        raise AssertionError(f"prb 64x64: kernel route {g_k.tolist()} vs plain {g_p.tolist()}")


def phase_adam(mi):
    """Ten Adam steps on the 16x16 cbox (prb, max_depth 3) from albedo 0.3
    toward a 256-spp target rendered with the scene's own albedo. Every
    step renders 32 spp with the same seed: the sampling does not depend on
    the albedo (no Russian roulette below depth 5), so the loss is a smooth
    function of it and its fall is not hidden by the noise of new samples."""
    scene = mi.load_dict(prb_dict(mi, 16, 16, 3))
    params = mi.traverse(scene)
    target = mi.render(scene, spp=256, seed=1000).detach()
    opt = mi.ad.Adam(lr=0.05)
    opt[KEY] = torch.full((3,), 0.3, device=target.device)
    losses = []
    for it in range(10):
        v = opt[KEY].clone().requires_grad_()
        img = mi.render(params.update({KEY: v}), spp=32, seed=0)
        loss = ((img - target) ** 2).mean()
        loss.backward()
        opt.step({KEY: v.grad})
        losses.append(loss.item())
        log(f"  adam step {it}: loss {losses[-1]:.6f}, albedo {opt[KEY].tolist()}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"adam: the loss did not fall: {losses}")
    log(f"== adam, 10 steps: loss {losses[0]:.6f} -> {losses[-1]:.6f}")


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def phase_k4(K4):
    """K4 swept over its configurations, each sink held exactly against
    the plain version; GB/s per configuration and the best."""
    x = K4.probe_array("cuda")
    K4.copy_probe.launches = 0
    results = []
    for rows, ring, n_copies in K4.configs():
        gbps, sink = K4.measure(x, rows, ring, n_copies)
        results.append((gbps, rows, ring, n_copies))
        log(f"K4 rows={rows} ({rows * 512 // 1024} KB/copy) ring={ring}: {n_copies} copies, "
            f"{gbps:.1f} GB/s, sink {sink} = plain")
    launches = K4.copy_probe.launches
    gbps, rows, ring, n_copies = max(results)
    nbytes = n_copies * rows * K4.ROW_FLOATS * 4
    ms = nbytes / (gbps * 1e9) * 1e3
    # the bound reads each input byte once: the rows that some window covers
    off = K4.window_offsets(x.shape[0], rows, n_copies, x.device)
    edges = torch.zeros(x.shape[0] + 1, dtype=torch.int64, device=x.device)
    edges.index_add_(0, off, torch.ones_like(off)).index_add_(0, off + rows, -torch.ones_like(off))
    distinct = int((edges.cumsum(0)[:-1] > 0).sum()) * K4.ROW_FLOATS * 4 + 8
    plain_ms = time_cuda(lambda: K4.copy_probe_reference(x, rows, n_copies), reps=5)
    y = torch.empty_like(x)
    copy_ms = time_cuda(lambda: y.copy_(x), reps=10)
    log(f"== K4 best: {gbps:.1f} GB/s (rows={rows}, ring={ring}), {gbps / (PEAK_BYTES_PER_S / 1e9):.1%} "
        f"of the published {PEAK_BYTES_PER_S / 1e9:.0f} GB/s: windows re-read rows that L2 "
        f"still holds; {ms:.4f} ms for {nbytes} B of windows ({nbytes / PEAK_BYTES_PER_S * 1e3:.4f} "
        f"ms at the published rate), {distinct} distinct B read (bound "
        f"{distinct / PEAK_BYTES_PER_S * 1e3:.4f} ms); for scale, torch copy_ of the "
        f"128 MiB array (read and write) {2 * x.numel() * 4 / copy_ms / 1e6:.1f} GB/s")
    return {
        "name": "copy_probe", "route": "cuda", "source": "mitsuba_tpu_torch/csrc/dma_probe.cu",
        "replaces": "scripts/bench_dma.py:19", "launches": launches, "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": distinct / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None, "best_gbps": gbps,
        "window_bytes_ms_at_published_rate": nbytes / PEAK_BYTES_PER_S * 1e3,
        "torch_copy_gbps": 2 * x.numel() * 4 / copy_ms / 1e6,
        "configs": [dict(rows=r, ring=g, gbps=b) for b, r, g, _ in results],
    }


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def run_k2_plain(K2, nodes, table, o, d, maxt, anyhit):
    """The plain walk on a batch, with CUDA events around it: (outputs,
    its counts, ms). It must never reach max_steps."""
    stats = {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    ref = K2.bvh_sweep_reference(nodes, table, o, d, maxt, anyhit=anyhit, stats=stats)
    end.record()
    torch.cuda.synchronize()
    if stats["hit_max_steps"]:
        raise AssertionError("K2: the plain walk reached max_steps")
    return ref, stats, start.elapsed_time(end)


def compare_k2(name, K2, nodes, table, o, d, maxt, anyhit, rows=None):
    """K2 (on `rows`, the geometry's copy of the table, when given) against
    its plain walk on the same rays: prim, t, u, v bitwise. Returns (max
    abs error (0.0), the plain walk's counts and ms)."""
    mode = "any-hit" if anyhit else "closest-hit"
    got = K2.bvh_sweep(nodes, table, o, d, maxt, anyhit=anyhit, rows=rows)
    ref, stats, plain_ms = run_k2_plain(K2, nodes, table, o, d, maxt, anyhit)
    if not torch.equal(got[1], ref[1]):
        bad = (got[1] != ref[1]).nonzero()[:5, 0].tolist()
        raise AssertionError(f"K2 {name} {mode}: prim differs from the plain walk at lanes {bad}")
    pairs = list(zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])))
    worst = max(ulp_diff(g, r) for g, r in pairs)
    hit = ref[1] >= 0
    err = max(float((g[hit] - r[hit]).abs().max()) if hit.any() else 0.0 for g, r in pairs)
    log(f"K2 {name} {mode}: {o.shape[0]} rays, {int((maxt > 0).sum())} active, "
        f"{int(hit.sum())} hits, {stats['steps']} steps, {stats['node_visits']} node visits, "
        f"{stats['tri_tests']} triangle tests; prim bitwise; t/u/v worst {worst} ulp")
    if worst != 0 or not all(torch.equal(g.view(torch.int32), r.view(torch.int32)) for g, r in pairs):
        raise AssertionError(f"K2 {name} {mode}: t/u/v differ from the plain walk ({worst} ulp)")
    return err, stats, plain_ms


def k2_bound_ms(K2, nodes, table, maxt, stats):
    """Least time for one K2 call on these inputs: 28 B read per active
    lane (o, d, maxt) and 4 B per disabled one, 16 B written per lane, the
    node and triangle tables read once; against a slab test per node visit
    and, per triangle test, the operations that K2's early stops leave (14
    for a test that stops after det, 24 after u, 46 for the rest), as the
    plain walk counted them on the same rays. Returns a dict: "ms" at the
    published fp32 peak, "by" what sets it, "unfused_ms" at the unfused
    rate, and "all46_ms" with all 46 operations on every test."""
    n = maxt.shape[0]
    n_active = int((maxt > 0).sum())
    nbytes = n_active * 28 + (n - n_active) * 4 + n * 16 + nodes.numel() * 4 + table.numel() * 4
    tests, det, u = stats["tri_tests"], stats["tri_det_stops"], stats["tri_u_stops"]
    slab = stats["node_visits"] * K2.SLAB_FLOPS
    # K2's triangle test is K1's, with K1's early stops
    flops = slab + det * K1_FLOPS_DET + u * K1_FLOPS_U + (tests - det - u) * K2.TRI_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    all46 = (slab + tests * K2.TRI_FLOPS) / PEAK_FP32_FLOPS * 1e3
    return dict(ms=max(t_bytes, t_ops), by="operations" if t_ops >= t_bytes else "bytes",
                nbytes=nbytes, flops=flops, unfused_ms=max(t_bytes, 2 * t_ops),
                all46_ms=max(t_bytes, all46))


def check_and_time_k2(name, K2, nodes, table, rows, o, d, maxt, anyhit):
    """K2 held bitwise against the plain walk on a whole batch of the main
    path, timed on it as the route calls it (bvh_sweep on the geometry's
    rows: its checks, the counter and the launch) and alone, the plain
    walk's time (its one run, which is also the comparison's and the
    counts'), and the bound from those counts."""
    err, stats, plain_ms = compare_k2(name, K2, nodes, table, o, d, maxt, anyhit, rows)
    k2_ms = time_cuda(lambda: K2.bvh_sweep(nodes, table, o, d, maxt, anyhit=anyhit, rows=rows),
                      reps=10)
    kernel_ms = time_cuda(lambda: K2.launch_kernel(nodes, rows, o, d, maxt, anyhit), reps=10)
    b = k2_bound_ms(K2, nodes, table, maxt, stats)
    log(f"K2 timing, {name} ({'any-hit' if anyhit else 'closest-hit'}, {o.shape[0]} rays, "
        f"{int((maxt > 0).sum())} active): route {k2_ms:.4f} ms, kernel alone {kernel_ms:.4f} "
        f"ms, plain {plain_ms:.1f} ms; {b['nbytes']} B, {b['flops']} flop; bound "
        f"{b['ms']:.4f} ms ({b['by']}), route at {b['ms'] / k2_ms:.2%} of it; at the unfused "
        f"fp32 rate {b['unfused_ms']:.4f} ms; all 46 operations a test {b['all46_ms']:.4f} ms")
    return err, dict(ms=k2_ms, kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=b["ms"],
                     bound_by=b["by"], bound_all46_ms=b["all46_ms"])


def mesh_batches(scene, make_wavefront, shapes_mod, warp, spawn_ray):
    """The mesh scene's bounce-0 camera rays, the shadow rays of their NEE
    toward the light, and one incoherent bounce-1 batch (cosine-weighted
    directions off the bounce-0 hits), each [n] with disabled lanes where
    the camera ray missed."""
    n = scene.film.n_pixels * MESH_SPP
    _, ray, _, _, _ = make_wavefront(scene, 0, 0, n, 0, MESH_SPP, MESH_SPP)
    geom = scene.geometry.refresh()
    si = shapes_mod.compute_surface_interaction(
        geom, ray, shapes_mod.ray_intersect_preliminary(geom, ray))
    gen = torch.Generator(device=ray.o.device).manual_seed(1)
    u = torch.rand(n, 5, generator=gen, device=ray.o.device)
    ds, _ = scene.sample_emitter_direction(si.p, u[:, 0], u[:, 1:3], si.is_valid,
                                           test_visibility=False)
    shadow = spawn_ray(si.p, si.n, ds.d, maxt=ds.dist * (1.0 - 1e-3))
    s_maxt = torch.where(si.is_valid & (ds.pdf > 0), shadow.maxt, -float("inf"))
    bounce = spawn_ray(si.p, si.n, si.to_world(warp.square_to_cosine_hemisphere(u[:, 3:5])))
    b_maxt = torch.where(si.is_valid, bounce.maxt, -float("inf"))
    c = lambda x: x.contiguous()
    return (geom, (c(ray.o), c(ray.d), c(ray.maxt)), (c(shadow.o), c(shadow.d), c(s_maxt)),
            (c(bounce.o), c(bounce.d), c(b_maxt)))


def special_maxt(maxt):
    """maxt with every fifth lane 0, -1.5, -inf and NaN in turn (disabled
    lanes, whose t must come back as their maxt bit for bit), the fifth as
    it was."""
    m = maxt.clone()
    m[0::5], m[1::5], m[2::5], m[3::5] = 0.0, -1.5, -float("inf"), float("nan")
    return m


def phase_k2(mi, K1, K2, native, tmp):
    """K2 against its plain walk on a random soup, and against it and timed
    on the mesh scene's whole batches: the bounce-0 camera rays and one
    incoherent bounce-1 batch (closest hit), and the bounce-0 shadow rays
    (any hit); held against it in both modes on the bounce-1 batch with 90%
    of its lanes disabled at random and on the camera batch with special
    maxt lanes (0, negative, -inf, NaN)."""
    from mitsuba_tpu_torch.core import warp
    from mitsuba_tpu_torch.render import shapes as shapes_mod
    from mitsuba_tpu_torch.render.records import spawn_ray
    from mitsuba_tpu_torch.render.scene_loader import mesh_scene
    from mitsuba_tpu_torch.render_api import make_wavefront

    t0 = time.perf_counter()
    scene = mi.load_dict(mesh_scene(tmp / "sphere.obj", k=MESH_K, res=MESH_RES))
    geom = scene.geometry
    log(f"== mesh scene: {time.perf_counter() - t0:.2f} s to write and load, "
        f"{geom.n_tris} triangle rows, BVH {tuple(geom.bvh_nodes.shape)} nodes, "
        f"has_bvh {geom.has_bvh}, on {geom.bvh_nodes.device}")
    if not geom.has_bvh or geom.bvh_nodes.device.type != "cuda":
        raise AssertionError("mesh scene: no BVH on the card")
    geom, cam, shadow, bounce = mesh_batches(scene, make_wavefront, shapes_mod, warp, spawn_ray)
    nodes, table = geom.bvh_nodes, K1.build_tri_table(geom)
    # a random soup of 16,384 triangles, 65,536 rays, half the lanes disabled
    s_table, s_o, s_d, s_maxt = random_soup(1 << 14, 1 << 16, 11, nodes.device)
    s_nodes, order = native.build_bvh_wide(s_table.cpu().numpy(), max_leaf=K2.MAX_WIDE_LEAF)
    s_nodes = torch.from_numpy(s_nodes).to(nodes.device)
    s_table = s_table[torch.from_numpy(order.astype(np.int64)).to(nodes.device)].contiguous()
    errs = [compare_k2("random soup", K2, s_nodes, s_table, s_o, s_d, s_maxt, anyhit)[0]
            for anyhit in (False, True)]
    scattered = (bounce[0], bounce[1], disable_share(bounce[2], 0.9, 5))
    special = (cam[0], cam[1], special_maxt(cam[2]))
    rows = geom.bvh_rows
    for name, batch in (("mesh bounce-1 batch, 90% of lanes disabled", scattered),
                        ("mesh camera batch, special maxt lanes", special)):
        errs += [compare_k2(name, K2, nodes, table, *batch, anyhit, rows)[0]
                 for anyhit in (False, True)]

    e0, closest = check_and_time_k2("mesh bounce-0 camera batch", K2, nodes, table, rows, *cam,
                                    anyhit=False)
    e1, bounce1 = check_and_time_k2("mesh bounce-1 batch", K2, nodes, table, rows, *bounce,
                                    anyhit=False)
    e2, anyhit = check_and_time_k2("mesh bounce-0 shadow batch", K2, nodes, table, rows, *shadow,
                                   anyhit=True)
    return scene, max(errs + [e0, e1, e2]), closest, bounce1, anyhit


def render_mesh(mi, scene, spp, stats=None):
    img = mi.render(scene, spp=spp, seed=0, stats=stats)
    torch.cuda.synchronize()
    return img


def phase_mesh_main(mi, K1, K2, K3, scene, tmp):
    """The mesh main path at 256x256 @ 16 spp through mi.render; one more
    pass with CUDA events around each K2 launch; the 64x64 @ 16 spp render
    against the JAX package's means; the 64x64 @ 4 spp render through K2
    against the same render through the plain walk."""
    from mitsuba_tpu_torch.render import shapes as shapes_mod
    from mitsuba_tpu_torch.render.scene_loader import mesh_scene

    film = scene.film
    # warm-up at the measured pass's shapes, so that the counted pass and
    # the pass timed with events below pay no first-use costs; not counted
    render_mesh(mi, scene, MESH_SPP)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(K1, K2, K3)
    stats = {}
    t0 = time.perf_counter()
    img = render_mesh(mi, scene, MESH_SPP, stats)
    wall = time.perf_counter() - t0
    n_closest, n_any = K2.bvh_sweep_intersect.launches, K2.bvh_sweep_occluded.launches
    k1_launches = K1.smem_intersect.launches
    peak = torch.cuda.max_memory_allocated()
    means = img.mean(dim=(0, 1)).tolist()
    log(f"== main path: mesh {film.width}x{film.height} @ {MESH_SPP} spp: {wall:.3f} s wall, "
        f"{stats['n_rays']} rays, {stats['n_rays'] / wall / 1e6:.2f} Mrays/s, "
        f"peak memory {peak / 2**30:.2f} GiB, K2 launches {n_closest} closest-hit + {n_any} "
        f"any-hit, K1 launches {k1_launches}, means {means}")
    if tuple(img.shape) != (film.height, film.width, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"mesh main path: image of shape {tuple(img.shape)} is not finite")
    max_depth = scene.integrator.max_depth
    # one closest-hit launch per bounce, and one any-hit launch for each
    # bounce's shadow rays (no deferred NEE on a BVH)
    if (n_closest, n_any, k1_launches) != (max_depth, max_depth, 0):
        raise AssertionError(f"mesh main path: K2 launched {n_closest} + {n_any} times, K1 "
                             f"{k1_launches} times; expected {max_depth} + {max_depth} and 0")
    rel = [abs(m - r) / r for m, r in zip(means, JAX_MESH64_MEANS)]
    log(f"  channel means within {max(rel):.4%} of the JAX package's 64x64 means")
    if max(rel) > MEAN_RTOL:
        raise AssertionError(f"mesh main path: means {means} vs JAX {JAX_MESH64_MEANS}: {rel}")

    # where the pass spends its time: CUDA events around each K2 launch, and
    # its inputs, from which the plain walk counts its bound after the pass
    events = {"closest": [], "anyhit": []}

    def timed(fn, key):
        def wrapper(nodes, table, o, d, maxt, rows):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(nodes, table, o, d, maxt, rows)
            end.record()
            events[key].append((start, end, (nodes, table.detach(), o.detach().clone(),
                                              d.detach().clone(), maxt.clone())))
            return out
        return wrapper

    shapes_mod.bvh_sweep_intersect = timed(K2.bvh_sweep_intersect, "closest")
    shapes_mod.bvh_sweep_occluded = timed(K2.bvh_sweep_occluded, "anyhit")
    try:
        t0 = time.perf_counter()
        render_mesh(mi, scene, MESH_SPP)
        wall_t = time.perf_counter() - t0
    finally:
        shapes_mod.bvh_sweep_intersect = K2.bvh_sweep_intersect
        shapes_mod.bvh_sweep_occluded = K2.bvh_sweep_occluded
    k2_ms = {k: sum(s.elapsed_time(e) for s, e, _ in v) for k, v in events.items()}
    per = {k: [round(s.elapsed_time(e), 4) for s, e, _ in v] for k, v in events.items()}
    log(f"== mesh pass with K2 timed: {wall_t * 1e3:.1f} ms wall; K2 closest-hit "
        f"{k2_ms['closest']:.2f} ms ({per['closest']}), any-hit {k2_ms['anyhit']:.2f} ms "
        f"({per['anyhit']}); K2 {(k2_ms['closest'] + k2_ms['anyhit']) / (wall_t * 1e3):.2%} "
        f"of the pass's wall time")
    bound = {}
    for key, v in events.items():
        b = []
        for _, _, args in v:
            stats = {}
            K2.bvh_sweep_reference(*args, anyhit=key == "anyhit", stats=stats)
            b.append(k2_bound_ms(K2, args[0], args[1], args[4], stats)["ms"])
        bound[key] = sum(b)
        log(f"  {key} launches' active shares "
            f"{[round(float((a[4] > 0).float().mean()), 4) for _, _, a in v]}, bounds "
            f"{[round(x, 4) for x in b]}: summed {bound[key]:.4f} ms against {k2_ms[key]:.2f} ms")
    del events
    pass_entry = {k: dict(pass_launches=len(per[k]), pass_ms=k2_ms[k], pass_bound_ms=bound[k],
                          pass_all_ms=sum(k2_ms.values()), pass_all_bound_ms=sum(bound.values()))
                  for k in k2_ms}

    d64 = mesh_scene(tmp / "sphere64.obj", k=MESH_K, res=64)
    scene64 = mi.load_dict(d64)
    img64 = render_mesh(mi, scene64, MESH_SPP)
    means64 = img64.mean(dim=(0, 1)).tolist()
    rel64 = [abs(m - r) / r for m, r in zip(means64, JAX_MESH64_MEANS)]
    log(f"== mesh 64x64 @ {MESH_SPP} spp: means {means64}, within {max(rel64):.4%} of the JAX "
        f"package's (same samples)")
    if max(rel64) > MESH64_MEAN_RTOL:
        raise AssertionError(f"mesh 64x64: means {means64} vs JAX {JAX_MESH64_MEANS}: {rel64}")

    img_k = render_mesh(mi, scene64, 4)
    with plain_versions(K1, K2, K3):
        img_p = render_mesh(mi, scene64, 4)
    compare_images("mesh", img_k, img_p)
    return n_closest, n_any, pass_entry


# ---------------------------------------------------------------------------
# participating media: volpath through K1
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def no_plain_closest_hit(K1, name):
    """Inside, a call of K1's plain version (the closest hit without the
    kernel) is counted; leaving the block fails if there was one."""
    plain = K1.tri_intersect_reference
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    K1.tri_intersect_reference = counted
    try:
        yield
    finally:
        K1.tri_intersect_reference = plain
    if calls:
        raise AssertionError(f"{name}: the plain closest hit ran {len(calls)} times")


def k1_bits_differ(got, ref):
    """Elements of K1's (t, prim, u, v) whose bits differ from the plain
    version's, as a 0-d tensor on the card (no synchronisation)."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    return sum((bits(g) != bits(r)).sum() for g, r in zip(got, ref))


@contextlib.contextmanager
def k1_held_to_plain(K1, held):
    """Inside, every K1 call's result is held bit for bit against the plain
    version on the same inputs: `held` gets (lanes, differing elements as a
    0-d tensor) per call. The wrapper counts its launches on the module's
    name, so the count moves to the stand-in and back."""
    fn = K1.smem_intersect

    def wrapper(*args):
        out = fn(*args)
        held.append((args[1].shape[0], k1_bits_differ(out, K1.tri_intersect_reference(*args))))
        return out

    wrapper.launches = fn.launches
    K1.smem_intersect = wrapper
    try:
        yield
    finally:
        fn.launches = wrapper.launches
        K1.smem_intersect = fn


def k1_held_summary(name, held):
    """{"launches", "lanes", "differing"} of the calls k1_held_to_plain
    held; raises if one element differed."""
    differing = int(sum(d for _, d in held)) if held else 0
    out = dict(launches=len(held), lanes=sum(n for n, _ in held), differing=differing)
    log(f"  {name}: K1 held bit for bit against the plain version on the path's own inputs: "
        f"{out['launches']} launches, {out['lanes']} lanes, {differing} differing elements")
    if not held or differing:
        raise AssertionError(f"{name}: K1 against the plain version on the path's inputs: {out}")
    return out


def render_timed(mi, scene, spp, seed, stats=None):
    """(image, wall seconds) of one render ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = mi.render(scene, spp=spp, seed=seed, stats=stats)
    torch.cuda.synchronize()
    return img, time.perf_counter() - t0


def phase_hetvol(mi, K1, K2, K3):
    """The het-vol main path: HETVOL_PASSES warm passes at 96x96 @ 16 spp
    (Mrays/s and their spread, K1 launches, peak memory), the means against
    the JAX package's, one more pass with CUDA events around each K1 launch
    (summed time against summed bounds) whose inputs are kept and each held
    bit for bit against the plain version, and the 32x32 @ 4 spp render
    through K1 against the same render through the plain version."""
    from mitsuba_tpu_torch.render.scene_loader import het_vol_scene

    spp = 16
    scene = mi.load_dict(het_vol_scene(spp=spp))
    film = scene.film
    render_timed(mi, scene, 1, 1)                    # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    reset_launches(K1, K2, K3)
    walls, rays, per_pass = [], [], []
    for _ in range(HETVOL_PASSES):
        before = K1.smem_intersect.launches
        stats = {}
        with no_plain_closest_hit(K1, "het-vol"):
            img, wall = render_timed(mi, scene, spp, 0, stats)
        walls.append(wall)
        rays.append(stats["n_rays"])
        per_pass.append(K1.smem_intersect.launches - before)
        if tuple(img.shape) != (film.height, film.width, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"het-vol: image of shape {tuple(img.shape)} is not finite")
    launches = dict(K1=K1.smem_intersect.launches, K3=K3.mxu_intersect.launches,
                    K2=K2.bvh_sweep_intersect.launches + K2.bvh_sweep_occluded.launches)
    peak = torch.cuda.max_memory_allocated()
    mrays = [r / w / 1e6 for r, w in zip(rays, walls)]
    means = img.mean(dim=(0, 1)).tolist()
    log(f"== main path: het-vol {film.width}x{film.height} @ {spp} spp, volpath max_depth "
        f"{scene.integrator.max_depth}: {HETVOL_PASSES} warm passes {[round(w, 4) for w in walls]} "
        f"s wall, {rays[0]} rays a pass, {[round(m, 3) for m in mrays]} Mrays/s (spread "
        f"{min(mrays):.3f}-{max(mrays):.3f}, {(max(mrays) - min(mrays)) / min(mrays):.1%}); K1 "
        f"launches per pass {per_pass}; launches {launches}; peak memory {peak / 2**30:.3f} GiB; "
        f"means {means}")
    if launches["K1"] == 0 or launches["K2"] or launches["K3"]:
        raise AssertionError(f"het-vol: launches {launches}")
    rel = [abs(m - r) / r for m, r in zip(means, JAX_HETVOL_MEANS)]
    log(f"  channel means within {max(rel):.4%} of the JAX package's {JAX_HETVOL_MEANS}")
    if max(rel) > HETVOL_MEAN_RTOL:
        raise AssertionError(f"het-vol: means {means} vs JAX {JAX_HETVOL_MEANS}: {rel}")

    def work_and_inputs(*args):
        return k1_work(*args), [a.detach().clone() for a in args]

    timed = []
    with timed_launches(K1, "smem_intersect", work_and_inputs, timed):
        _, wall_t = render_timed(mi, scene, spp, 0)
    per = [(start.elapsed_time(end), k1_bound_ms(w)) for start, end, (w, _) in timed]
    k_ms = sum(m for m, _ in per)
    b_ms = sum(b["ms"] for _, b in per)
    active = [int(b["n_active"]) for _, b in per]
    # in place, an event pair also holds the host's time between the two
    # records when the card waits for the host; the same launches replayed
    # back to back give the kernel's own time
    inputs = [x for _, _, (_, x) in timed]
    b2b_ms = time_cuda(lambda: [K1.smem_intersect(*x) for x in inputs], reps=10)
    # every launch of the pass, on its own inputs, against the plain version
    bitwise = k1_held_summary("het-vol pass", [
        (x[1].shape[0], k1_bits_differ(K1.smem_intersect(*x), K1.tri_intersect_reference(*x)))
        for x in inputs])
    log(f"  one more pass with events around each K1 launch: {wall_t * 1e3:.1f} ms wall, "
        f"{len(per)} launches, {k_ms:.3f} ms in K1 in place ({k_ms / (sorted(walls)[len(walls) // 2] * 1e3):.2%} "
        f"of a warm pass's median wall), {b2b_ms:.4f} ms for the same launches back to back; "
        f"summed bound {b_ms:.4f} ms; active lanes per launch {active}; ms per launch in place "
        f"{[round(m, 4) for m, _ in per]}")
    del inputs, timed

    # the same dict with path regeneration: the same samples in another
    # schedule, so the same image up to the order of each pixel's sums
    scene_r = mi.load_dict(het_vol_scene(spp=spp, regenerate=True))
    before = K1.smem_intersect.launches
    stats_r = {}
    with no_plain_closest_hit(K1, "het-vol regenerate"):
        img_r, wall_r = render_timed(mi, scene_r, spp, 0, stats_r)
    k1_regen = K1.smem_intersect.launches - before
    close = torch.isclose(img_r, img, rtol=REGEN_RTOL, atol=REGEN_ATOL)
    log(f"== het-vol with regenerate: {wall_r:.3f} s wall (first render), {stats_r['n_rays']} "
        f"rays, {stats_r['wavefront_iters']} iterations, K1 launches {k1_regen}; against the "
        f"wavefront image {close.float().mean().item():.5%} of values within rtol {REGEN_RTOL} / "
        f"atol {REGEN_ATOL}")
    if k1_regen == 0 or not bool(close.all()):
        raise AssertionError("het-vol regenerate: no K1 launch, or the image differs")

    scene32 = mi.load_dict(het_vol_scene(res=32, spp=4))
    img_k = mi.render(scene32, spp=4, seed=0)
    with plain_versions(K1, K2, K3):
        img_p = mi.render(scene32, spp=4, seed=0)
    if not torch.equal(img_k, img_p):
        raise AssertionError("het-vol 32x32: the render through K1 differs from the plain one")
    log("== het-vol 32x32 @ 4 spp, kernel vs plain render: bitwise equal")
    return dict(walls=walls, rays=rays, mrays=mrays, k1_per_pass=per_pass, peak=peak,
                means=means, k1_pass_launches=len(per), k1_pass_ms=k_ms,
                k1_pass_back_to_back_ms=b2b_ms, k1_pass_bound_ms=b_ms, regen_wall=wall_r,
                regen_iters=stats_r["wavefront_iters"], k1_regen=k1_regen,
                k1_bitwise_vs_plain=bitwise)


def phase_vol32(mi, K1, K2, K3):
    """bench.py's vol32 cell: the wavefront render and the regenerative one
    at 128x128 @ 16 spp, each one warm-up and two timed renders (best of
    two, as bench.py), the regenerative image held to the wavefront's; then
    one more render of each with every K1 launch held bit for bit against
    the plain version on the same inputs."""
    from mitsuba_tpu_torch.render.scene_loader import vol32_scene

    spp = 16
    out = {}
    for regen in (False, True):
        scene = mi.load_dict(vol32_scene(spp=spp, regenerate=regen))
        img0, _ = render_timed(mi, scene, spp, 0)
        reset_launches(K1, K2, K3)
        timed = []
        for seed in (1, 2):
            stats = {}
            with no_plain_closest_hit(K1, f"vol32 regenerate={regen}"):
                _, wall = render_timed(mi, scene, spp, seed, stats)
            timed.append((wall, stats))
        n_k1 = K1.smem_intersect.launches // 2
        if n_k1 == 0 or K2.bvh_sweep_intersect.launches or K3.mxu_intersect.launches:
            raise AssertionError(f"vol32 regenerate={regen}: K1 launched {n_k1} times a render")
        best, stats = min(timed, key=lambda x: x[0])
        held = []
        with k1_held_to_plain(K1, held):
            mi.render(scene, spp=spp, seed=1)
        bitwise = k1_held_summary(f"vol32 regenerate={regen}", held)
        out[regen] = dict(img=img0, wall=best, walls=[w for w, _ in timed], stats=stats, k1=n_k1,
                          bitwise=bitwise)
        log(f"== vol32 {scene.film.width}x{scene.film.height} @ {spp} spp, volpath max_depth "
            f"{scene.integrator.max_depth}, regenerate={regen}: walls "
            f"{[round(w, 4) for w, _ in timed]} s, best {best:.4f} s, {stats['n_rays']} rays "
            f"({stats['n_rays'] / best / 1e6:.3f} Mrays/s), K1 launches per render {n_k1}"
            + (f", wavefront iterations {stats['wavefront_iters']} "
               f"({best / stats['wavefront_iters'] * 1e3:.2f} ms each)" if regen else ""))
    std, reg = out[False], out[True]
    speedup = std["wall"] / reg["wall"]
    close = torch.isclose(reg["img"], std["img"], rtol=REGEN_RTOL, atol=REGEN_ATOL)
    log(f"  vol32_regen_speedup {speedup:.4f} (wavefront {std['wall']:.4f} s / regenerate "
        f"{reg['wall']:.4f} s); regenerate vs wavefront image: {close.float().mean().item():.5%} "
        f"of values within rtol {REGEN_RTOL} / atol {REGEN_ATOL}, max abs diff "
        f"{(reg['img'] - std['img']).abs().max().item():.3e}")
    if not bool(close.all()):
        raise AssertionError("vol32: the regenerative image differs from the wavefront image")
    return dict(std_wall=std["wall"], std_walls=std["walls"], regen_wall=reg["wall"],
                regen_walls=reg["walls"], speedup=speedup,
                regen_iters=reg["stats"]["wavefront_iters"], std_rays=std["stats"]["n_rays"],
                regen_rays=reg["stats"]["n_rays"], k1_std=std["k1"], k1_regen=reg["k1"],
                k1_bitwise_vs_plain={"wavefront": std["bitwise"], "regenerate": reg["bitwise"]})


def profiled_launches(fn):
    """(kernel launches, device ms) of fn() under torch.profiler, or (None,
    None) where the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not rows:
        return None, None
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in rows)
    return sum(e.count for e in rows), us / 1e3


def check_atmo_bake(mi, scene):
    """The config 4 scene's Mie phase, baked on the card when it was
    loaded, against the same bake on the CPU; returns the largest error of
    the four tables relative to max|M11|, and the bake's time on the card."""
    from mitsuba_tpu_torch.render.media import parse_phase
    from mitsuba_tpu_torch.render.scene_loader import atmo_scene

    spec = atmo_scene(ATMO_RES, ATMO_SPP)["atmo"]["phase"]["aerosol"]
    cpu = parse_phase(spec, [], "aerosol", ("p",), "cpu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = parse_phase(spec, [], "aerosol", ("p",), "cuda")
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    loaded = scene.phases[0].phase_b
    scale = float(cpu.m11.abs().max())
    err = 0.0
    for k in ("m11", "m12", "m33", "m34"):
        got, ref = getattr(loaded, k).cpu(), getattr(cpu, k)
        if not torch.equal(got, getattr(card, k).cpu()):
            raise AssertionError(f"atmo bake: the loaded {k} differs from a second bake on the card")
        err = max(err, float((got - ref).abs().max()) / scale)
        if not torch.allclose(got, ref, rtol=BAKE_RTOL, atol=BAKE_ATOL_REL * scale):
            raise AssertionError(f"atmo bake: {k} on the card vs the CPU: max abs diff "
                                 f"{float((got - ref).abs().max()):.3e} (max|M11| {scale:.3e})")
    log(f"== atmo: the Mie bake on the card ({bake_s * 1e3:.1f} ms, {cpu.nodes.shape[0]} "
        f"cosines x {spec['size_distr']['gauss_points']} radii) against the CPU bake: max error "
        f"{err:.3e} of max|M11| (rtol {BAKE_RTOL}, atol {BAKE_ATOL_REL} max|M11|)")
    return err, bake_s


def render_1_timed(mi, scene, spp, seed, stats=None):
    """(Stokes vector, wall seconds) of one render_1 ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = mi.render_1(scene, spp=spp, seed=seed, stats=stats)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_atmo(mi, K1, K2, K3):
    """BASELINE config 4 in the mono_polarized variant: the bake against
    the CPU's, one warm-up pass and ATMO_PASSES timed passes of render_1 at
    64x64 @ 64 spp (wall, Msamples/s = lanes / wall, K1 launches, peak
    memory), the Stokes vector against the JAX package's, one pass with
    CUDA events around each K1 launch, one under the profiler (all kernel
    launches), and one with every K1 launch held bit for bit against the
    plain version."""
    from mitsuba_tpu_torch.render.scene_loader import atmo_scene

    mi.set_variant("mono_polarized")
    try:
        scene = mi.load_dict(atmo_scene(ATMO_RES, ATMO_SPP))
        bake_err, bake_s = check_atmo_bake(mi, scene)
        lanes = scene.film.n_pixels * ATMO_SPP
        render_1_timed(mi, scene, ATMO_SPP, 1)           # warm-up, not counted
        torch.cuda.reset_peak_memory_stats()
        reset_launches(K1, K2, K3)
        walls, per_pass, stats = [], [], {}
        for _ in range(ATMO_PASSES):
            before = K1.smem_intersect.launches
            stats = {}
            with no_plain_closest_hit(K1, "atmo"):
                stokes, wall = render_1_timed(mi, scene, ATMO_SPP, 0, stats)
            walls.append(wall)
            per_pass.append(K1.smem_intersect.launches - before)
        launches = dict(K1=K1.smem_intersect.launches, K3=K3.mxu_intersect.launches,
                        K2=K2.bvh_sweep_intersect.launches + K2.bvh_sweep_occluded.launches)
        peak = torch.cuda.max_memory_allocated()
        if launches["K1"] == 0 or launches["K2"] or launches["K3"] or len(set(per_pass)) != 1:
            raise AssertionError(f"atmo: launches {launches}, K1 per pass {per_pass}")
        if tuple(stokes.shape) != (4, 1) or not bool(torch.isfinite(stokes).all()):
            raise AssertionError(f"atmo: Stokes vector {stokes.tolist()}")
        I, Q, U, V = stokes[:, 0].tolist()
        msamples = [lanes / w / 1e6 for w in walls]
        log(f"== main path: atmo (config 4, mono_polarized) {ATMO_RES}x{ATMO_RES} @ {ATMO_SPP} "
            f"spp, {lanes} lanes, volpath max_depth {scene.integrator.max_depth}: "
            f"{ATMO_PASSES} warm passes {[round(w, 4) for w in walls]} s wall, "
            f"{[round(m, 4) for m in msamples]} Msamples/s, {stats['n_rays']} rays a pass; K1 "
            f"launches per pass {per_pass}; launches {launches}; peak memory "
            f"{peak / 2**30:.3f} GiB; Stokes {[I, Q, U, V]}")
        rel_i = abs(I - JAX_ATMO_STOKES[0]) / JAX_ATMO_STOKES[0]
        quv = [abs(a - b) / I for a, b in zip((Q, U, V), JAX_ATMO_STOKES[1:])]
        dolp = (Q * Q + U * U + V * V) ** 0.5 / I
        log(f"  against the JAX package's {JAX_ATMO_STOKES}: I within {rel_i:.3e} (rtol "
            f"{ATMO_I_RTOL}), Q/U/V within {[f'{x:.3e}' for x in quv]} of I (atol "
            f"{ATMO_QUV_ATOL} I); DoLP {dolp:.4f}")
        if rel_i > ATMO_I_RTOL or max(quv) > ATMO_QUV_ATOL or not 0.0 < dolp < 1.0:
            raise AssertionError(f"atmo: Stokes {[I, Q, U, V]} vs JAX {JAX_ATMO_STOKES}")

        def work_and_inputs(*args):
            return k1_work(*args), [a.detach().clone() for a in args]

        timed = []
        with timed_launches(K1, "smem_intersect", work_and_inputs, timed):
            _, wall_t = render_1_timed(mi, scene, ATMO_SPP, 0)
        per = [(start.elapsed_time(end), k1_bound_ms(w)) for start, end, (w, _) in timed]
        k_ms = sum(m for m, _ in per)
        b_ms = sum(b["ms"] for _, b in per)
        inputs = [x for _, _, (_, x) in timed]
        b2b_ms = time_cuda(lambda: [K1.smem_intersect(*x) for x in inputs], reps=10)
        del inputs, timed
        n_launch, device_ms = profiled_launches(lambda: mi.render_1(scene, spp=ATMO_SPP, seed=0))
        log(f"  one more pass with events around each K1 launch: {wall_t * 1e3:.1f} ms wall, "
            f"{len(per)} launches, {k_ms:.3f} ms in K1 in place, {b2b_ms:.4f} ms for the same "
            f"launches back to back; summed bound {b_ms:.4f} ms; active lanes per launch "
            f"{[int(b['n_active']) for _, b in per]}; one pass under the profiler: "
            + (f"{n_launch} kernel launches, {device_ms:.1f} ms of device time"
               if n_launch is not None else "no device activity seen (not measured)"))
        held = []
        with k1_held_to_plain(K1, held):
            mi.render_1(scene, spp=ATMO_SPP, seed=0)
        bitwise = k1_held_summary("atmo pass", held)
    finally:
        mi.set_variant("rgb")
    return dict(walls=walls, msamples=msamples, lanes=lanes, rays=stats["n_rays"],
                k1_per_pass=per_pass, peak=peak, stokes=[I, Q, U, V], dolp=dolp,
                stokes_rel_err_i=rel_i, stokes_err_quv_over_i=quv, bake_err=bake_err,
                bake_s=bake_s, k1_pass_launches=len(per), k1_pass_ms=k_ms,
                k1_pass_back_to_back_ms=b2b_ms, k1_pass_bound_ms=b_ms,
                pass_kernel_launches=n_launch, pass_device_ms=device_ms,
                k1_bitwise_vs_plain=bitwise)


# ---------------------------------------------------------------------------
# inverse radiative transfer: the volumetric PRB replays through K1
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def backward_marks(cls, K1, marks, method="sample_backward"):
    """Inside, K1's launch count is appended to `marks` as each call of
    cls.<method> (the replay: sample_backward, or regen_backward under
    path regeneration) begins and as it ends; the backward pass's own
    primal launches before it."""
    fn = getattr(cls, method)

    def wrapper(self, *args, **kw):
        marks.append(K1.smem_intersect.launches)
        out = fn(self, *args, **kw)
        marks.append(K1.smem_intersect.launches)
        return out

    setattr(cls, method, wrapper)
    try:
        yield
    finally:
        setattr(cls, method, fn)


def prb_vol_step(mi, scene, keys, loss, seed, K1=None):
    """One gradient step of `loss` (a scalar of the render) for `keys`:
    (loss, {key: gradient}, stats, wall seconds to a synchronise, and with
    K1 its launches (forward, backward primal, replay))."""
    params = mi.traverse(scene)
    leaves = {k: params[k].clone().requires_grad_() for k in keys}
    stats, marks = {}, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l0 = K1.smem_intersect.launches if K1 else 0
    out = loss(mi, params.update(leaves), seed, stats)
    l1 = K1.smem_intersect.launches if K1 else 0
    replay = "regen_backward" if scene.integrator.regenerate else "sample_backward"
    with (backward_marks(type(scene.integrator), K1, marks, replay) if K1
          else contextlib.nullcontext()):
        out.backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (l1 - l0, marks[0] - l1, marks[1] - marks[0]) if K1 else None
    return out.detach(), {k: v.grad for k, v in leaves.items()}, stats, wall, counts


def run_prb_vol(mi, K1, K2, K3, name, scene, keys, loss, lanes):
    """A PRB phase's main path: one warm-up step and PRB_VOL_STEPS timed
    ones at seed 0 (wall, rays, fwd+bwd Msamples/s as bench.py's 3 x lanes
    / wall, K1 launches of the forward, the backward's primal and the
    replay, peak memory), then one more step with every K1 launch held bit
    for bit against the plain version on its own inputs."""
    prb_vol_step(mi, scene, keys, loss, 1, K1)          # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    reset_launches(K1, K2, K3)
    steps = []
    for _ in range(PRB_VOL_STEPS):
        with no_plain_closest_hit(K1, name):
            out, grads, stats, wall, counts = prb_vol_step(mi, scene, keys, loss, 0, K1)
        if not bool(torch.isfinite(out)) or not all(
                bool(torch.isfinite(g).all()) and bool((g != 0).any()) for g in grads.values()):
            raise AssertionError(f"{name}: loss {out.item()}, gradients not finite or all 0")
        steps.append(dict(wall=wall, n_rays=stats["n_rays"], n_rays_grad=stats["n_rays_grad"],
                          k1=counts, loss=out.item(), grads=grads))
    launches = dict(K1=K1.smem_intersect.launches, K3=K3.mxu_intersect.launches,
                    K2=K2.bvh_sweep_intersect.launches + K2.bvh_sweep_occluded.launches)
    peak = torch.cuda.max_memory_allocated()
    if launches["K2"] or launches["K3"] or any(min(st["k1"]) == 0 for st in steps):
        raise AssertionError(f"{name}: launches {launches}, K1 per step "
                             f"{[st['k1'] for st in steps]}")
    for i, st in enumerate(steps):
        rays = st["n_rays"] + st["n_rays_grad"]
        log(f"== main path: {name}, step {i}: {st['wall']:.4f} s wall, rays forward "
            f"{st['n_rays']} + backward {st['n_rays_grad']} = {rays} "
            f"({rays / st['wall'] / 1e6:.4f} Mrays/s fwd+bwd), "
            f"{3 * lanes / st['wall'] / 1e6:.4f} Msamples/s fwd+bwd (bench.py's 3 x {lanes} "
            f"lanes / wall); K1 launches forward / backward primal / replay {st['k1']}; "
            f"loss {st['loss']!r}")
    log(f"  {name}: {PRB_VOL_STEPS} steps, launches {launches}, peak memory {peak / 2**30:.3f} GiB")
    held = []
    with k1_held_to_plain(K1, held):
        prb_vol_step(mi, scene, keys, loss, 0)
    bitwise = k1_held_summary(f"{name} step", held)

    def work_and_inputs(*args):
        return k1_work(*args), [a.detach().clone() for a in args]

    timed = []
    with timed_launches(K1, "smem_intersect", work_and_inputs, timed):
        prb_vol_step(mi, scene, keys, loss, 0)
    per = [(start.elapsed_time(end), k1_bound_ms(w)) for start, end, (w, _) in timed]
    k_ms = sum(m for m, _ in per)
    b_ms = sum(b["ms"] for _, b in per)
    inputs = [x for _, _, (_, x) in timed]
    b2b_ms = time_cuda(lambda: [K1.smem_intersect(*x) for x in inputs], reps=5)
    del inputs, timed
    log(f"  {name}: one more step with events around each K1 launch: {len(per)} launches, "
        f"{k_ms:.3f} ms in K1 in place ({k_ms / (min(st['wall'] for st in steps) * 1e3):.3%} of "
        f"the fastest step's wall), {b2b_ms:.4f} ms for the same launches back to back; summed "
        f"bound {b_ms:.4f} ms")
    first = steps[0]
    return dict(walls=[st["wall"] for st in steps], n_rays=first["n_rays"],
                n_rays_grad=first["n_rays_grad"], lanes=lanes,
                msamples=[3 * lanes / st["wall"] / 1e6 for st in steps],
                mrays=[(st["n_rays"] + st["n_rays_grad"]) / st["wall"] / 1e6 for st in steps],
                k1_forward=first["k1"][0], k1_backward_primal=first["k1"][1],
                k1_replay=first["k1"][2], k1_per_step=sum(first["k1"]), peak=peak,
                loss=first["loss"], grads=first["grads"], k1_bitwise_vs_plain=bitwise,
                k1_step_ms=k_ms, k1_step_back_to_back_ms=b2b_ms, k1_step_bound_ms=b_ms)


def prb_vol_plain_check(mi, K1, K2, K3, name, scene, keys, loss, grid_key=None):
    """A reduced step through K1 and through K1's plain version, on the
    card: the loss and every scalar gradient bitwise; a grid's gradient
    (accumulated with atomics) within GRID_PLAIN_TOL of its L2 norm."""
    out_k, g_k, _, _, _ = prb_vol_step(mi, scene, keys, loss, 0)
    with plain_versions(K1, K2, K3):
        out_p, g_p, _, _, _ = prb_vol_step(mi, scene, keys, loss, 0)
    same = {k: bool(torch.equal(g_k[k], g_p[k])) for k in keys}
    grid_rel = None
    if grid_key is not None:
        grid_rel = float((g_k[grid_key] - g_p[grid_key]).norm() / g_p[grid_key].norm())
    log(f"== {name}, kernel vs plain route: loss bitwise {torch.equal(out_k, out_p)}, gradients "
        f"bitwise {same}" + (f"; {grid_key} within {grid_rel:.3e} of its L2 norm (tolerance "
                             f"{GRID_PLAIN_TOL})" if grid_key else ""))
    if not torch.equal(out_k, out_p) or not all(v for k, v in same.items() if k != grid_key):
        raise AssertionError(f"{name}: the kernel route differs from the plain route: {same}")
    if grid_key is not None and not grid_rel <= GRID_PLAIN_TOL:
        raise AssertionError(f"{name}: {grid_key} {grid_rel:.3e} of its norm from the plain route")
    return dict(loss_bitwise=True, grads_bitwise=same, grid_rel_to_plain=grid_rel)


def check_rel(name, got, want, rtol):
    rel = abs(got - want) / abs(want)
    log(f"  {name}: {got!r} against the JAX package's {want!r}: {rel:.3e} relative (rtol {rtol})")
    if not rel <= rtol:
        raise AssertionError(f"{name}: {got} vs JAX {want}")
    return rel


def render_1_sum(mi, scene, spp, seed, stats):
    return mi.render_1(scene, spp=spp, seed=seed, stats=stats).sum()


def phase_aos_prb(mi, K1, K2, K3):
    """BASELINE config 5 (bench.py:268-312's dict): the gradient of
    sum(render_1) at 32x32 @ 64 spp for the atmosphere's sigma_t, through
    prb_volpathaos in mono_polarized, against the JAX package's; volpathaos
    render_1 of the same dict against the JAX package's Stokes vector; an
    8x8 @ 16 spp step through K1 against the plain route."""
    from mitsuba_tpu_torch.render.scene_loader import aos_scene

    key = "atmo_medium.sigma_t.value.value"
    mi.set_variant("mono_polarized")
    try:
        def loss(mi, sc, seed, stats, spp=AOS_SPP):
            return render_1_sum(mi, sc, spp, seed, stats)

        scene = mi.load_dict(aos_scene(AOS_RES))
        out = run_prb_vol(mi, K1, K2, K3, f"aos-prb (config 5) {AOS_RES}x{AOS_RES} @ {AOS_SPP} "
                          "spp, prb_volpathaos max_depth 4", scene, [key], loss,
                          AOS_RES * AOS_RES * AOS_SPP)
        out["grad"] = float(out.pop("grads")[key])
        out["grad_rel_err"] = check_rel("aos-prb d sum(render_1) / d sigma_t", out["grad"],
                                        JAX_AOS_GRAD, PRB_VOL_GRAD_RTOL)
        fwd = mi.load_dict(aos_scene(AOS_RES, integrator="volpathaos"))
        render_1_timed(mi, fwd, AOS_SPP, 1)
        stats = {}
        with no_plain_closest_hit(K1, "aos volpathaos"):
            stokes, wall = render_1_timed(mi, fwd, AOS_SPP, 0, stats)
        if tuple(stokes.shape) != (4, 1) or not bool(torch.isfinite(stokes).all()):
            raise AssertionError(f"aos volpathaos: Stokes vector {stokes.tolist()}")
        I, Q, U, V = stokes[:, 0].tolist()
        rel_i = abs(I - JAX_AOS_STOKES[0]) / JAX_AOS_STOKES[0]
        quv = [abs(a - b) / I for a, b in zip((Q, U, V), JAX_AOS_STOKES[1:])]
        log(f"== aos volpathaos render_1 {AOS_RES}x{AOS_RES} @ {AOS_SPP} spp: {wall:.4f} s wall, "
            f"{stats['n_rays']} rays, Stokes {[I, Q, U, V]} against the JAX package's "
            f"{JAX_AOS_STOKES}: I within {rel_i:.3e}, Q/U/V within "
            f"{[f'{x:.3e}' for x in quv]} of I (tolerance {AOS_STOKES_TOL}); the PRB step's "
            f"primal sum {out['loss']!r}")
        if rel_i > AOS_STOKES_TOL or max(quv) > AOS_STOKES_TOL:
            raise AssertionError(f"aos volpathaos: Stokes {[I, Q, U, V]} vs JAX {JAX_AOS_STOKES}")
        out.update(stokes=[I, Q, U, V], stokes_rel_err_i=rel_i, stokes_err_quv_over_i=quv,
                   forward_wall=wall)
        small = mi.load_dict(aos_scene(8))
        out["plain"] = prb_vol_plain_check(mi, K1, K2, K3, "aos-prb 8x8 @ 16 spp", small, [key],
                                           lambda mi, sc, seed, st: loss(mi, sc, seed, st, 16))
    finally:
        mi.set_variant("rgb")
    return out


def phase_atmo_prb(mi, K1, K2, K3):
    """The polarized atmosphere (config 4's scene) inverted: prb, routed to
    prb_polarized, max_depth 8, the gradient of sum(render_1) at 64x64 @ 64
    spp for the slab medium's sigma_t and albedo, against the JAX
    package's; a 16x16 @ 16 spp step through K1 against the plain route."""
    from mitsuba_tpu_torch.ad.prb_polarized import PRBPolarizedVolpathIntegrator
    from mitsuba_tpu_torch.render.scene_loader import atmo_scene

    keys = ["atmo.sigma_t.value.value", "atmo.albedo.value.value"]
    mi.set_variant("mono_polarized")
    try:
        def prb_atmo(res, spp):
            d = atmo_scene(res, spp)
            d["integrator"]["type"] = "prb"
            return mi.load_dict(d)

        def loss(mi, sc, seed, stats, spp=ATMO_SPP):
            return render_1_sum(mi, sc, spp, seed, stats)

        scene = prb_atmo(ATMO_RES, ATMO_SPP)
        if type(scene.integrator) is not PRBPolarizedVolpathIntegrator:
            raise AssertionError(f"atmo-prb: prb routed to {type(scene.integrator).__name__}")
        out = run_prb_vol(mi, K1, K2, K3, f"atmo-prb {ATMO_RES}x{ATMO_RES} @ {ATMO_SPP} spp, "
                          "prb_polarized max_depth 8", scene, keys, loss,
                          ATMO_RES * ATMO_RES * ATMO_SPP)
        grads = out.pop("grads")
        out["grads"] = {k: float(grads[k]) for k in keys}
        out["grad_rel_err"] = {k: check_rel(f"atmo-prb d sum(render_1) / d {k}", out["grads"][k],
                                            want, PRB_VOL_GRAD_RTOL)
                               for k, want in zip(keys, JAX_ATMO_PRB_GRAD)}
        out["plain"] = prb_vol_plain_check(mi, K1, K2, K3, "atmo-prb 16x16 @ 16 spp",
                                           prb_atmo(16, 16), keys,
                                           lambda mi, sc, seed, st: loss(mi, sc, seed, st, 16))
    finally:
        mi.set_variant("rgb")
    return out


def phase_hetvol_prb(mi, K1, K2, K3):
    """The cloud-extinction half of config 5: het_vol_scene (96x96 @ 16
    spp, the 32^3 grid) with prbvolpath max_depth 12, the gradient of the
    image mean for the grid's sigma_t and the albedo; the grid's gradient
    sum and largest voxels and the albedo's against the JAX package's; a
    16x16 @ 4 spp step through K1 against the plain route."""
    from mitsuba_tpu_torch.render.scene_loader import het_vol_scene

    grid_key = "cloud.interior_medium.sigma_t.data"
    albedo_key = "cloud.interior_medium.albedo.value"
    keys = [grid_key, albedo_key]

    def prb_het(res, spp):
        d = het_vol_scene(res=res, spp=spp)
        d["integrator"]["type"] = "prbvolpath"
        return mi.load_dict(d)

    def loss(mi, sc, seed, stats, spp=HETVOL_PRB_SPP):
        return mi.render(sc, spp=spp, seed=seed, stats=stats).mean()

    res = HETVOL_PRB_RES
    scene = prb_het(res, HETVOL_PRB_SPP)
    out = run_prb_vol(mi, K1, K2, K3, f"hetvol-prb {res}x{res} @ {HETVOL_PRB_SPP} spp, "
                      "prbvolpath max_depth 12", scene, keys, loss, res * res * HETVOL_PRB_SPP)
    grads = out.pop("grads")
    g = grads[grid_key].reshape(-1).double()
    top_idx = [i for i, _ in JAX_HETVOL_GRID_TOP]
    out["grid_sum"] = float(g.sum())
    out["grid_top"] = g[top_idx].tolist()
    out["albedo_grad"] = float(grads[albedo_key])
    out["grid_sum_rel_err"] = check_rel("hetvol-prb grid gradient sum", out["grid_sum"],
                                        JAX_HETVOL_GRID_SUM, PRB_VOL_GRAD_RTOL)
    out["grid_top_rel_err"] = [check_rel(f"hetvol-prb grid gradient at voxel {i}", got, want,
                                         PRB_VOL_VOXEL_RTOL)
                               for (i, want), got in zip(JAX_HETVOL_GRID_TOP, out["grid_top"])]
    out["albedo_rel_err"] = check_rel("hetvol-prb albedo gradient", out["albedo_grad"],
                                      JAX_HETVOL_ALBEDO_GRAD, PRB_VOL_GRAD_RTOL)
    out["plain"] = prb_vol_plain_check(mi, K1, K2, K3, "hetvol-prb 16x16 @ 4 spp", prb_het(16, 4),
                                       keys, lambda mi, sc, seed, st: loss(mi, sc, seed, st, 4),
                                       grid_key=grid_key)
    return out


# ---------------------------------------------------------------------------
# regenerative inverse rendering: the regenerative PRB replays through K1
# ---------------------------------------------------------------------------

def regen_check(name, got, want, rtol):
    """Each gradient of `got` within rtol (relative to its largest
    element) of `want`'s, the wavefront step's at the same seeds (the
    reference's bound between the two schedules); returns the worst
    relative difference."""
    worst = 0.0
    for k in want:
        diff = float((got[k] - want[k]).abs().max() / want[k].abs().max())
        log(f"  {name} d/d {k}: regenerate {got[k].reshape(-1)[:3].tolist()} against the "
            f"wavefront step's {want[k].reshape(-1)[:3].tolist()}: {diff:.3e} relative "
            f"(rtol {rtol})")
        if not bool(torch.isfinite(got[k]).all()) or not diff <= rtol:
            raise AssertionError(f"{name}: the regenerative gradient of {k} is {diff:.3e} "
                                 "from the wavefront step's")
        worst = max(worst, diff)
    return worst


def image_loss(images, spp):
    """loss(mi, scene, seed, stats) = the mean of the render, which it keeps
    in `images`."""
    def loss(mi, sc, seed, stats):
        img = mi.render(sc, spp=spp, seed=seed, stats=stats)
        images.append(img.detach())
        return img.mean()
    return loss


def phase_vol32_regen_prb(mi, K1, K2, K3):
    """This slice's main path: bench.py's vol32 dict (a homogeneous slab,
    128x128 @ 16 spp, max_depth 32) with prbvolpath and regenerate: the
    gradient of the image mean for the slab's sigma_t and albedo. One
    warm-up step with events around each K1 launch and every launch held
    bit for bit against the plain version (outside the events), one timed
    step (wall, the three loops' iterations, K1 launches in each, rays,
    fwd+bwd Mrays/s, peak memory); the gradients and the image against the
    same dict's wavefront prbvolpath step at the same seeds."""
    from mitsuba_tpu_torch.render.scene_loader import vol32_scene

    spp = 16
    keys = ["slab.interior_medium.sigma_t.value.value", "slab.interior_medium.albedo.value.value"]

    def scene_for(regen):
        d = vol32_scene(spp=spp, regenerate=regen)
        d["integrator"]["type"] = "prbvolpath"
        return mi.load_dict(d)

    scene = scene_for(True)
    name = (f"vol32-regen-prb {scene.film.width}x{scene.film.height} @ {spp} spp, prbvolpath "
            f"max_depth {scene.integrator.max_depth}, regenerate")
    images = []
    loss = image_loss(images, spp)

    def work(*args):
        return k1_work(*args)

    held, timed = [], []
    # the held wrapper calls the timed one, so the events hold K1 alone
    with timed_launches(K1, "smem_intersect", work, timed), k1_held_to_plain(K1, held):
        _, _, _, warm_wall, _ = prb_vol_step(mi, scene, keys, loss, 0)
    bitwise = k1_held_summary(f"{name} (warm-up step)", held)
    per = [(start.elapsed_time(end), k1_bound_ms(w)) for start, end, w in timed]
    k_ms = sum(m for m, _ in per)
    b_ms = sum(b["ms"] for _, b in per)
    del held, timed, per
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(K1, K2, K3)
    with no_plain_closest_hit(K1, name):
        out, grads, stats, wall, counts = prb_vol_step(mi, scene, keys, loss, 0, K1)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(K1=K1.smem_intersect.launches, K3=K3.mxu_intersect.launches,
                    K2=K2.bvh_sweep_intersect.launches + K2.bvh_sweep_occluded.launches)
    img = images[-1]
    iters = (stats["wavefront_iters"], stats["wavefront_iters_grad"],
             stats["wavefront_iters_replay"])
    rays = stats["n_rays"] + stats["n_rays_grad"]
    log(f"== main path: {name}: warm-up step (K1 held to plain) {warm_wall:.3f} s, timed step "
        f"{wall:.4f} s wall; wavefront iterations forward / backward primal / replay {iters}; "
        f"K1 launches forward / backward primal / replay {counts}; rays forward "
        f"{stats['n_rays']} + backward {stats['n_rays_grad']} = {rays} "
        f"({rays / wall / 1e6:.4f} Mrays/s fwd+bwd); peak memory {peak / 2**30:.3f} GiB; "
        f"launches {launches}; loss {out.item()!r}")
    if (launches["K2"] or launches["K3"] or min(counts) == 0 or iters[1] != iters[2]
            or not bool(torch.isfinite(img).all())):
        raise AssertionError(f"{name}: launches {launches}, K1 {counts}, iterations {iters}")
    log(f"  {name}: the warm-up step's K1 launches with events around each: {k_ms:.3f} ms in "
        f"K1 in place ({k_ms / (wall * 1e3):.3%} of the timed step's wall); summed bound "
        f"{b_ms:.4f} ms")

    wave = scene_for(False)
    wave_images = []
    wave_loss = image_loss(wave_images, spp)
    prb_vol_step(mi, wave, keys, wave_loss, 1)           # warm-up, not counted
    with no_plain_closest_hit(K1, "vol32 wavefront prbvolpath"):
        out_w, grads_w, stats_w, wall_w, counts_w = prb_vol_step(mi, wave, keys, wave_loss, 0,
                                                                 K1)
    img_w = wave_images[-1]
    close = torch.isclose(img, img_w, rtol=REGEN_RTOL, atol=REGEN_ATOL)
    log(f"  vol32 wavefront prbvolpath step at the same seeds: {wall_w:.4f} s wall, K1 "
        f"{counts_w}, rays {stats_w['n_rays']} + {stats_w['n_rays_grad']}; the regenerative "
        f"step takes {wall / wall_w:.2f}x its wall; images: {close.float().mean().item():.5%} "
        f"of values within rtol {REGEN_RTOL} / atol {REGEN_ATOL}")
    if not bool(close.all()) or (stats["n_rays"], stats["n_rays_grad"]) != (
            stats_w["n_rays"], stats_w["n_rays_grad"]):
        raise AssertionError(f"{name}: the primal image or the rays differ from the wavefront "
                             "step's")
    worst = regen_check(name, grads, grads_w, REGEN_GRAD_RTOL)
    return dict(wall=wall, warm_wall=warm_wall, iters=iters, k1=counts, k1_per_step=sum(counts),
                n_rays=stats["n_rays"], n_rays_grad=stats["n_rays_grad"],
                mrays=rays / wall / 1e6, peak=peak, loss=out.item(),
                grads={k: g.reshape(-1)[0].item() for k, g in grads.items()},
                grad_rel_to_wavefront=worst, wavefront_wall=wall_w, wavefront_k1=counts_w,
                k1_bitwise_vs_plain=bitwise, k1_step_ms=k_ms, k1_step_bound_ms=b_ms)


def rayleigh_slab(mi, integrator, regenerate, res, spp, radiance=1.0):
    """tests/test_regen.py:221-245's polarized scene: a thin Rayleigh slab
    (sigma_t 1, albedo 0.9) under a constant environment of `radiance`,
    max_depth 4."""
    return mi.load_dict({
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": 4, "regenerate": regenerate},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": [{"type": "look_at", "origin": [0, 0, 4], "target": [0, 0, 0],
                                 "up": [0, 1, 0]}],
                   "film": {"type": "hdrfilm", "width": res, "height": res,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "light": {"type": "constant", "radiance": radiance},
        "slab": {"type": "cube", "to_world": [{"type": "scale", "value": [1.0, 1.0, 0.3]}],
                 "bsdf": {"type": "null"},
                 "interior": {"type": "homogeneous", "sigma_t": 1.0, "albedo": 0.9,
                              "phase": {"type": "rayleigh"}}},
    })


def regen_vs_wavefront_step(mi, K1, name, make, keys, spp, held=None):
    """One regenerative PRB step of make(True) and one wavefront step of
    make(False) at the same seeds, each through K1 alone: the gradients
    against each other (REGEN_GRAD_RTOL); K1's launches of the
    regenerative step. With a list `held`, every K1 launch of the
    regenerative step is held bit for bit against the plain version
    (k1_held_to_plain) instead of only forbidding the plain route."""
    images = []
    loss = image_loss(images, spp)
    before = K1.smem_intersect.launches
    guard = no_plain_closest_hit(K1, name) if held is None else k1_held_to_plain(K1, held)
    with guard:
        _, grads, stats, wall, _ = prb_vol_step(mi, make(True), keys, loss, 0)
    k1 = K1.smem_intersect.launches - before
    _, grads_w, _, wall_w, _ = prb_vol_step(mi, make(False), keys, loss, 0)
    log(f"== {name}: regenerative step {wall:.3f} s (first call), wavefront {wall_w:.3f} s; "
        f"iterations forward / backward primal / replay ({stats['wavefront_iters']}, "
        f"{stats['wavefront_iters_grad']}, {stats['wavefront_iters_replay']}); K1 launches {k1}")
    if k1 == 0:
        raise AssertionError(f"{name}: no K1 launch")
    return dict(wall=wall, wavefront_wall=wall_w, k1=k1, iters=stats["wavefront_iters"],
                grad_rel_to_wavefront=regen_check(name, grads, grads_w, REGEN_GRAD_RTOL))


def phase_regen_prb(mi, K1, K2, K3):
    """Reduced regenerative steps, each against the same dict's wavefront
    step at the same seeds: the Cornell box with prb (64x64 @ 16 spp,
    max_depth 8, shadow rays in their own bounce); in mono_polarized the
    Rayleigh slab (64x64 @ 16 spp) with volpath (the Stokes image against
    the wavefront image, Q nonzero) and with prb_polarized (the albedo),
    and config 5's ocean (aos_scene(res=16), 4 spp: the loop's steps grow
    with the spp, not the lanes) with prb_volpathaos (the atmosphere's
    sigma_t)."""
    from mitsuba_tpu_torch.render.scene_loader import aos_scene

    out = {}

    def cbox(regen):
        d = prb_dict(mi, 64, 16, 8)
        d["integrator"].update(regenerate=regen, defer_nee=False)
        return mi.load_dict(d)

    out["cbox_prb"] = regen_vs_wavefront_step(mi, K1, "regen-prb cbox 64x64 @ 16 spp, prb "
                                              "max_depth 8", cbox, [KEY], 16)
    mi.set_variant("mono_polarized")
    try:
        before = K1.smem_intersect.launches
        with no_plain_closest_hit(K1, "regen-prb polarized volpath"):
            img_r, wall_r = render_timed(mi, rayleigh_slab(mi, "volpath", True, 64, 16), 16, 0)
        k1 = K1.smem_intersect.launches - before
        img_w, _ = render_timed(mi, rayleigh_slab(mi, "volpath", False, 64, 16), 16, 0)
        close = torch.isclose(img_r, img_w, rtol=REGEN_RTOL, atol=REGEN_ATOL)
        q = float(img_w[..., 1, :].abs().max())
        log(f"== regen-prb polarized Rayleigh slab, volpath 64x64 @ 16 spp: regenerative "
            f"{wall_r:.3f} s, K1 launches {k1}, Stokes image {tuple(img_r.shape)}: "
            f"{close.float().mean().item():.5%} of values within rtol {REGEN_RTOL} / atol "
            f"{REGEN_ATOL} of the wavefront image; max |Q| {q:.4e}")
        if k1 == 0 or not bool(close.all()) or img_r.shape[-2:] != (4, 1) or q < 1e-4:
            raise AssertionError("regen-prb polarized volpath: the Stokes image differs")
        out["slab_volpath"] = dict(wall=wall_r, k1=k1, max_abs_q=q)
        out["slab_prb_polarized"] = regen_vs_wavefront_step(
            mi, K1, "regen-prb Rayleigh slab 64x64 @ 16 spp, prb_polarized",
            lambda r: rayleigh_slab(mi, "prb_polarized", r, 64, 16),
            ["slab.interior_medium.albedo.value.value"], 16)

        def ocean(regen):
            d = aos_scene(res=16)
            d["integrator"]["regenerate"] = regen
            return mi.load_dict(d)

        out["aos_prb"] = regen_vs_wavefront_step(
            mi, K1, "regen-prb aos 16x16 @ 4 spp, prb_volpathaos", ocean,
            ["atmo_medium.sigma_t.value.value"], 4)
    finally:
        mi.set_variant("rgb")
    return out


def phase_api(mi, K1, K2, K3):
    """The rest of render() on the cbox at 256x256 @ 64 spp: the integrator
    override against a scene loaded with that integrator, a cancelled
    CancelToken and timeout=0 against the first pass of spp_per_pass 8, and
    render_progressive's last image against render(spp_per_pass=8), each
    bitwise; prints the walls."""
    spp = 64
    d = prb_dict(mi, 256, spp, 8)
    d["integrator"] = {"type": "path", "max_depth": 8}
    scene = mi.load_dict(d)
    spec = {"type": "path", "max_depth": 4}
    walls = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = fn()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        return img

    with no_plain_closest_hit(K1, "api"):
        over = timed("integrator override", lambda: mi.render(scene, spp=spp, seed=0,
                                                              integrator=spec))
        loaded = timed("loaded with it", lambda: mi.render(mi.load_dict(dict(d, integrator=spec)),
                                                           spp=spp, seed=0))
        steps = []
        for step in mi.render_progressive(scene, spp=spp, spp_per_pass=8, seed=0):
            steps.append(step)
        full = timed("spp_per_pass 8", lambda: mi.render(scene, spp=spp, spp_per_pass=8, seed=0))
        tok = mi.CancelToken()
        tok.cancel()
        cancelled = timed("cancelled", lambda: mi.render(scene, spp=spp, spp_per_pass=8, seed=0,
                                                         cancel=tok))
        timeout0 = timed("timeout 0", lambda: mi.render(scene, spp=spp, seed=0, timeout=0.0))
    checks = {
        "override == loaded": torch.equal(over, loaded),
        "progressive passes": [s for s, _ in steps] == list(range(8, spp + 1, 8)),
        "progressive last == spp_per_pass 8": torch.equal(steps[-1][1], full),
        "cancelled == first pass": torch.equal(cancelled, steps[0][1]),
        "timeout 0 == first pass": torch.equal(timeout0, steps[0][1]),
        "first pass != full": not torch.equal(steps[0][1], full),
    }
    log(f"== api cbox 256x256 @ {spp} spp: walls {json.dumps({k: round(v, 4) for k, v in walls.items()})}; "
        f"checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"api: {checks}")
    return dict(walls=walls, checks=checks)


# ---------------------------------------------------------------------------
# surface materials and polarization optics
# ---------------------------------------------------------------------------

def k1_in_place_and_held(K1, name, fn, reps=5):
    """fn() once with CUDA events around each K1 launch and every launch
    held bit for bit against the plain version on its own inputs (the held
    wrapper calls the timed one, so the events hold K1 alone). Returns
    (launches, their summed ms in place, the same launches back to back
    (reps), their summed bound, the bound's split {"operations": ms,
    "bytes": ms}, k1_held_summary's dict)."""
    def work_and_inputs(*args):
        return k1_work(*args), [a.detach().clone() for a in args]

    timed, held = [], []
    with timed_launches(K1, "smem_intersect", work_and_inputs, timed), \
            k1_held_to_plain(K1, held):
        fn()
    bitwise = k1_held_summary(name, held)
    per = [(start.elapsed_time(end), k1_bound_ms(w)) for start, end, (w, _) in timed]
    inputs = [x for _, _, (_, x) in timed]
    b2b = time_cuda(lambda: [K1.smem_intersect(*x) for x in inputs], reps=reps)
    by = {}
    for _, b in per:
        by[b["by"]] = by.get(b["by"], 0.0) + b["ms"]
    return len(per), sum(m for m, _ in per), b2b, sum(b["ms"] for _, b in per), by, bitwise


def timed_calls(K1, K2, K3, name, fn, n, warm_up=True, kernel="K1"):
    """fn(seed 0, stats) n times after a warm-up fn(1, {}) (unless the
    caller warmed up), each ending in a synchronise, with the counts set to
    0 before the first: (walls, launches of `kernel` in each call (K2: its
    closest-hit and any-hit launches together), the last stats, the last
    result, the peak memory); fails unless `kernel` alone ran, the same
    number of times in each call, and never K1's plain version."""
    def launched():
        return {"K1": K1.smem_intersect.launches,
                "K2": K2.bvh_sweep_intersect.launches + K2.bvh_sweep_occluded.launches,
                "K3": K3.mxu_intersect.launches}

    if warm_up:
        fn(1, {})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(K1, K2, K3)
    walls, per_call = [], []
    for _ in range(n):
        before, stats = launched()[kernel], {}
        with no_plain_closest_hit(K1, name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(0, stats)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_call.append(launched()[kernel] - before)
    others = sum(v for k, v in launched().items() if k != kernel)
    if min(per_call) == 0 or len(set(per_call)) != 1 or others:
        raise AssertionError(f"{name}: {kernel} launches per call {per_call}, the other "
                             f"closest-hit kernels {others}")
    return walls, per_call, stats, out, torch.cuda.max_memory_allocated()


def kept_mean(img, parting):
    """The mean over the pixels of a 64x64 image [64, 64, ...] that are not
    in `parting` (row-major indices): [C], or [4, C] for a Stokes image."""
    flat = img.reshape((-1,) + tuple(img.shape[2:]))
    keep = torch.ones(flat.shape[0], dtype=torch.bool, device=img.device)
    keep[list(parting)] = False
    return flat[keep].mean(dim=0)


def check_kept_means(name, img, parting, want, rtol):
    """The 64x64 image's means over the pixels not in `parting` against the
    JAX package's `want`: I (or each channel) within rtol relative, Q, U
    and V within rtol of I; prints the full image's means too. Returns the
    worst relative error."""
    got = kept_mean(img, parting)
    want = torch.tensor(want, dtype=torch.float32, device=img.device)
    i_got, i_want = (got[0], want[0]) if got.ndim == 2 else (got, want)
    rel = float(((i_got - i_want).abs() / i_want.abs()).max())
    quv = float(((got[1:] - want[1:]).abs() / want[0].abs()).max()) if got.ndim == 2 else 0.0
    log(f"  {name}: means over the {img.shape[0] * img.shape[1] - len(parting)} pixels whose "
        f"paths part from the JAX package's nowhere {got.tolist()} against its {want.tolist()}: "
        f"{rel:.3e} relative" + (f", Q/U/V within {quv:.3e} of I" if got.ndim == 2 else "")
        + f" (tolerance {rtol}); the whole image's means {img.mean(dim=(0, 1)).tolist()}")
    if not (rel <= rtol and quv <= rtol):
        raise AssertionError(f"{name}: {got.tolist()} vs JAX {want.tolist()}")
    return max(rel, quv)


def phase_materials(mi, K1, K2, K3):
    """The materials scene (render/scene_loader.py:materials_scene: gold
    rough conductor, bk7 glass, two-sided rough plastic, diffuse/silver
    blend, mask) at 256x256 @ 64 spp, path max_depth 8, in rgb: one render
    (the warm-up) with CUDA events around each K1 launch and every launch
    held bit for bit against the plain version, then MATERIALS_PASSES timed
    renders (wall, Mrays/s, K1 launches, peak memory); the 64x64 @ 64 spp
    means against the JAX package's."""
    spp = MATERIALS_SPP
    scene = mi.load_dict(mi.materials_scene(MATERIALS_RES, spp))
    name = f"materials {MATERIALS_RES}x{MATERIALS_RES} @ {spp} spp, path max_depth 8"

    def render(seed, stats):
        return mi.render(scene, spp=spp, seed=seed, stats=stats)

    n_k1, k_ms, b2b_ms, b_ms, by, bitwise = k1_in_place_and_held(K1, name,
                                                                lambda: render(1, {}))
    walls, per_pass, stats, img, peak = timed_calls(K1, K2, K3, name, render, MATERIALS_PASSES,
                                                    warm_up=False)
    if tuple(img.shape) != (MATERIALS_RES, MATERIALS_RES, 3) or not bool(
            torch.isfinite(img).all()) or not float(img.mean()) > 0:
        raise AssertionError(f"{name}: image {tuple(img.shape)} not finite or black")
    mrays = [stats["n_rays"] / w / 1e6 for w in walls]
    log(f"== main path: {name}: walls {[round(w, 4) for w in walls]} s, {stats['n_rays']} rays, "
        f"{[round(m, 2) for m in mrays]} Mrays/s, K1 launches per render {per_pass}, peak "
        f"memory {peak / 2**30:.3f} GiB, means {img.mean(dim=(0, 1)).tolist()}")
    log(f"  {name}: the warm-up render with events around each K1 launch: {n_k1} launches, "
        f"{k_ms:.3f} ms in K1 in place ({k_ms / (min(walls) * 1e3):.3%} of the fastest wall), "
        f"{b2b_ms:.4f} ms back to back; summed bound {b_ms:.4f} ms {by}")
    img64 = mi.render(mi.load_dict(mi.materials_scene(64, MEANS64_SPP)), spp=MEANS64_SPP,
                      seed=0)
    rel = check_kept_means(f"materials 64x64 @ {MEANS64_SPP} spp", img64,
                           MATERIALS64_PARTING_PIXELS, JAX_MATERIALS64_KEPT_MEANS, MATERIALS_RTOL)
    return dict(walls=walls, mrays=mrays, n_rays=stats["n_rays"], k1_per_render=per_pass[0],
                peak=peak, means=img.mean(dim=(0, 1)).tolist(), k1_render_ms=k_ms,
                k1_render_back_to_back_ms=b2b_ms, k1_render_bound_ms=b_ms, k1_bound_by=by,
                k1_bitwise_vs_plain=bitwise, means64_rel_err=rel)


def phase_materials_prb(mi, K1, K2, K3):
    """The materials scene with prb at 256x256 @ 64 spp, max_depth 8: the
    image mean's gradients for the rough conductor's alpha and the blend's
    weight (run_prb_vol: warm-up, timed steps, K1 held and timed); the
    64x64 @ 16 spp gradients at max_depth 4 against the JAX package's (see
    JAX_MATERIALS_PRB64_DEPTH4_GRAD), and the max_depth 8 step at 64x64
    through K1 against the same step through the plain version."""
    spp = MATERIALS_SPP
    keys = list(MATERIALS_PRB_KEYS)
    integ = {"type": "prb", "max_depth": 8}

    def loss(mi, sc, seed, stats, spp=spp):
        return mi.render(sc, spp=spp, seed=seed, stats=stats).mean()

    scene = mi.load_dict(mi.materials_scene(MATERIALS_RES, spp, integ))
    out = run_prb_vol(mi, K1, K2, K3, f"materials-prb {MATERIALS_RES}x{MATERIALS_RES} @ {spp} "
                      "spp, prb max_depth 8", scene, keys, loss,
                      MATERIALS_RES * MATERIALS_RES * spp)
    out["grads"] = {k: float(v) for k, v in out["grads"].items()}
    def loss64(mi, sc, seed, stats):
        return loss(mi, sc, seed, stats, 16)

    depth4 = mi.load_dict(mi.materials_scene(64, 16, dict(integ, max_depth=4)))
    _, g64, _, _, _ = prb_vol_step(mi, depth4, keys, loss64, 0)
    out["grad64_depth4"] = {k: float(g64[k]) for k in keys}
    out["grad64_depth4_rel_err"] = max(
        check_rel(f"materials-prb 64x64 @ 16 spp, max_depth 4, d mean / d {k}", float(g64[k]),
                  want, MATERIALS_RTOL)
        for k, want in zip(keys, JAX_MATERIALS_PRB64_DEPTH4_GRAD))
    small = mi.load_dict(mi.materials_scene(64, 16, integ))
    out["plain"] = prb_vol_plain_check(mi, K1, K2, K3, "materials-prb 64x64 @ 16 spp", small,
                                       keys, loss64)
    return out


def polarimeter_physics(img):
    """The polarimeter image's optics, per channel: behind the linear
    polarizer (image columns left of the centre, which sees x < 0) every
    lit pixel has DoLP > 0.95 and |V| / I < 0.02; behind the quarter-wave
    plate some pixel has |V| / I > 0.01. Two columns each side of the
    sheets' shared edge are left out (the filter's footprint straddles
    it)."""
    I, Q, U, V = (img[:, :, k, :] for k in range(4))
    w = img.shape[1]
    lit = I > 0
    safe = torch.where(lit, I, 1.0)
    dolp = torch.sqrt(Q * Q + U * U) / safe
    v_over_i = V.abs() / safe
    left, right = slice(0, w // 2 - 2), slice(w // 2 + 2, w)
    lit_l = lit[:, left]
    out = dict(polarizer_min_dolp=float(dolp[:, left][lit_l].min()),
               polarizer_max_v_over_i=float(v_over_i[:, left][lit_l].max()),
               polarizer_lit_pixels=int(lit_l.sum()),
               retarder_max_v_over_i=float(v_over_i[:, right][lit[:, right]].max()),
               retarder_mean_dolp=float(dolp[:, right][lit[:, right]].mean()))
    log(f"  polarimeter optics: {out} (polarizer: DoLP > 0.95, |V|/I < 0.02 on every lit "
        f"pixel; retarder: |V|/I > 0.01 somewhere)")
    if not (out["polarizer_min_dolp"] > 0.95 and out["polarizer_max_v_over_i"] < 0.02
            and out["retarder_max_v_over_i"] > 0.01 and out["polarizer_lit_pixels"] > 0):
        raise AssertionError(f"polarimeter optics: {out}")
    return out


def phase_polarimeter(mi, K1, K2, K3):
    """The polarimeter (render/scene_loader.py:polarimeter_scene: the
    materials scene with polarized plastic and smooth gold seen through a
    linear polarizer and a quarter-wave plate) in rgb_polarized, stokes over
    volpath max_depth 8, at 256x256 @ 64 spp in passes of
    POLARIMETER_SPP_PER_PASS: one render (the warm-up) with CUDA events
    around each K1 launch and every launch held bit for bit against the
    plain version, then POLARIMETER_RENDERS timed renders (wall, Mrays/s, K1
    launches, peak memory) and the optics' checks on the image; the 64x64
    @ 64 spp Stokes means against the JAX package's."""
    spp, res = MATERIALS_SPP, MATERIALS_RES
    mi.set_variant("rgb_polarized")
    try:
        scene = mi.load_dict(mi.polarimeter_scene(res, spp))
        name = (f"polarimeter {res}x{res} @ {spp} spp (passes of {POLARIMETER_SPP_PER_PASS}), "
                "rgb_polarized, stokes over volpath max_depth 8")

        def render(seed, stats):
            return mi.render(scene, spp=spp, spp_per_pass=POLARIMETER_SPP_PER_PASS, seed=seed,
                             stats=stats)

        n_k1, k_ms, b2b_ms, b_ms, by, bitwise = k1_in_place_and_held(
            K1, name, lambda: render(1, {}), reps=3)
        walls, per_render, stats, img, peak = timed_calls(K1, K2, K3, name, render,
                                                          POLARIMETER_RENDERS, warm_up=False)
        if tuple(img.shape) != (res, res, 4, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{name}: Stokes image {tuple(img.shape)} not finite")
        mrays = [stats["n_rays"] / w / 1e6 for w in walls]
        log(f"== main path: {name}: walls {[round(w, 4) for w in walls]} s, {stats['n_rays']} "
            f"rays, {[round(m, 3) for m in mrays]} Mrays/s, K1 launches per render "
            f"{per_render}, peak memory {peak / 2**30:.3f} GiB, Stokes means "
            f"{img.mean(dim=(0, 1)).tolist()}")
        log(f"  {name}: the warm-up render with events around each K1 launch: {n_k1} launches, "
            f"{k_ms:.3f} ms in K1 in place ({k_ms / (min(walls) * 1e3):.3%} of the fastest "
            f"wall), {b2b_ms:.4f} ms back to back; summed bound {b_ms:.4f} ms {by}")
        physics = polarimeter_physics(img)
        img64 = mi.render(mi.load_dict(mi.polarimeter_scene(64, MEANS64_SPP)), spp=MEANS64_SPP,
                          seed=0)
        rel = check_kept_means(f"polarimeter 64x64 @ {MEANS64_SPP} spp", img64,
                               POLARIMETER64_PARTING_PIXELS, JAX_POLARIMETER64_KEPT_STOKES,
                               MATERIALS_RTOL)
    finally:
        mi.set_variant("rgb")
    return dict(walls=walls, mrays=mrays, n_rays=stats["n_rays"], k1_per_render=per_render[0],
                peak=peak, physics=physics, k1_render_ms=k_ms, k1_render_back_to_back_ms=b2b_ms,
                k1_render_bound_ms=b_ms, k1_bound_by=by, k1_bitwise_vs_plain=bitwise,
                stokes64_rel_err=rel)


def phase_polarimeter_prb(mi, K1, K2, K3):
    """The polarimeter with prb (so prb_polarized), reduced to 64x64 @ 16
    spp: the gradient of the sum of I for the polarized plastic's diffuse
    reflectance (run_prb_vol); a 32x32 @ 4 spp step through K1 against the
    same step through the plain version."""
    res, spp = POLARIMETER_PRB_RES, POLARIMETER_PRB_SPP
    integ = {"type": "prb", "max_depth": 8}
    key = "back.bsdf.diffuse_reflectance.value"

    def loss(mi, sc, seed, stats, spp=spp):
        return mi.render(sc, spp=spp, seed=seed, stats=stats)[:, :, 0, :].sum()

    mi.set_variant("rgb_polarized")
    try:
        scene = mi.load_dict(mi.polarimeter_scene(res, spp, integ))
        out = run_prb_vol(mi, K1, K2, K3, f"polarimeter-prb {res}x{res} @ {spp} spp, "
                          "prb_polarized max_depth 8", scene, [key], loss, res * res * spp)
        out["grads"] = {k: v.tolist() for k, v in out["grads"].items()}
        out["plain"] = prb_vol_plain_check(
            mi, K1, K2, K3, "polarimeter-prb 32x32 @ 4 spp",
            mi.load_dict(mi.polarimeter_scene(32, 4, integ)), [key],
            lambda mi, sc, seed, st: loss(mi, sc, seed, st, 4))
    finally:
        mi.set_variant("rgb")
    return out


def phase_integrators(mi, K1, K2, K3, path_means):
    """The materials scene rendered once each at 256x256 @ 64 spp with
    direct, depth, aov ("dd.y:depth,nn:sh_normal") and moment over path
    (max_depth 8), each after a warm-up, through K1 alone: wall, rays,
    K1 launches; finite images, the AOV's normals signed (the film keeps
    them), its depth channel the depth integrator's bitwise, the moment's
    means at least the squares of the path image's `path_means` (the
    second moment of the same samples)."""
    spp, res = MATERIALS_SPP, MATERIALS_RES
    specs = {"direct": {"type": "direct"}, "depth": {"type": "depth"},
             "aov": {"type": "aov", "aovs": "dd.y:depth,nn:sh_normal"},
             "moment": {"type": "moment", "integrator": {"type": "path", "max_depth": 8}}}
    out, images = {}, {}
    for name, spec in specs.items():
        scene = mi.load_dict(mi.materials_scene(res, spp, spec))
        label = f"integrators: materials {res}x{res} @ {spp} spp, {name}"

        def render(seed, stats):
            return mi.render(scene, spp=spp, seed=seed, stats=stats)

        walls, per, stats, img, peak = timed_calls(K1, K2, K3, label, render, 1)
        if tuple(img.shape) != (res, res, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label}: image {tuple(img.shape)} not finite")
        images[name] = img
        out[name] = dict(wall=walls[0], n_rays=stats["n_rays"], k1=per[0], peak=peak,
                         mrays=stats["n_rays"] / walls[0] / 1e6,
                         means=img.mean(dim=(0, 1)).tolist())
        log(f"== {label}: {walls[0]:.4f} s wall, {stats['n_rays']} rays "
            f"({out[name]['mrays']:.2f} Mrays/s), K1 launches {per[0]}, peak memory "
            f"{peak / 2**30:.3f} GiB, means {out[name]['means']}")
    checks = {
        "aov signed": bool((images["aov"][..., 1:] < 0).any()),
        "aov depth == depth": torch.equal(images["aov"][..., 0], images["depth"][..., 0]),
        "moment >= 0": bool((images["moment"] >= 0).all()),
        "moment means >= path means^2": all(
            m >= p * p for m, p in zip(out["moment"]["means"], path_means)),
        "depth >= 0, not all 0": (bool((images["depth"] >= 0).all())
                                  and float(images["depth"].mean()) > 0),
    }
    log(f"  integrators: checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"integrators: {checks}")
    out["checks"] = checks
    return out


# ---------------------------------------------------------------------------
# the spectral variants
# ---------------------------------------------------------------------------

def phase_spectral(mi, K1, K2, K3):
    """Config 1 in the spectral variant: the cbox at 256x256 @ 64 spp, path
    max_depth 8, four hero wavelengths a lane contracted to sRGB. One
    render with CUDA events around each K1 launch and every launch held bit
    for bit against the plain version, SPECTRAL_RENDERS timed renders
    (wall, Mrays/s, K1 launches, peak memory), and the 64x64 @ 16 spp means
    against the JAX package's."""
    mi.set_variant("spectral")
    try:
        scene = mi.load_dict(mi.cornell_box())
        spp = 64
        name = f"spectral cbox {scene.film.width}x{scene.film.height} @ {spp} spp, path max_depth 8"

        def render(seed, stats):
            return mi.render(scene, spp=spp, seed=seed, stats=stats)

        n_k1, k_ms, b2b_ms, b_ms, by, bitwise = k1_in_place_and_held(K1, name,
                                                                    lambda: render(1, {}))
        walls, per_call, stats, img, peak = timed_calls(K1, K2, K3, name, render,
                                                        SPECTRAL_RENDERS, warm_up=False)
        if tuple(img.shape) != (scene.film.height, scene.film.width, 3) or not bool(
                torch.isfinite(img).all()) or not float(img.mean()) > 0:
            raise AssertionError(f"{name}: image {tuple(img.shape)} not finite or black")
        mrays = [stats["n_rays"] / w / 1e6 for w in walls]
        log(f"== main path: {name}: walls {[round(w, 4) for w in walls]} s, {stats['n_rays']} "
            f"rays, {[round(m, 2) for m in mrays]} Mrays/s, K1 launches per render {per_call}, "
            f"peak memory {peak / 2**30:.3f} GiB, means {img.mean(dim=(0, 1)).tolist()}")
        log(f"  {name}: one render with events around each K1 launch: {n_k1} launches, "
            f"{k_ms:.3f} ms in K1 in place, {b2b_ms:.4f} ms back to back; summed bound "
            f"{b_ms:.4f} ms {by}")
        d64 = mi.cornell_box()
        d64["sensor"]["film"]["width"] = d64["sensor"]["film"]["height"] = 64
        means = mi.render(mi.load_dict(d64), spp=16, seed=0).mean(dim=(0, 1)).tolist()
        rel = max(check_rel(f"spectral cbox 64x64 @ 16 spp, channel {c} mean", m, w,
                            SPECTRAL_RTOL)
                  for c, (m, w) in enumerate(zip(means, JAX_SPECTRAL_CBOX64_MEANS)))
    finally:
        mi.set_variant("rgb")
    return dict(walls=walls, mrays=mrays, n_rays=stats["n_rays"], k1_per_render=per_call[0],
                peak=peak, means=img.mean(dim=(0, 1)).tolist(), means64=means,
                means64_rel_err=rel, k1_render_ms=k_ms, k1_render_back_to_back_ms=b2b_ms,
                k1_render_bound_ms=b_ms, k1_bound_by=by, k1_bitwise_vs_plain=bitwise)


def phase_spectral_prb(mi, K1, K2, K3):
    """Config 2 in the spectral variant: the cbox-prb step at 256x256 @ 64
    spp, prb max_depth 8, the image mean's gradient for
    white.reflectance.value through the XYZ -> sRGB measurement inside the
    PRB node (run_prb_vol: warm-up, timed steps, every K1 launch of a step
    held bit for bit), and the 64x64 @ 16 spp gradient at max_depth 4
    against the JAX package's."""
    mi.set_variant("spectral")
    try:
        keys = [KEY]
        scene = mi.load_dict(prb_dict(mi, 256, 64, 8))

        def loss(mi, sc, seed, stats, spp=64):
            return mi.render(sc, spp=spp, seed=seed, stats=stats).mean()

        out = run_prb_vol(mi, K1, K2, K3, "spectral cbox-prb 256x256 @ 64 spp, prb max_depth 8",
                          scene, keys, loss, 256 * 256 * 64)
        out["grads"] = {k: v.tolist() for k, v in out["grads"].items()}
        _, g64, _, _, _ = prb_vol_step(mi, mi.load_dict(prb_dict(mi, 64, 16, 4)), keys,
                                       lambda mi, sc, seed, st: loss(mi, sc, seed, st, 16), 0)
        g64 = g64[KEY].tolist()
        out["grad64_depth4"] = g64
        out["grad64_depth4_rel_err"] = max(
            check_rel(f"spectral cbox-prb 64x64 @ 16 spp, max_depth 4, d mean / d {KEY}[{c}]",
                      g, w, SPECTRAL_RTOL)
            for c, (g, w) in enumerate(zip(g64, JAX_SPECTRAL_PRB64_DEPTH4_GRAD)))
    finally:
        mi.set_variant("rgb")
    return out


def phase_atmo_spectral(mi, K1, K2, K3):
    """BASELINE config 4 as BASELINE names it, in spectral_polarized: one
    warm-up pass and SPECTRAL_ATMO_PASSES timed passes of render_1 at 64x64
    @ 64 spp (wall, Msamples/s = lanes / wall, K1 launches, peak memory; the
    [N, 4, 4, 4] Mueller state), the raw Stokes [4, 4] against the JAX
    package's (I within ATMO_I_RTOL, Q/U/V within ATMO_QUV_ATOL of I, the
    four channels equal: the radiancemeter pins 550 nm), and one pass with
    every K1 launch held bit for bit against the plain version."""
    from mitsuba_tpu_torch.render.scene_loader import atmo_scene

    mi.set_variant("spectral_polarized")
    try:
        scene = mi.load_dict(atmo_scene(ATMO_RES, ATMO_SPP))
        lanes = scene.film.n_pixels * ATMO_SPP
        name = (f"atmo-spectral (config 4, spectral_polarized) {ATMO_RES}x{ATMO_RES} @ {ATMO_SPP} "
                "spp")

        def pass_(seed, stats):
            return mi.render_1(scene, spp=ATMO_SPP, seed=seed, stats=stats)

        walls, per_pass, stats, stokes, peak = timed_calls(K1, K2, K3, name, pass_,
                                                           SPECTRAL_ATMO_PASSES)
        if tuple(stokes.shape) != (4, 4) or not bool(torch.isfinite(stokes).all()):
            raise AssertionError(f"{name}: Stokes {stokes.tolist()}")
        msamples = [lanes / w / 1e6 for w in walls]
        log(f"== main path: {name}, {lanes} lanes: walls {[round(w, 4) for w in walls]} s, "
            f"{[round(m, 4) for m in msamples]} Msamples/s, {stats['n_rays']} rays a pass, K1 "
            f"launches per pass {per_pass}, peak memory {peak / 2**30:.3f} GiB; Stokes (rows "
            f"I, Q, U, V) {stokes.tolist()}")
        want = torch.tensor(JAX_SPECTRAL_ATMO_STOKES, dtype=torch.float32, device=stokes.device)
        rel_i = float(((stokes[0] - want[0]).abs() / want[0]).max())
        quv = float(((stokes[1:] - want[1:]).abs() / want[0]).max())
        same = bool((stokes == stokes[:, :1]).all())
        log(f"  against the JAX package's: I within {rel_i:.3e} (rtol {ATMO_I_RTOL}), Q/U/V "
            f"within {quv:.3e} of I (atol {ATMO_QUV_ATOL} I); the four channels equal: {same}")
        if rel_i > ATMO_I_RTOL or quv > ATMO_QUV_ATOL or not same:
            raise AssertionError(f"{name}: Stokes {stokes.tolist()} vs JAX "
                                 f"{JAX_SPECTRAL_ATMO_STOKES}")
        held = []
        with k1_held_to_plain(K1, held):
            pass_(0, {})
        bitwise = k1_held_summary(f"{name} pass", held)
    finally:
        mi.set_variant("rgb")
    return dict(walls=walls, msamples=msamples, lanes=lanes, rays=stats["n_rays"],
                k1_per_pass=per_pass, peak=peak, stokes=stokes.tolist(), stokes_rel_err_i=rel_i,
                stokes_err_quv_over_i=quv, k1_bitwise_vs_plain=bitwise)


def phase_spectral_regen(mi, K1, K2, K3):
    """Reduced regeneration in spectral on the Rayleigh slab
    (SPECTRAL_REGEN_RES^2 @ SPECTRAL_REGEN_SPP) under an rgb environment
    (SPECTRAL_REGEN_RADIANCE, so the emitted spectrum differs from one
    wavelength to another): the regenerative volpath render (the sRGB
    conversion at each flush) against the wavefront render (REGEN_RTOL /
    REGEN_ATOL); the regenerative prbvolpath step (the conversion's adjoint
    at each sample's primal radiance and wavelengths) against the wavefront
    step (REGEN_GRAD_RTOL). Every K1 launch of the regenerative render and
    of the regenerative step is held bit for bit against the plain
    version."""
    res, spp, rad = SPECTRAL_REGEN_RES, SPECTRAL_REGEN_SPP, SPECTRAL_REGEN_RADIANCE
    mi.set_variant("spectral")
    try:
        name = f"spectral-regen Rayleigh slab volpath {res}x{res} @ {spp} spp"
        held = []
        before = K1.smem_intersect.launches
        with k1_held_to_plain(K1, held):
            img_r, wall_r = render_timed(
                mi, rayleigh_slab(mi, "volpath", True, res, spp, rad), spp, 0)
        k1 = K1.smem_intersect.launches - before
        bitwise = k1_held_summary(name, held)
        img_w, wall_w = render_timed(mi, rayleigh_slab(mi, "volpath", False, res, spp, rad),
                                     spp, 0)
        close = torch.isclose(img_r, img_w, rtol=REGEN_RTOL, atol=REGEN_ATOL)
        log(f"== {name}: regenerative {wall_r:.3f} s (K1 held), wavefront {wall_w:.3f} s, K1 "
            f"launches {k1}, image {tuple(img_r.shape)}: {close.float().mean().item():.5%} of "
            f"values within rtol {REGEN_RTOL} / atol {REGEN_ATOL} of the wavefront image")
        if k1 == 0 or not bool(close.all()) or tuple(img_r.shape) != (res, res, 3):
            raise AssertionError(f"{name}: the regenerative image differs")
        name_prb = f"spectral-regen Rayleigh slab {res}x{res} @ {spp} spp, prbvolpath"
        held_prb = []
        prb = regen_vs_wavefront_step(
            mi, K1, name_prb, lambda r: rayleigh_slab(mi, "prbvolpath", r, res, spp, rad),
            ["slab.interior_medium.albedo.value.value"], spp, held_prb)
        prb["k1_bitwise_vs_plain"] = k1_held_summary(f"{name_prb} regenerative step", held_prb)
    finally:
        mi.set_variant("rgb")
    return dict(volpath=dict(wall=wall_r, wavefront_wall=wall_w, k1=k1,
                             k1_bitwise_vs_plain=bitwise), prbvolpath=prb)


# ---------------------------------------------------------------------------
# the last integrators (ptracer, volpathmis), the projective boundary
# gradients of moving meshes and the two physics golds
# ---------------------------------------------------------------------------

PTRACER_SPP, PTRACER_DEPTH = 64, 8
# tests/test_ptracer.py skips the light fixture's rows, 6 of 24: here the
# top quarter, 64 of 256; the rest's mean within 5% of path's
PTRACER_SKIP_ROWS, PTRACER_MEAN_RTOL = 64, 0.05
VOLPATHMIS_MEAN_RTOL = 0.02
FURNACE_SIGMA, FURNACE_RTOL = [4.0, 1.0, 0.08], 0.03
PROJ_SPP, PROJ_FD_SPP, PROJ_FD_EPS, PROJ_SEEDS = 64, 256, 1e-2, (7, 11)
# tests/test_projective.py's bounds against central differences; the cube
# (a closed mesh whose faces do not share vertices) takes the silhouette's.
# The cbox's gradient is not held to its central difference: the JAX
# package's estimator, which the port follows, has no term for the creases
# of a flat-shaded mesh (the box's edges between two faces the camera sees,
# across which the shading jumps), and the cbox's boxes are all creases
# (PERF.md, ROADMAP Queue 3); its AD and FD are printed side by side
PROJ_RTOL = {"cbox": None, "silhouette": 0.08, "shadow": 0.12, "cube": 0.08}
# the flat cube's one vertex copy moved alone (cube_copy_check): the step
# in world units (~0.16 px), AD over 8 seeds, FD at 2,048 spp, held within
# the silhouette's 8% (2.1% on the CPU at these settings)
PROJ_COPY_EPS, PROJ_COPY_FD_SPP, PROJ_COPY_RTOL = 1e-2, 2048, 0.08
PROJ_COPY_SEEDS = (7, 11, 13, 17, 19, 23, 29, 31)
# The JAX package's d sum(image) / d scale of the cbox's small box
# (scale_offset) at 64x64, prb_projective max_depth 4, spp 16, seed 7, on
# the port's edge tables (the JAX geometry's edge_v, edge_f and edge_shape
# replaced by mitsuba_tpu_torch's welded ones: ROADMAP's standing
# differences), computed once with mitsuba_tpu on the CPU
# (XLA_FLAGS=--xla_backend_optimization_level=1):
# jax.jit(jax.grad(loss))(0.0), loss(t) = sum(mi.render(_tree_set(scene,
# path, base + t * off), spp=16, seed=7)), for (sppp, sppi) = (0, 0), the
# interior term (the PRB node and the tape pass); (4, 0), with the primary
# silhouettes; (4, 4), the whole, with the indirect pass (17.1, 29.9 and
# 35.1 s). The port on the CPU (cbox64_held_to_jax): -19.290163040161133,
# 81.0760269165039, -560.6885986328125. The interior term is held as the PRB gradients are;
# the boundary terms at 1%: a probe 0.05 px or 5e-3 rad from a curve can
# classify a lane differently on the card, and a parted lane carries its
# whole weight.
JAX_CBOX64_PROJ_GRAD = {(0, 0): -19.290164947509766, (4, 0): 81.07600402832031,
                        (4, 4): -560.6887817382812}
PROJ_CBOX64_RTOL = {(0, 0): 1e-3, (4, 0): 1e-2, (4, 4): 1e-2}
RAYLEIGH_SPP, CHANDRA_SPP, CHANDRA_OMEGA = 16384, 8192, 0.8


def phase_ptracer(mi, K1, K2, K3):
    """The particle tracer on the cbox at 256x256 @ 64 spp (4,194,304
    particles), max_depth 8: one render with CUDA events around each K1
    launch and every launch held bit for bit against the plain version,
    two timed renders; the mean over the rows below the light against
    path's at the same size (tests/test_ptracer.py's 5%)."""
    d = mi.cornell_box()
    d["integrator"] = {"type": "ptracer", "max_depth": PTRACER_DEPTH}
    scene = mi.load_dict(d)
    res = scene.film.width
    name = (f"ptracer cbox {res}x{res} @ {PTRACER_SPP} spp ({scene.film.n_pixels * PTRACER_SPP} "
            f"particles), max_depth {PTRACER_DEPTH}")

    def render(seed, stats):
        return mi.render(scene, spp=PTRACER_SPP, seed=seed, stats=stats)

    n_k1, k_ms, b2b_ms, b_ms, by, bitwise = k1_in_place_and_held(K1, name, lambda: render(2, {}))
    walls, per, stats, img, peak = timed_calls(K1, K2, K3, name, render, 2, warm_up=False)
    if tuple(img.shape) != (res, res, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{name}: image {tuple(img.shape)} not finite")
    d["integrator"] = {"type": "path", "max_depth": PTRACER_DEPTH}
    ref = mi.render(mi.load_dict(d), spp=PTRACER_SPP, seed=1)
    a = float(ref[PTRACER_SKIP_ROWS:].mean())
    b = float(img[PTRACER_SKIP_ROWS:].mean())
    rel = abs(a - b) / a
    log(f"== main path: {name}: walls {[round(w, 4) for w in walls]} s, {stats['n_rays']} rays, "
        f"K1 launches per render {per}, peak memory {peak / 2**30:.3f} GiB; one render with events "
        f"around each K1 launch: {n_k1} launches, {k_ms:.3f} ms in K1 in place, {b2b_ms:.4f} ms "
        f"back to back, summed bound {b_ms:.4f} ms {by}; mean below row {PTRACER_SKIP_ROWS} "
        f"{b:.6f} against path's {a:.6f}: {rel:.4%} (rtol {PTRACER_MEAN_RTOL})")
    if not rel <= PTRACER_MEAN_RTOL:
        raise AssertionError(f"{name}: mean {b} against path's {a}")
    return dict(walls=walls, n_rays=stats["n_rays"], k1_per_render=per[0], peak=peak,
                mean=b, path_mean=a, rel=rel, k1_render_ms=k_ms, k1_render_back_to_back_ms=b2b_ms,
                k1_render_bound_ms=b_ms, k1_bound_by=by, k1_bitwise_vs_plain=bitwise)


def _furnace_dict(mi):
    """tests/test_volpathmis.py's furnace: an albedo-1 medium with a
    strongly spectral sigma_t in a null cube under a unit environment."""
    return {
        "type": "scene",
        "integrator": {"type": "volpathmis", "max_depth": 48, "rr_depth": 64},
        "sensor": {"type": "perspective", "fov": 10,
                   "to_world": [{"type": "look_at", "origin": [0, 0, 6], "target": [0, 0, 0],
                                 "up": [0, 1, 0]}],
                   "film": {"type": "hdrfilm", "width": 12, "height": 12,
                            "rfilter": {"type": "box"}}},
        "medium1": {"type": "homogeneous", "sigma_t": {"type": "rgb", "value": FURNACE_SIGMA},
                    "albedo": 1.0, "phase": {"type": "isotropic"}},
        "bounds": {"type": "cube", "bsdf": {"type": "null"},
                   "interior": {"type": "ref", "id": "medium1"}},
        "env": {"type": "constant", "radiance": 1.0},
    }


def phase_volpathmis(mi, K1, K2, K3):
    """volpathmis on the het-vol configuration (96x96 @ 16 spp, max_depth
    12, in rgb): one render with every K1 launch held bit for bit and events
    around each, two timed renders; its means against volpath's of the same
    dict; the furnace of tests/test_volpathmis.py (12x12 @ 200 spp, every
    channel within 3% of 1)."""
    from mitsuba_tpu_torch.render.scene_loader import het_vol_scene

    spp = 16
    d = het_vol_scene(spp=spp)
    d["integrator"] = {"type": "volpathmis", "max_depth": d["integrator"]["max_depth"]}
    scene = mi.load_dict(d)
    res = scene.film.width
    name = f"volpathmis het-vol {res}x{res} @ {spp} spp, max_depth 12"

    def render(seed, stats):
        return mi.render(scene, spp=spp, seed=seed, stats=stats)

    n_k1, k_ms, b2b_ms, b_ms, by, bitwise = k1_in_place_and_held(K1, name, lambda: render(1, {}))
    walls, per, stats, img, peak = timed_calls(K1, K2, K3, name, render, 2, warm_up=False)
    means = img.mean(dim=(0, 1)).tolist()
    ref = mi.render(mi.load_dict(het_vol_scene(spp=spp)), spp=spp, seed=0).mean(dim=(0, 1))
    rel = max(abs(m - r) / r for m, r in zip(means, ref.tolist()))
    log(f"== main path: {name}: walls {[round(w, 4) for w in walls]} s, {stats['n_rays']} rays "
        f"({stats['n_rays'] / min(walls) / 1e6:.3f} Mrays/s), K1 launches per render {per}, peak "
        f"memory {peak / 2**30:.3f} GiB; one render with events around each K1 launch: {n_k1} "
        f"launches, {k_ms:.3f} ms in place, {b2b_ms:.4f} ms back to back, bound {b_ms:.4f} ms "
        f"{by}; means {means} against volpath's {ref.tolist()}: {rel:.4%} (rtol "
        f"{VOLPATHMIS_MEAN_RTOL})")
    if not bool(torch.isfinite(img).all()) or not rel <= VOLPATHMIS_MEAN_RTOL:
        raise AssertionError(f"{name}: means {means} against volpath's {ref.tolist()}")
    furnace = mi.load_dict(_furnace_dict(mi))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_plain_closest_hit(K1, "volpathmis furnace"):
        f_means = mi.render(furnace, spp=200, seed=3).mean(dim=(0, 1)).tolist()
    torch.cuda.synchronize()
    f_wall = time.perf_counter() - t0
    f_rel = max(abs(m - 1.0) for m in f_means)
    log(f"  furnace 12x12 @ 200 spp, sigma_t {FURNACE_SIGMA}, albedo 1, max_depth 48: "
        f"{f_wall:.3f} s, means {f_means}: within {f_rel:.4%} of 1 (rtol {FURNACE_RTOL})")
    if not f_rel <= FURNACE_RTOL:
        raise AssertionError(f"volpathmis furnace: means {f_means}")
    return dict(walls=walls, n_rays=stats["n_rays"], k1_per_render=per[0], peak=peak, means=means,
                volpath_means=ref.tolist(), rel=rel, furnace_means=f_means, furnace_wall=f_wall,
                k1_render_ms=k_ms, k1_render_back_to_back_ms=b2b_ms, k1_render_bound_ms=b_ms,
                k1_bound_by=by, k1_bitwise_vs_plain=bitwise)


# K1's backward (hit_vjp, the closed form of the planar hit's VJP) against
# torch.func.vjp of the plain Moller-Trumbore on each lane's hit triangle:
# two float32 evaluations of one derivative, which part by rounding on
# lanes that hit near grazing; a wrong term parts on most lanes
VJP_RTOL, VJP_PART_SHARE = 1e-3, 1e-3


def mt_autograd_vjp(K1, table, prim, o, d, g_t, g_u, g_v):
    """(table, o, d) cotangents of the hits prim for the output cotangents
    (None for none), by torch.func.vjp of K1.moller_trumbore on each hit
    lane's own triangle row: a derivative independent of hit_vjp's closed
    form. Misses get 0."""
    hit = (prim >= 0).nonzero()[:, 0]
    p = prim[hit].to(torch.int64)

    def planar_hit(tab, oo, dd):
        t, u, v, _, _ = K1.moller_trumbore(oo, dd, tab[p][:, None, :])
        return t[:, 0], u[:, 0], v[:, 0]

    _, pull = torch.func.vjp(planar_hit, table, o[hit], d[hit])
    zero = torch.zeros(hit.shape[0], dtype=o.dtype, device=o.device)
    ct_tab, ct_o, ct_d = pull(tuple(zero if g is None else g[hit] for g in (g_t, g_u, g_v)))
    return (ct_tab, torch.zeros_like(o).index_copy_(0, hit, ct_o),
            torch.zeros_like(d).index_copy_(0, hit, ct_d))


@contextlib.contextmanager
def k1_vjp_held_to_autograd(K1, held):
    """Inside, the rays of every K1 launch made for a differentiable hit
    are kept, and every hit_vjp (K1's backward) is held against
    mt_autograd_vjp on the same hits: `held` gets (hit lanes, lanes whose
    o or d cotangent parts by more than VJP_RTOL of its norm, the largest
    such part, the table cotangent's part in norm) per backward."""
    fn, vjp = K1.smem_intersect, K1.hit_vjp
    rays = {}

    def launch(*args):
        out = fn(*args)
        if any(a.requires_grad for a in args[:3]):
            rays[out[0].data_ptr()] = (out[0], args[1].detach())
        return out

    def held_vjp(table, prim, t, u, v, d, g_t, g_u, g_v):
        out = vjp(table, prim, t, u, v, d, g_t, g_u, g_v)
        t_k, o = rays.get(t.data_ptr(), (None, None))
        if o is None or t_k.shape != t.shape:
            raise AssertionError("hit_vjp of a hit that no held K1 launch made")
        ref = mt_autograd_vjp(K1, table, prim, o, d, g_t, g_u, g_v)
        hits = prim >= 0
        rel = torch.zeros_like(t)
        for a, b in zip(out[1:], ref[1:]):
            rel = torch.maximum(rel, (a - b).norm(dim=1) / b.norm(dim=1).clamp(min=1e-30))
        rel = torch.where(hits, rel, 0.0)
        tab = (out[0] - ref[0]).norm() / ref[0].norm().clamp(min=1e-30)
        held.append((hits.sum(), (rel > VJP_RTOL).sum(), rel.max(), tab))
        return out

    launch.launches = fn.launches
    K1.smem_intersect, K1.hit_vjp = launch, held_vjp
    try:
        yield
    finally:
        fn.launches = launch.launches
        K1.smem_intersect, K1.hit_vjp = fn, vjp


def k1_vjp_held_summary(name, held):
    """{"calls", "hit_lanes", "lanes_parted", "worst_lane", "table"} of the
    backward calls k1_vjp_held_to_autograd held; raises past the bounds."""
    lanes = int(sum(n for n, _, _, _ in held))
    out = dict(calls=len(held), hit_lanes=lanes,
               lanes_parted=int(sum(x for _, x, _, _ in held)),
               worst_lane=max((float(r) for _, _, r, _ in held), default=0.0),
               table=max((float(x) for _, _, _, x in held), default=0.0))
    log(f"  {name}: K1's backward (hit_vjp) held against torch.func.vjp of the plain "
        f"Moller-Trumbore: {out['calls']} calls, {lanes} hit lanes, {out['lanes_parted']} "
        f"parted by more than {VJP_RTOL:g} of their norm (worst {out['worst_lane']:.3e}), the "
        f"table's cotangent {out['table']:.3e} of its norm apart")
    if (not held or not lanes or out["lanes_parted"] > VJP_PART_SHARE * lanes
            or out["table"] > VJP_RTOL):
        raise AssertionError(f"{name}: hit_vjp against the autograd VJP: {out}")
    return out


def projective_scenes(mi):
    """The projective configurations: the cbox (prb_projective max_depth 4,
    sppp 4, sppi 4, the small box scaled), tests/test_projective.py's
    silhouette and point-light shadow scenes (direct_projective, 24x24),
    and the silhouette scene with a flat cube for its occluder (a closed
    mesh whose faces do not share vertices; one face turned to the camera,
    so that no crease shows, and turned so that the lowest-numbered copy of
    each of that face's corners lies in a face turned away)."""
    cbox = mi.cornell_box()
    cbox["integrator"] = {"type": "prb_projective", "max_depth": 4, "sppp": 4, "sppi": 4}
    film = {"type": "hdrfilm", "width": 24, "height": 24, "rfilter": {"type": "box"}}
    T = mi.Transform
    sil = {
        "type": "scene", "integrator": {"type": "direct_projective", "sppp": 16, "sppi": 0},
        "sensor": {"type": "perspective", "fov": 40.0, "film": film,
                   "to_world": {"type": "look_at", "origin": [0, 0, 4], "target": [0, 0, 0],
                                "up": [0, 1, 0]}},
        "bg": {"type": "rectangle", "to_world": T.translate([0, 0, -1]) @ T.scale([6, 6, 1]),
               "emitter": {"type": "area", "radiance": {"type": "rgb", "value": [1.0, 0.8, 0.6]}}},
        "occluder": {"type": "rectangle",
                     "to_world": T.translate([0.3, 0.0, 1.0]) @ T.scale([0.6, 0.6, 1]),
                     "bsdf": {"type": "diffuse",
                              "reflectance": {"type": "rgb", "value": [0.1, 0.1, 0.1]}}},
    }
    shadow = {
        "type": "scene", "integrator": {"type": "direct_projective", "sppp": 0, "sppi": 16},
        "sensor": {"type": "perspective", "fov": 30.0, "film": film,
                   "to_world": {"type": "look_at", "origin": [0, 0, 5], "target": [0, 0, 0],
                                "up": [0, 1, 0]}},
        "floor": {"type": "rectangle", "to_world": T.scale([8, 8, 1]),
                  "bsdf": {"type": "diffuse",
                           "reflectance": {"type": "rgb", "value": [0.7, 0.7, 0.7]}}},
        "occluder": {"type": "rectangle",
                     "to_world": T.translate([2.5, 1.0, 2.0]) @ T.scale([0.9, 0.9, 1]),
                     "bsdf": {"type": "diffuse",
                              "reflectance": {"type": "rgb", "value": [0.2, 0.2, 0.2]}}},
        "light": {"type": "point", "position": [5.0, 2.0, 4.5], "intensity": 60.0},
    }
    cube = dict(sil, occluder=dict(sil["occluder"], type="cube",
                                   to_world=sil["occluder"]["to_world"] @ T.rotate([1, 0, 0], 90)
                                   @ T.scale([1, 1, 0.2])))
    return {"cbox": (cbox, "small-box.vertex_positions", PROJ_SPP, PROJ_FD_SPP),
            "silhouette": (sil, "occluder.vertex_positions", 64, 512),
            "shadow": (shadow, "occluder.vertex_positions", 64, 512),
            "cube": (cube, "occluder.vertex_positions", 64, 512)}


def scale_offset(mi, scene, key):
    """(the shape's vertices, their offset from the point the scale keeps):
    a uniform scale moves every silhouette edge outward. A floating shape
    scales about its centre; the cbox's small box, which stands on the
    floor, about the centre of its bottom face, so that it keeps standing
    on the floor (scaled about its centre it would sink into the floor, and
    the line where its faces cut the floor, which no mesh edge follows,
    would move)."""
    base = mi.traverse(scene)[key].detach().clone()
    anchor = base.mean(dim=0, keepdim=True)
    if key == "small-box.vertex_positions":
        anchor[0, 1] = base[:, 1].min()
    return base, base - anchor


def projective_ad(mi, scene, key, spp, seed, stats=None):
    """d sum(image) / d scale through the projective backward."""
    base, off = scale_offset(mi, scene, key)
    t = torch.zeros((), device=base.device, requires_grad=True)
    img = mi.render(mi.traverse(scene).update({key: base + t * off}), spp=spp, seed=seed,
                    stats=stats)
    img.sum().backward()
    return float(t.grad)


def projective_fd(mi, scene, key, spp, seed):
    """Central difference of sum(image) in the scale, rendered by the base
    integrator in passes of at most 64 spp."""
    base, off = scale_offset(mi, scene, key)
    integ = scene.integrator.base

    def loss(s):
        sc = mi.traverse(scene).update({key: base + s * off})
        return float(mi.render(sc, spp=spp, seed=seed, integrator=integ,
                               spp_per_pass=min(spp, 64)).sum())

    return (loss(PROJ_FD_EPS) - loss(-PROJ_FD_EPS)) / (2 * PROJ_FD_EPS)


def cube_copy_check(mi, scene, key, spp):
    """Where the flat cube's silhouette cotangent goes. Its faces do not
    share vertices, so each corner has three copies; the one that moves
    the silhouette is the copy in the face the camera sees (moved alone
    outward, that face grows over the background, while the copies in the
    faces turned away stay hidden behind it). For the seen face's corner
    farthest along +x+y: AD, d sum(image) / d that copy along its outward
    direction u in the image plane (the mean over PROJ_COPY_SEEDS), against
    FD, the forward difference of moving that copy alone by PROJ_COPY_EPS
    along u (one-sided: the mesh opens there) at PROJ_COPY_FD_SPP; the
    other copies' AD along u, which must be 0."""
    g = scene.geometry
    _, lo, hi = dict(scene.param_paths)[key][-1]
    T = g.n_real_tris
    faces = g.tri_face[:T]
    mine = ((faces >= lo) & (faces < hi)).all(dim=1)
    cam = scene.sensors[0].position
    centroid = g.tri_v0 + (g.tri_e1 + g.tri_e2) / 3.0
    seen = mine & (torch.sum(g.tri_ng * (cam - centroid), -1) > 0)[:T]
    face_v = torch.unique(faces[seen]) - lo
    base = mi.traverse(scene)[key].detach().clone()
    c = int(face_v[torch.argmax(base[face_v, 0] + base[face_v, 1])])
    copies = (base == base[c]).all(dim=1).nonzero()[:, 0]
    if copies.numel() != 3 or int(copies.min()) == c:
        raise AssertionError(f"cube copies {copies.tolist()} of corner {c}: the check would not "
                             "tell the copies apart")
    view = cam - base[c]
    u = base[c] - base[face_v].mean(dim=0)
    u = u - torch.dot(u, view) / torch.dot(view, view) * view
    u = u / u.norm()
    grads = []
    for seed in PROJ_COPY_SEEDS:
        v = base.clone().requires_grad_()
        mi.render(mi.traverse(scene).update({key: v}), spp=spp, seed=seed).sum().backward()
        grads.append(v.grad @ u)
    ad_all = torch.stack(grads).mean(dim=0)
    integ = scene.integrator.base

    def loss(eps):
        moved = base.clone()
        moved[c] += eps * u
        sc = mi.traverse(scene).update({key: moved})
        return float(mi.render(sc, spp=PROJ_COPY_FD_SPP, seed=PROJ_SEEDS[0], integrator=integ,
                               spp_per_pass=64).sum())

    l0 = loss(0.0)
    fd, fd_in = (loss(PROJ_COPY_EPS) - l0) / PROJ_COPY_EPS, (l0 - loss(-PROJ_COPY_EPS)) / PROJ_COPY_EPS
    ad = float(ad_all[c])
    others = [float(ad_all[i]) for i in copies.tolist() if i != c]
    out = dict(corner=c, copies=copies.tolist(), ad=ad, ad_others=others, fd_out=fd,
               fd_in=fd_in, rel=abs(ad - fd) / abs(fd))
    log(f"  projective cube: vertex copy {c} of copies {copies.tolist()} (the face seen), along "
        f"its outward direction: AD {ad:.6g} (the others {others}) against the one-sided FD "
        f"{fd:.6g} ({out['rel']:.4%}, rtol {PROJ_COPY_RTOL}; inward {fd_in:.6g})")
    if any(x != 0.0 for x in others) or not out["rel"] <= PROJ_COPY_RTOL:
        raise AssertionError(f"projective cube: the vertex copies' cotangent {out}")
    return out


def cbox64_held_to_jax(mi):
    """The cbox's projective gradient at 64x64 (its configuration at a
    smaller film, 16 spp, seed 7) against the JAX package's,
    JAX_CBOX64_PROJ_GRAD: the interior term alone, with the primary
    silhouettes, and the whole."""
    d, key, _, _ = projective_scenes(mi)["cbox"]
    d["sensor"]["film"].update(width=64, height=64)
    out = {}
    for (sppp, sppi), want in JAX_CBOX64_PROJ_GRAD.items():
        d["integrator"] = dict(d["integrator"], sppp=sppp, sppi=sppi)
        scene = mi.load_dict(d)
        label = f"projective cbox 64x64 @ 16 spp, sppp {sppp}, sppi {sppi}"
        got = projective_ad(mi, scene, key, 16, 7)
        rel = abs(got - want) / abs(want)
        tol = PROJ_CBOX64_RTOL[(sppp, sppi)]
        log(f"  {label}: AD {got:.9g} against the JAX package's {want:.9g}: {rel:.3e} (rtol {tol})")
        if not rel <= tol:
            raise AssertionError(f"{label}: AD {got} against the JAX package's {want}")
        out[f"{sppp},{sppi}"] = dict(ad=got, jax=want, rel=rel)
    return out


def phase_projective(mi, K1, K2, K3):
    """The projective gradients on the card, each the derivative of
    sum(image) for a uniform scale of a shape (scale_offset), AD the mean
    over seeds 7 and 11 (as tests/test_projective.py averages), FD a central
    difference (eps 1e-2) at the same seed 7. The cbox at 256x256,
    prb_projective max_depth 4, sppp 4, sppi 4, the small box, AD at 64
    spp and FD at 256 (printed, not held against FD: PROJ_RTOL), and at
    64x64 held against the JAX package's gradient, part by part
    (cbox64_held_to_jax); the silhouette and point-shadow scenes of
    tests/test_projective.py and the flat cube (24x24, direct_projective,
    AD 64 spp, FD 512) within 8%, 12% and 8%, and the flat cube's vertex
    copies (cube_copy_check). The first AD step of each has every K1
    forward launch held bit for bit against the plain version and every K1
    backward (hit_vjp, in the tape passes) against torch.func.vjp of the
    plain Moller-Trumbore (k1_vjp_held_to_autograd); its peak memory is
    read."""
    out = {}
    for name, (d, key, spp, fd_spp) in projective_scenes(mi).items():
        scene = mi.load_dict(d)
        res = scene.film.width
        label = (f"projective {name} {res}x{res}, {d['integrator']['type']}, AD {spp} spp, FD "
                 f"{fd_spp} spp")
        held, held_vjp, stats = [], [], {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(K1, K2, K3)
        t0 = time.perf_counter()
        with k1_held_to_plain(K1, held), k1_vjp_held_to_autograd(K1, held_vjp):
            ads = [projective_ad(mi, scene, key, spp, PROJ_SEEDS[0], stats)]
        torch.cuda.synchronize()
        held_wall = time.perf_counter() - t0
        k1 = K1.smem_intersect.launches
        peak = torch.cuda.max_memory_allocated()
        others = K2.bvh_sweep_intersect.launches + K3.mxu_intersect.launches
        bitwise = k1_held_summary(f"{label}, AD step", held)
        vjp_held = k1_vjp_held_summary(f"{label}, AD step", held_vjp)
        if others:
            raise AssertionError(f"{label}: K2/K3 ran ({others})")
        walls = []
        for seed in PROJ_SEEDS[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with no_plain_closest_hit(K1, label):
                ads.append(projective_ad(mi, scene, key, spp, seed))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        ad = sum(ads) / len(ads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_plain_closest_hit(K1, label):
            fd = projective_fd(mi, scene, key, fd_spp, PROJ_SEEDS[0])
        fd_wall = time.perf_counter() - t0
        rel = abs(ad - fd) / abs(fd)
        log(f"== main path: {label}: AD {ads} (mean {ad:.6g}) against FD {fd:.6g}: {rel:.4%} "
            f"({'rtol ' + str(PROJ_RTOL[name]) if PROJ_RTOL[name] else 'not held: no crease term'}); AD step {held_wall:.3f} s with K1 held, "
            f"{[round(w, 4) for w in walls]} s timed, FD {fd_wall:.3f} s; K1 launches in the held "
            f"step {k1}, peak memory {peak / 2**30:.3f} GiB; forward rays {stats.get('n_rays')}")
        if not all(math.isfinite(a) for a in ads) or (
                PROJ_RTOL[name] is not None and not rel <= PROJ_RTOL[name]):
            raise AssertionError(f"{label}: AD {ad} against FD {fd}")
        out[name] = dict(ad=ads, fd=fd, rel=rel, held_step_wall=held_wall, step_walls=walls,
                         fd_wall=fd_wall, k1_per_step=k1, peak=peak, k1_bitwise_vs_plain=bitwise,
                         hit_vjp_held=vjp_held)
        with no_plain_closest_hit(K1, label):
            if name == "cube":
                out[name]["vertex_copy"] = cube_copy_check(mi, scene, key, spp)
            elif name == "cbox":
                out[name]["held_to_jax_64"] = cbox64_held_to_jax(mi)
    return out


def rayleigh_gold_dict(tau, theta_deg, max_depth):
    """tests/test_rayleigh_slab_gold.py's scene: a zenith sun over a
    conservative Rayleigh slab, a radiancemeter looking up at theta."""
    st, ct = np.sin(np.radians(theta_deg)), np.cos(np.radians(theta_deg))
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": max_depth},
        "sun": {"type": "directional", "direction": [0, 0, -1], "irradiance": 1.0},
        "slab": {"type": "cube", "to_world": [{"type": "scale", "value": [2000.0, 2000.0, 0.5]}],
                 "bsdf": {"type": "null"},
                 "interior": {"type": "homogeneous", "sigma_t": tau, "albedo": 1.0,
                              "phase": {"type": "rayleigh", "depolarization": 0.0}}},
        "sensor": {"type": "radiancemeter", "wavelength": 550.0,
                   "to_world": [{"type": "look_at", "origin": [0.0, 0.0, -2.0],
                                 "target": [2.0 * st, 0.0, -2.0 + 2.0 * ct], "up": [0, 1, 0]}],
                   "film": {"type": "hdrfilm", "width": 4, "height": 4,
                            "rfilter": {"type": "box"}}},
    }


def chandrasekhar_dict(theta_deg, theta0_deg):
    """tests/test_chandrasekhar_gold.py's scene: a semi-infinite isotropic
    slab (tau 30, albedo 0.8) under a directional light, seen from above."""
    s, c = np.sin(np.radians(theta_deg)), np.cos(np.radians(theta_deg))
    s0, c0 = np.sin(np.radians(theta0_deg)), np.cos(np.radians(theta0_deg))
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 48, "rr_depth": 16, "track_steps": 8,
                       "nee_steps": 8},
        "light": {"type": "directional", "direction": [s0, 0.0, -c0], "irradiance": 1.0},
        "slab": {"type": "cube", "to_world": [{"type": "scale", "value": [2000.0, 2000.0, 10.0]}],
                 "bsdf": {"type": "null"},
                 "interior": {"type": "homogeneous", "sigma_t": 1.5, "albedo": CHANDRA_OMEGA,
                              "phase": {"type": "isotropic"}}},
        "sensor": {"type": "radiancemeter",
                   "to_world": [{"type": "look_at", "origin": [0.0, 0.0, 12.0],
                                 "target": [2.0 * s, 0.0, 12.0 - 2.0 * c], "up": [0, 1, 0]}],
                   "film": {"type": "hdrfilm", "width": 4, "height": 4,
                            "rfilter": {"type": "box"}}},
    }


def h_at(mu_eval, omega, n_nodes=64, iters=800):
    """Chandrasekhar's H at mu_eval from its fixed point on Gauss-Legendre
    nodes (tests/test_chandrasekhar_gold.py's solver)."""
    x, w = np.polynomial.legendre.leggauss(n_nodes)
    mu, wq = 0.5 * (x + 1.0), 0.5 * w
    H = np.ones(n_nodes)
    for _ in range(iters):
        H = 1.0 / (1.0 - 0.5 * omega * mu * ((H * wq)[None, :] / (mu[:, None] + mu[None, :])).sum(-1))
    return 1.0 / (1.0 - 0.5 * omega * mu_eval * ((H * wq) / (mu_eval + mu)).sum())


def phase_golds(mi, K1, K2, K3):
    """The two physics golds at their tests' sample counts, each within its
    test's own bound: the Rayleigh slab in mono_polarized at 16,384 spp,
    single scattering (the analytic Stokes vector: I within 3%, DoLP within
    0.02) and multiple scattering (the adding-doubling solution,
    mitsuba_tpu_torch/utils/doubling.py: I within 3%, Q within 0.02 I);
    Chandrasekhar's semi-infinite reflection in mono at 8,192 spp (within
    5%). Every render through K1 alone; the first one's launches held bit
    for bit against the plain version."""
    from mitsuba_tpu_torch.utils.doubling import doubling_slab

    out, held = {}, []

    def timed(fn):
        torch.cuda.synchronize()
        before = K1.smem_intersect.launches
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        return val, time.perf_counter() - t0, K1.smem_intersect.launches - before

    mi.set_variant("mono_polarized")
    try:
        cases = [("single", tau, th, 2) for tau, th in ((0.25, 60.0), (0.5, 40.0), (0.1, 75.0))]
        cases += [("multiple", tau, th, 64) for tau, th in ((0.25, 60.0), (0.5, 40.0))]
        for i, (kind, tau, th, depth) in enumerate(cases):
            scene = mi.load_dict(rayleigh_gold_dict(tau, th, depth))
            seed = 1 if kind == "single" else 3
            if i == 0:
                with k1_held_to_plain(K1, held):
                    stokes, wall, k1 = timed(lambda: mi.render_1(scene, spp=RAYLEIGH_SPP,
                                                                 seed=seed))
            else:
                with no_plain_closest_hit(K1, "golds"):
                    stokes, wall, k1 = timed(lambda: mi.render_1(scene, spp=RAYLEIGH_SPP,
                                                                 seed=seed))
            I, Q, U, V = stokes[:, 0].tolist()
            mu = float(np.cos(np.radians(th)))
            if kind == "single":
                I_ref = tau * 3.0 / (16.0 * np.pi) * (1.0 + mu * mu) * np.exp(-tau) * (
                    np.exp(tau * (mu - 1.0) / mu) - 1.0) / (tau * (mu - 1.0))
                Q_ref = -I_ref * (1.0 - mu * mu) / (1.0 + mu * mu)
            else:
                I_ref, Q_ref = (float(x) for x in
                                doubling_slab(tau, [mu], n_gauss=24, nphi=64)["trans"][0])
            errs = dict(I=abs(I - I_ref) / I_ref, dolp=abs(abs(Q) / I - abs(Q_ref) / I_ref),
                        Q=abs(Q - Q_ref) / I_ref, U=abs(U) / I, V=abs(V) / I)
            ok = (errs["I"] < 0.03 and errs["dolp"] < 0.02 and Q < 0 and errs["U"] < 0.02
                  and errs["V"] < 0.01 and (kind == "single" or errs["Q"] < 0.02))
            key = f"rayleigh {kind} tau {tau} theta {th}"
            log(f"  golds {key}, mono_polarized 4x4 @ {RAYLEIGH_SPP} spp, max_depth {depth}: "
                f"{wall:.3f} s, K1 {k1}; I, Q, U, V {[I, Q, U, V]} against I {I_ref:.6g}, Q "
                f"{Q_ref:.6g}: {({k: round(v, 5) for k, v in errs.items()})}")
            if not ok:
                raise AssertionError(f"golds {key}: {errs}")
            out[key] = dict(stokes=[I, Q, U, V], ref=[I_ref, Q_ref], errs=errs, wall=wall, k1=k1)
    finally:
        mi.set_variant("rgb")
    bitwise = k1_held_summary("golds rayleigh single render", held)
    mi.set_variant("mono")
    try:
        for th, th0 in ((0.0, 30.0), (45.0, 30.0)):
            scene = mi.load_dict(chandrasekhar_dict(th, th0))
            with no_plain_closest_hit(K1, "golds"):
                img, wall, k1 = timed(lambda: mi.render(scene, spp=CHANDRA_SPP, seed=11))
            mu, mu0 = np.cos(np.radians(th)), np.cos(np.radians(th0))
            want = (CHANDRA_OMEGA / (4.0 * np.pi) * mu0 / (mu + mu0)
                    * h_at(mu, CHANDRA_OMEGA) * h_at(mu0, CHANDRA_OMEGA))
            got = float(img.mean())
            rel = abs(got - want) / want
            key = f"chandrasekhar theta {th} theta0 {th0}"
            log(f"  golds {key}, mono 4x4 @ {CHANDRA_SPP} spp: {wall:.3f} s, K1 {k1}; {got:.6g} "
                f"against {want:.6g}: {rel:.4%} (rtol 0.05)")
            if not rel < 0.05:
                raise AssertionError(f"golds {key}: {got} against {want}")
            out[key] = dict(got=got, want=want, rel=rel, wall=wall, k1=k1)
    finally:
        mi.set_variant("rgb")
    out["k1_bitwise_vs_plain"] = bitwise
    return out


# ---------------------------------------------------------------------------
# the material preview (PR 13): analytic spheres, the envmap, spot,
# projector, fused and collimated area lights; the thin lens, the
# orthographic, irradiancemeter, distant and batch sensors; the crop window
# and the negative-lobe filters
# ---------------------------------------------------------------------------

SPHERES_RES, SPHERES_SPP, SPHERES_RENDERS = 256, 64, 2
# the other new phases' film, and the films of their checks against the JAX
# package
SLICE13_RES, SLICE13_RES64 = 256, 64
# a crop window of the spheres render: (x, y) offset and (width, height)
SPHERES_CROP = ((64, 96), (96, 64))
SPHERES_PRB_KEYS = ("sky.data", "diffuse-ball.bsdf.reflectance.value")
PTRACER_INTEGRATOR = {"type": "ptracer", "max_depth": 8}
MANYLIGHTS_SPP = 64
SENSORS_SPP = 16
ATMO_SENSOR_RES, ATMO_SENSOR_SPP = 32, 64
SPHERES_MESH_SPP = 16
# the new phases' 64x64 means and gradients against the JAX package's
SLICE13_RTOL = 1e-3
SLICE13_SPP64 = 16
# path and ptracer estimate the same image; their 64 spp means agree to
# the noise of the particles (tests/test_ptracer.py's 5%)
MANYLIGHTS_ESTIMATORS_RTOL = 0.05
# The JAX package's values, computed once with mitsuba_tpu on the CPU by
# scripts/torch_slice13_constants.py (its docstring says how each is
# made; ~10 minutes), at seed 0, 64x64 @ 16 spp unless said:
# - spheres_scene (path max_depth 8, mitchell): the pixels within the
#   filter's radius of a lane whose path parts between the packages (the
#   JAX package op by op against the port on the CPU), and the JAX
#   package's means over the others (as PR 10 held the materials scene):
SPHERES64_PARTING_PIXELS = (
    1669, 1670, 1671, 1672, 1673, 1689, 1690, 1691, 1692, 1693, 1733, 1734, 1735, 1736, 1737,
    1753, 1754, 1755, 1756, 1757, 1763, 1764, 1765, 1766, 1767, 1797, 1798, 1799, 1800, 1801,
    1817, 1818, 1819, 1820, 1821, 1827, 1828, 1829, 1830, 1831, 1857, 1858, 1859, 1860, 1861,
    1862, 1863, 1864, 1865, 1881, 1882, 1883, 1884, 1885, 1891, 1892, 1893, 1894, 1895, 1914,
    1915, 1916, 1917, 1918, 1921, 1922, 1923, 1924, 1925, 1926, 1927, 1928, 1929, 1945, 1946,
    1947, 1948, 1949, 1954, 1955, 1956, 1957, 1958, 1959, 1968, 1969, 1970, 1971, 1972, 1973,
    1974, 1975, 1976, 1977, 1978, 1979, 1980, 1981, 1982, 1985, 1986, 1987, 1988, 1989, 2007,
    2008, 2009, 2010, 2011, 2018, 2019, 2020, 2021, 2022, 2023, 2026, 2027, 2028, 2029, 2030,
    2032, 2033, 2034, 2035, 2036, 2037, 2038, 2039, 2040, 2041, 2042, 2043, 2044, 2045, 2046,
    2049, 2050, 2051, 2052, 2053, 2069, 2070, 2071, 2072, 2073, 2074, 2075, 2082, 2083, 2084,
    2085, 2086, 2090, 2091, 2092, 2093, 2094, 2096, 2097, 2098, 2099, 2100, 2101, 2102, 2103,
    2104, 2105, 2106, 2107, 2108, 2109, 2110, 2113, 2114, 2115, 2116, 2117, 2128, 2129, 2130,
    2131, 2132, 2133, 2134, 2135, 2136, 2137, 2138, 2139, 2146, 2147, 2148, 2149, 2150, 2154,
    2155, 2156, 2157, 2158, 2159, 2160, 2161, 2162, 2163, 2164, 2165, 2166, 2167, 2168, 2169,
    2170, 2171, 2172, 2173, 2174, 2192, 2193, 2194, 2195, 2196, 2197, 2198, 2199, 2200, 2201,
    2202, 2203, 2210, 2211, 2212, 2213, 2214, 2218, 2219, 2220, 2221, 2222, 2223, 2224, 2225,
    2226, 2227, 2228, 2229, 2230, 2231, 2232, 2233, 2255, 2256, 2257, 2258, 2259, 2260, 2261,
    2262, 2263, 2264, 2265, 2266, 2267, 2282, 2283, 2284, 2285, 2286, 2287, 2316, 2317, 2318,
    2319, 2320, 2321, 2322, 2323, 2324, 2325, 2326, 2327, 2328, 2329, 2347, 2348, 2349, 2350,
    2351, 2380, 2381, 2382, 2383, 2384, 2385, 2386, 2387, 2388, 2389, 2390, 2391, 2392, 2393,
    2394, 2395, 2396, 2397, 2398, 2411, 2412, 2413, 2414, 2415, 2444, 2445, 2446, 2447, 2448,
    2449, 2450, 2451, 2452, 2453, 2454, 2455, 2456, 2457, 2458, 2459, 2460, 2461, 2462, 2498,
    2499, 2500, 2501, 2502, 2508, 2509, 2510, 2511, 2512, 2513, 2514, 2515, 2516, 2517, 2518,
    2519, 2520, 2521, 2522, 2523, 2524, 2525, 2526, 2562, 2563, 2564, 2565, 2566, 2567, 2568,
    2569, 2570, 2572, 2573, 2574, 2575, 2576, 2577, 2578, 2579, 2580, 2581, 2582, 2583, 2584,
    2585, 2586, 2587, 2588, 2589, 2590, 2626, 2627, 2628, 2629, 2630, 2631, 2632, 2633, 2634,
    2635, 2636, 2637, 2638, 2640, 2641, 2642, 2643, 2644, 2645, 2646, 2647, 2648, 2649, 2650,
    2651, 2652, 2653, 2654, 2690, 2691, 2692, 2693, 2694, 2695, 2696, 2697, 2698, 2699, 2700,
    2701, 2702, 2703, 2704, 2705, 2706, 2707, 2708, 2712, 2713, 2714, 2715, 2716, 2717, 2718,
    2719, 2754, 2755, 2756, 2757, 2758, 2759, 2760, 2761, 2762, 2763, 2764, 2765, 2766, 2767,
    2777, 2778, 2779, 2780, 2781, 2782, 2783, 2822, 2823, 2824, 2825, 2826, 2827, 2828, 2829,
    2830, 2831, 2841, 2842, 2843, 2844, 2845, 2846, 2847, 2886, 2887, 2888, 2889, 2890, 2891,
    2892, 2893, 2894, 2895, 2905, 2906, 2907, 2908, 2909, 2910, 2911, 2950, 2951, 2952, 2953,
    2954, 2955, 2956, 2957, 2958, 2959, 2970, 2971, 2972, 2973, 2974, 2975)
JAX_SPHERES64_KEPT_MEANS = (0.47568437457084656, 0.47659072279930115, 0.5380203723907471)
# (the whole image's means (0.45725053548812866, 0.45442354679107666, 0.514112651348114))
# - the same with prb max_depth 4: the image mean's gradient for the
#   envmap's data (its sum, and its 8 largest texels (flat index, value))
#   and for the diffuse sphere's reflectance:
JAX_SPHERES_PRB64_ENV_SUM = 0.6571254470629322
JAX_SPHERES_PRB64_ENV_TOP = (
    (48345, 0.0005544176092371345),
    (48347, 0.0005544103332795203),
    (48346, 0.0005544081213884056),
    (47647, 0.0005455861683003604),
    (47646, 0.0005455861683003604),
    (47648, 0.0005455014179460704),
    (49886, 0.0005340577918104827),
    (49884, 0.0005340577918104827),
)
JAX_SPHERES_PRB64_REFLECTANCE = (0.012964059598743916, 0.014849632047116756, 0.019113406538963318)
# - manylights_scene: path, ptracer (max_depth 8), and ptracer with the
#   collimated panel:
JAX_MANYLIGHTS64_MEANS = {
    "path": (0.23527120053768158, 0.1385444700717926, 0.05887692794203758),
    "ptracer": (0.2338198572397232, 0.13802234828472137, 0.058666497468948364),
    "ptracer_beam": (0.24392056465148926, 0.14240671694278717, 0.0620056614279747),
}
# - the cbox through orthographic_dict; render_test of batch_dict's two
#   views; projector_scene:
JAX_ORTHO64_MEANS = (0.2003616839647293, 0.09401460736989975, 0.03769419342279434)
JAX_BATCH64_VIEWS = (
    (0.21746046841144562, 0.134737029671669, 0.05642932280898094),
    (0.2299264818429947, 0.12829086184501648, 0.05599765479564667),
)
JAX_PROJECTOR64_MEANS = (0.2566309869289398, 0.15611697733402252, 0.07388084381818771)
# - mono_polarized, render_1 of atmo_sensor_dict at 32x32 @ 64 spp: the
#   Stokes vectors I, Q, U, V:
JAX_ATMO_DISTANT_STOKES = (0.15025874972343445, -0.0003628835256677121, 4.064658423885703e-05, 2.723799354953371e-07)
JAX_ATMO_IRRADIANCEMETER_STOKES = (0.3586234152317047, -0.05528111010789871, -1.0919757187366486e-05, 1.1950707630603574e-05)
# - spheres_mesh_dict at 64x64 @ 4 spp (the BVH's plain walk on the CPU):
JAX_SPHERES_MESH64_MEANS = (0.2600877285003662, 0.17333519458770752, 0.10427005589008331)


def orthographic_dict(mi, res, spp):
    """The cbox seen by an orthographic sensor from (0, 0, 3.9) along -z,
    its film's [-1, 1]^2 square the box's front."""
    d = mi.cornell_box()
    d["sensor"] = {"type": "orthographic",
                   "to_world": [{"type": "look_at", "origin": [0, 0, 3.9], "target": [0, 0, 0],
                                 "up": [0, 1, 0]}],
                   "film": {"type": "hdrfilm", "width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}}
    return d


def batch_dict(mi, res, spp):
    """The cbox seen by a batch of two perspectives side by side on one
    2 res x res film (from x = -0.6 and 0.6), render_test's views."""
    d = mi.cornell_box()
    views = {f"view{i}": {"type": "perspective", "fov": 40.0,
                          "to_world": [{"type": "look_at", "origin": [x, 0.0, 3.9],
                                        "target": [0, 0, 0], "up": [0, 1, 0]}],
                          "film": {"type": "hdrfilm", "width": res, "height": res}}
             for i, x in enumerate((-0.6, 0.6))}
    d["sensor"] = {"type": "batch", "film": {"type": "hdrfilm", "width": 2 * res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}, **views}
    return d


def atmo_sensor_dict(mi, name):
    """BASELINE config 4's atmosphere (atmo_scene) seen by a distant sensor
    (direction (0.2, 0, -1) onto the origin: the top-of-atmosphere view) or
    by an irradiancemeter at (0, 0, -1.5) under the slab looking up (the
    downwelling flux), pinned to 550 nm, at ATMO_SENSOR_RES^2 @
    ATMO_SENSOR_SPP."""
    d = mi.atmo_scene(ATMO_SENSOR_RES, ATMO_SENSOR_SPP)
    sensor = {"film": d["sensor"]["film"], "sampler": d["sensor"]["sampler"]}
    if name == "distant":
        sensor.update(type="distant", direction=[0.2, 0.0, -1.0], target=[0.0, 0.0, 0.0],
                      wavelength=550.0)
    else:
        sensor.update(type="irradiancemeter",
                      to_world=[{"type": "look_at", "origin": [0.0, 0.0, -1.5],
                                 "target": [0.0, 0.0, 0.0], "up": [0, 1, 0]}])
    d["sensor"] = sensor
    return d


def spheres_mesh_dict(mi, obj_path, res):
    """mesh_scene (202,822 triangles on the BVH) with an analytic diffuse
    sphere (radius 0.3 at (-0.45, -0.6, 0.3)) and spheres_scene's envmap."""
    from mitsuba_tpu_torch.render.scene_loader import mesh_scene, sky_envmap

    d = mesh_scene(obj_path, k=MESH_K, res=res)
    d["ball"] = {"type": "sphere", "center": [-0.45, -0.6, 0.3], "radius": 0.3,
                 "bsdf": {"type": "diffuse", "reflectance": {"type": "rgb",
                                                             "value": [0.3, 0.6, 0.3]}}}
    d["sky"] = {"type": "envmap", "data": sky_envmap(), "scale": 0.5}
    return d


def check_means(name, got, want):
    """Each channel of `got` within SLICE13_RTOL of the JAX package's
    `want`; returns the worst relative error."""
    rtol = SLICE13_RTOL
    got = [float(x) for x in got]
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    log(f"  {name}: {got} against the JAX package's {list(want)}: {rel:.3e} relative "
        f"(tolerance {rtol})")
    if not rel <= rtol:
        raise AssertionError(f"{name}: {got} vs JAX {list(want)}")
    return rel


def check_stokes(name, stokes, want):
    """A Stokes vector [4, 1] as the atmo phase holds it: I within
    SLICE13_RTOL, Q, U, V within SLICE13_RTOL of I. Returns the worst
    error."""
    rtol = SLICE13_RTOL
    I, Q, U, V = stokes[:, 0].tolist()
    rel_i = abs(I - want[0]) / abs(want[0])
    quv = max(abs(a - b) / I for a, b in zip((Q, U, V), want[1:]))
    log(f"  {name}: Stokes {[I, Q, U, V]} against the JAX package's {list(want)}: I within "
        f"{rel_i:.3e}, Q/U/V within {quv:.3e} of I (tolerance {rtol})")
    if not (rel_i <= rtol and quv <= rtol and I > 0):
        raise AssertionError(f"{name}: Stokes {[I, Q, U, V]} vs JAX {list(want)}")
    return max(rel_i, quv)


def timed_render(K1, K2, K3, name, fn, n=1):
    """A main path's call fn(seed, stats) (a render, render_test or
    render_1): one call at seed 1 with CUDA events around each K1 launch
    and every launch held bit for bit against the plain version, then n
    timed calls at seed 0 (timed_calls: walls, K1 launches, rays, Mrays/s,
    peak memory). Fails on a result that is not finite or all zero.
    Returns (the last result, summary dict)."""
    n_k1, k_ms, b2b_ms, b_ms, by, bitwise = k1_in_place_and_held(K1, name, lambda: fn(1, {}))
    walls, per, stats, res, peak = timed_calls(K1, K2, K3, name, fn, n, warm_up=False)
    if not bool(torch.isfinite(res).all()) or not float(res.abs().max()) > 0:
        raise AssertionError(f"{name}: result {tuple(res.shape)} not finite or all zero")
    mrays = [stats["n_rays"] / w / 1e6 for w in walls]
    log(f"== main path: {name}: walls {[round(w, 4) for w in walls]} s, {stats['n_rays']} rays, "
        f"{[round(m, 2) for m in mrays]} Mrays/s, K1 launches per call {per}, peak memory "
        f"{peak / 2**30:.3f} GiB; one call with events around each K1 launch: {n_k1} launches, "
        f"{k_ms:.3f} ms in K1 in place, {b2b_ms:.4f} ms back to back, summed bound "
        f"{b_ms:.4f} ms {by}")
    return res, dict(walls=walls, mrays=mrays, n_rays=stats["n_rays"], k1_per_render=per[0],
                     peak=peak, k1_render_ms=k_ms, k1_render_back_to_back_ms=b2b_ms,
                     k1_render_bound_ms=b_ms, k1_bound_by=by, k1_bitwise_vs_plain=bitwise)


def rendered(mi, scene, spp):
    """fn(seed, stats) for timed_render: one render of `scene` at spp."""
    return lambda seed, stats: mi.render(scene, spp=spp, seed=seed, stats=stats)


def phase_spheres(mi, K1, K2, K3):
    """The slice's main path: spheres_scene (three analytic spheres, a
    sphere light, a spot, an envmap, a thin lens, a mitchell filter) at
    256x256 @ 64 spp (4,194,304 lanes), path max_depth 8, through K1 and
    the sphere pass: one render with every K1 launch held bit for bit,
    SPHERES_RENDERS timed renders; a crop window bit for bit the full
    render's window; the 64x64 @ 16 spp means against the JAX package's
    over the pixels where no lane's path parts."""
    scene = mi.load_dict(mi.spheres_scene(SPHERES_RES, SPHERES_SPP))
    name = (f"spheres {SPHERES_RES}x{SPHERES_RES} @ {SPHERES_SPP} spp, thinlens, mitchell, path "
            "max_depth 8")
    img, out = timed_render(K1, K2, K3, name, rendered(mi, scene, SPHERES_SPP), SPHERES_RENDERS)
    if tuple(img.shape) != (SPHERES_RES, SPHERES_RES, 3):
        raise AssertionError(f"{name}: image {tuple(img.shape)}")
    out["means"] = img.mean(dim=(0, 1)).tolist()
    log(f"  {name}: means {out['means']}")
    (x0, y0), (cw, ch) = SPHERES_CROP
    d = mi.spheres_scene(SPHERES_RES, SPHERES_SPP)
    d["sensor"]["film"].update(crop_offset_x=x0, crop_offset_y=y0, crop_width=cw, crop_height=ch)
    crop_scene = mi.load_dict(d)
    crop = mi.render(crop_scene, spp=SPHERES_SPP, seed=0)
    window = img[y0:y0 + ch, x0:x0 + cw]
    out["crop_bitwise"] = tuple(crop.shape) == tuple(window.shape) and bool(torch.equal(crop, window))
    log(f"  {name}: the crop window {SPHERES_CROP} ({crop_scene.film.n_pixels * SPHERES_SPP} "
        f"lanes with the filter's margin) bit for bit the full render's window: "
        f"{out['crop_bitwise']}")
    if not out["crop_bitwise"]:
        raise AssertionError(f"{name}: the crop render differs from the full render's window")
    img64 = mi.render(mi.load_dict(mi.spheres_scene(SLICE13_RES64, SLICE13_SPP64)), spp=SLICE13_SPP64, seed=0)
    out["means64_rel_err"] = check_kept_means(
        f"spheres {SLICE13_RES64}^2 @ {SLICE13_SPP64} spp", img64, SPHERES64_PARTING_PIXELS,
        JAX_SPHERES64_KEPT_MEANS, SLICE13_RTOL)
    return out


def phase_spheres_prb(mi, K1, K2, K3):
    """spheres_scene with prb at 256x256 @ 64 spp, max_depth 8: the image
    mean's gradients for the envmap's data (the texel gather's backward
    accumulates with atomics on the card) and the diffuse sphere's
    reflectance (run_prb_vol: warm-up, timed steps, every K1 launch of a
    step held bit for bit); the 64x64 @ 16 spp gradients at max_depth 4
    against the JAX package's (allclose: the atomics' order)."""
    keys = list(SPHERES_PRB_KEYS)
    integ = {"type": "prb", "max_depth": 8}

    def loss(mi, sc, seed, stats, spp=SPHERES_SPP):
        return mi.render(sc, spp=spp, seed=seed, stats=stats).mean()

    scene = mi.load_dict(mi.spheres_scene(SPHERES_RES, SPHERES_SPP, integ))
    out = run_prb_vol(mi, K1, K2, K3, f"spheres-prb {SPHERES_RES}x{SPHERES_RES} @ {SPHERES_SPP} "
                      "spp, prb max_depth 8", scene, keys, loss,
                      SPHERES_RES * SPHERES_RES * SPHERES_SPP)
    out["grads"] = {k: [float(v.sum()), float(v.abs().max())] for k, v in out["grads"].items()}
    small = mi.load_dict(mi.spheres_scene(SLICE13_RES64, SLICE13_SPP64, dict(integ, max_depth=4)))
    _, g64, _, _, _ = prb_vol_step(mi, small, keys,
                                   lambda mi, sc, seed, st: loss(mi, sc, seed, st, SLICE13_SPP64), 0)
    env = g64[keys[0]].reshape(-1)
    rels = [check_rel("spheres-prb 64x64 @ 16 spp, max_depth 4, the sum of d mean / d sky.data",
                      float(env.double().sum()), JAX_SPHERES_PRB64_ENV_SUM, SLICE13_RTOL)]
    for i, want in JAX_SPHERES_PRB64_ENV_TOP:
        rels.append(check_rel(f"  ... d mean / d sky.data texel {i}", float(env[i]), want,
                              SLICE13_RTOL))
    for c, want in enumerate(JAX_SPHERES_PRB64_REFLECTANCE):
        rels.append(check_rel(f"  ... d mean / d {keys[1]}[{c}]", float(g64[keys[1]][c]), want,
                              SLICE13_RTOL))
    out["grad64_depth4_rel_err"] = max(rels)
    return out


def phase_manylights(mi, K1, K2, K3):
    """The cbox lit by 8 constant panels, which the loader fuses into one
    AreaEmitterArray, at 256x256 @ 64 spp: path (max_depth 8) and ptracer
    (max_depth 8), each with every K1 launch of one render held bit for
    bit and one timed render; their means against each other; the 64x64 @
    16 spp means of both and of the ptracer with a collimated panel
    (directionalarea) against the JAX package's."""
    out = {}
    imgs = {}
    for integ in ("path", "ptracer"):
        spec = {"type": "path", "max_depth": 8} if integ == "path" else PTRACER_INTEGRATOR
        scene = mi.load_dict(mi.manylights_scene(SLICE13_RES, MANYLIGHTS_SPP, spec))
        if type(scene.emitters[0]).__name__ != "AreaEmitterArray" or len(scene.emitters) != 1:
            raise AssertionError(f"manylights: emitters {scene.emitters} not one fused array")
        imgs[integ], out[integ] = timed_render(
            K1, K2, K3, f"manylights {integ} {SLICE13_RES}^2 @ {MANYLIGHTS_SPP} spp, max_depth 8",
            rendered(mi, scene, MANYLIGHTS_SPP))
    a, b = float(imgs["path"][8:].mean()), float(imgs["ptracer"][8:].mean())
    out["path_vs_ptracer_rel"] = abs(a - b) / a
    log(f"  manylights: ptracer's mean below row 8 {b:.6f} against path's {a:.6f}: "
        f"{out['path_vs_ptracer_rel']:.4%} (rtol {MANYLIGHTS_ESTIMATORS_RTOL})")
    if not out["path_vs_ptracer_rel"] <= MANYLIGHTS_ESTIMATORS_RTOL:
        raise AssertionError(f"manylights: ptracer {b} against path {a}")
    rels = []
    for key, spec, beam in (("path", {"type": "path", "max_depth": 8}, False),
                            ("ptracer", PTRACER_INTEGRATOR, False),
                            ("ptracer_beam", PTRACER_INTEGRATOR, True)):
        img64 = mi.render(mi.load_dict(mi.manylights_scene(SLICE13_RES64, SLICE13_SPP64, spec, beam=beam)),
                          spp=SLICE13_SPP64, seed=0)
        rels.append(check_means(f"manylights {key} {SLICE13_RES64}^2 @ {SLICE13_SPP64} spp",
                                img64.mean(dim=(0, 1)), JAX_MANYLIGHTS64_MEANS[key]))
    out["means64_rel_err"] = max(rels)
    return out


def phase_sensors(mi, K1, K2, K3):
    """The new sensors: the cbox through an orthographic sensor (256x256 @
    16 spp) and a batch of two perspectives through render_test (2 x
    128x128 @ 16 spp); BASELINE config 4's atmosphere (mono_polarized)
    seen by a distant sensor and by an irradiancemeter, render_1 at 32x32
    @ 64 spp; the projector throwing a 64x64 bitmap on the cbox's back
    wall (256x256 @ 16 spp). Each with every K1 launch of one call held bit
    for bit and one timed call; the 64x64 (atmo: 32x32) results against
    the JAX package's."""
    out = {}
    _, out["orthographic"] = timed_render(
        K1, K2, K3, f"sensors orthographic cbox {SLICE13_RES}^2 @ {SENSORS_SPP} spp",
        rendered(mi, mi.load_dict(orthographic_dict(mi, SLICE13_RES, SENSORS_SPP)), SENSORS_SPP))
    img64 = mi.render(mi.load_dict(orthographic_dict(mi, SLICE13_RES64, SLICE13_SPP64)), spp=SLICE13_SPP64,
                      seed=0)
    out["orthographic"]["rel_err"] = check_means(f"orthographic {SLICE13_RES64}^2", img64.mean(dim=(0, 1)),
                                                 JAX_ORTHO64_MEANS)
    _, out["projector"] = timed_render(
        K1, K2, K3, f"sensors projector cbox {SLICE13_RES}^2 @ {SENSORS_SPP} spp",
        rendered(mi, mi.load_dict(mi.projector_scene(SLICE13_RES, SENSORS_SPP)), SENSORS_SPP))
    img64 = mi.render(mi.load_dict(mi.projector_scene(SLICE13_RES64, SLICE13_SPP64)), spp=SLICE13_SPP64, seed=0)
    out["projector"]["rel_err"] = check_means(f"projector {SLICE13_RES64}^2", img64.mean(dim=(0, 1)),
                                              JAX_PROJECTOR64_MEANS)

    batch = mi.load_dict(batch_dict(mi, SLICE13_RES // 2, SENSORS_SPP))
    _, out["batch"] = timed_render(
        K1, K2, K3, f"sensors batch of two perspectives, render_test 2 x {SLICE13_RES // 2}^2 @ {SENSORS_SPP} spp",
        lambda seed, st: mi.render_test(batch, spp=SENSORS_SPP, seed=seed, sensor_count=2,
                                        stats=st))
    views64 = mi.render_test(mi.load_dict(batch_dict(mi, SLICE13_RES64, SLICE13_SPP64)), spp=SLICE13_SPP64,
                             seed=0, sensor_count=2)
    out["batch"]["rel_err"] = max(check_means(f"batch view {i} {SLICE13_RES64}^2", views64[i], want)
                                  for i, want in enumerate(JAX_BATCH64_VIEWS))
    mi.set_variant("mono_polarized")
    try:
        for name, want in (("distant", JAX_ATMO_DISTANT_STOKES),
                           ("irradiancemeter", JAX_ATMO_IRRADIANCEMETER_STOKES)):
            scene = mi.load_dict(atmo_sensor_dict(mi, name))
            stokes, out[f"atmo_{name}"] = timed_render(
                K1, K2, K3, f"sensors atmo {name} (mono_polarized) {ATMO_SENSOR_RES}x{ATMO_SENSOR_RES} @ "
                f"{ATMO_SENSOR_SPP} spp, render_1",
                lambda seed, st, scene=scene: mi.render_1(scene, spp=ATMO_SENSOR_SPP, seed=seed,
                                                          stats=st))
            out[f"atmo_{name}"]["stokes"] = stokes[:, 0].tolist()
            out[f"atmo_{name}"]["rel_err"] = check_stokes(f"atmo {name}", stokes, want)
    finally:
        mi.set_variant("rgb")
    return out


@contextlib.contextmanager
def k2_held_to_plain(K2, held):
    """Inside, every K2 call (closest hit and any hit) is held bit for bit
    against the plain walk on the same inputs: `held` gets (any hit?,
    lanes, differing elements as a 0-d tensor) per call."""
    fn = K2.bvh_sweep

    def wrapper(nodes, table, o, d, maxt, anyhit=False, rows=None):
        out = fn(nodes, table, o, d, maxt, anyhit=anyhit, rows=rows)
        ref = K2.bvh_sweep_reference(nodes, table.detach(), o.detach(), d.detach(),
                                     maxt.detach(), anyhit)
        held.append((anyhit, o.shape[0], k1_bits_differ(out, ref)))
        return out

    K2.bvh_sweep = wrapper
    try:
        yield
    finally:
        K2.bvh_sweep = fn


def phase_spheres_mesh(mi, K1, K2, K3):
    """The mesh scene (202,822 triangles on the BVH) with an analytic
    sphere and the envmap at 256x256 @ 16 spp through K2 and the sphere
    pass (its any hit ORed with the sphere pass's): one render with every
    K2 launch held bit for bit against the plain walk, one timed render
    (K2 closest-hit and any-hit launches, no K1); the 64x64 @ 4 spp means
    against the JAX package's."""
    import dataclasses

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scene = mi.load_dict(spheres_mesh_dict(mi, str(Path(tmp) / "s.obj"), SLICE13_RES))
        load_s = time.perf_counter() - t0
    # the same geometry on the check's film (the camera's aspect is 1 on both)
    scene64 = dataclasses.replace(scene, film=dataclasses.replace(
        scene.film, width=SLICE13_RES64, height=SLICE13_RES64))
    if not scene.geometry.has_bvh or scene.geometry.n_spheres != 1:
        raise AssertionError("spheres-mesh: the scene is not on the BVH with one sphere")
    name = f"spheres-mesh {SLICE13_RES}^2 @ {SPHERES_MESH_SPP} spp, path max_depth 8"
    held = []
    with k2_held_to_plain(K2, held):
        mi.render(scene, spp=SPHERES_MESH_SPP, seed=1)
    differing = int(sum(x for _, _, x in held))
    n_any = sum(1 for a, _, _ in held if a)
    log(f"  {name}: K2 held bit for bit against the plain walk on the path's own inputs: "
        f"{len(held) - n_any} closest-hit + {n_any} any-hit launches, "
        f"{sum(n for _, n, _ in held)} lanes, {differing} differing elements")
    if not held or not n_any or differing:
        raise AssertionError(f"{name}: K2 against the plain walk: {len(held)} calls, "
                             f"{differing} differing")
    walls, _, stats, img, peak = timed_calls(K1, K2, K3, name,
                                             rendered(mi, scene, SPHERES_MESH_SPP), 1,
                                             warm_up=False, kernel="K2")
    wall = walls[0]
    launches = dict(closest=K2.bvh_sweep_intersect.launches, anyhit=K2.bvh_sweep_occluded.launches,
                    K1=K1.smem_intersect.launches, K3=K3.mxu_intersect.launches)
    log(f"== main path: {name}: {wall:.4f} s wall (scene write + load {load_s:.2f} s), "
        f"{stats['n_rays']} rays, {stats['n_rays'] / wall / 1e6:.2f} Mrays/s, launches "
        f"{launches}, peak memory {peak / 2**30:.3f} GiB, means {img.mean(dim=(0, 1)).tolist()}")
    if (not launches["closest"] or not launches["anyhit"] or launches["K1"] or launches["K3"]
            or not bool(torch.isfinite(img).all())):
        raise AssertionError(f"{name}: launches {launches} or a non-finite image")
    img64 = mi.render(scene64, spp=4, seed=0)
    rel = check_means(f"spheres-mesh {SLICE13_RES64}^2 @ 4 spp", img64.mean(dim=(0, 1)),
                      JAX_SPHERES_MESH64_MEANS)
    return dict(wall=wall, load_s=load_s, n_rays=stats["n_rays"],
                mrays=stats["n_rays"] / wall / 1e6, launches=launches, peak=peak,
                k2_held_launches=len(held), k2_bitwise_vs_plain=differing == 0,
                means64_rel_err=rel)


PHASE_S = {}


def timed_phase(name, fn, *args):
    """fn(*args), its wall seconds kept in PHASE_S[name] and logged."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = round(time.perf_counter() - t0, 1)
    log(f"## phase {name}: {PHASE_S[name]} s")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one card", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    import mitsuba_tpu_torch as mi
    from mitsuba_tpu_torch import native
    from mitsuba_tpu_torch.ops import bvh_sweep as K2
    from mitsuba_tpu_torch.ops import cuda_build
    from mitsuba_tpu_torch.ops import dma_probe as K4
    from mitsuba_tpu_torch.ops import intersect as K1
    from mitsuba_tpu_torch.ops import intersect_mxu as K3
    from mitsuba_tpu_torch.render_api import make_wavefront

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"== device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")

    build_all(cuda_build, native, K1, K2, K3)
    scene, batch, k1_entry = timed_phase("k1", phase_k1, mi, K1, make_wavefront)
    cbox_launches = timed_phase("cbox_main", phase_cbox_main, mi, K1, K2, K3, scene)
    k3_entry = timed_phase("k3", phase_k3, K1, K3, scene, batch)
    del scene, batch
    torch.cuda.empty_cache()

    l_smem, l_mma, step_k1, step_k3, prb = timed_phase("prb_main", phase_prb_main, mi, K1, K2,
                                                        K3)
    timed_phase("prb64", phase_prb64, mi, K1, K2, K3)
    timed_phase("adam", phase_adam, mi)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        scene, err, closest, bounce1, anyhit = timed_phase("k2", phase_k2, mi, K1, K2, native,
                                                           tmp)
        n_closest, n_any, k2_pass = timed_phase("mesh_main", phase_mesh_main, mi, K1, K2, K3,
                                                scene, tmp)
        del scene
    torch.cuda.empty_cache()
    k4_entry = timed_phase("k4", phase_k4, K4)
    torch.cuda.empty_cache()
    hetvol = timed_phase("hetvol", phase_hetvol, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    vol32 = timed_phase("vol32", phase_vol32, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    atmo = timed_phase("atmo", phase_atmo, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    aos_prb = timed_phase("aos_prb", phase_aos_prb, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    atmo_prb = timed_phase("atmo_prb", phase_atmo_prb, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    hetvol_prb = timed_phase("hetvol_prb", phase_hetvol_prb, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    vol32_regen_prb = timed_phase("vol32_regen_prb", phase_vol32_regen_prb, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    regen_prb = timed_phase("regen_prb", phase_regen_prb, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    api = timed_phase("api", phase_api, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    materials = timed_phase("materials", phase_materials, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    materials_prb = timed_phase("materials_prb", phase_materials_prb, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    polarimeter = timed_phase("polarimeter", phase_polarimeter, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    polarimeter_prb = timed_phase("polarimeter_prb", phase_polarimeter_prb, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    integrators = timed_phase("integrators", phase_integrators, mi, K1, K2, K3,
                              materials["means"])
    torch.cuda.empty_cache()
    spectral = timed_phase("spectral", phase_spectral, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    spectral_prb = timed_phase("spectral_prb", phase_spectral_prb, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    atmo_spectral = timed_phase("atmo_spectral", phase_atmo_spectral, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    spectral_regen = timed_phase("spectral_regen", phase_spectral_regen, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    ptracer = timed_phase("ptracer", phase_ptracer, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    volpathmis = timed_phase("volpathmis", phase_volpathmis, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    projective = timed_phase("projective", phase_projective, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    golds = timed_phase("golds", phase_golds, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    spheres = timed_phase("spheres", phase_spheres, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    spheres_prb = timed_phase("spheres_prb", phase_spheres_prb, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    manylights = timed_phase("manylights", phase_manylights, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    sensors = timed_phase("sensors", phase_sensors, mi, K1, K2, K3)
    torch.cuda.empty_cache()
    spheres_mesh = timed_phase("spheres_mesh", phase_spheres_mesh, mi, K1, K2, K3)

    per_path = f"{PRB_ITERS} iterations"
    k1_entry["launches"] = cbox_launches
    k1_entry["launches_by_path"] = {"cbox path 256x256 @ 64 spp": cbox_launches,
                                    f"cbox prb, K1 route, {per_path}": l_smem["K1"],
                                    f"cbox prb, K3 route, {per_path}": l_mma["K1"],
                                    "mesh path": 0,
                                    "het-vol pass 96x96 @ 16 spp": hetvol["k1_per_pass"][0],
                                    "het-vol regenerate render": hetvol["k1_regen"],
                                    "vol32 wavefront render": vol32["k1_std"],
                                    "vol32 regenerate render": vol32["k1_regen"],
                                    "atmo pass 64x64 @ 64 spp": atmo["k1_per_pass"][0],
                                    "aos-prb step 32x32 @ 64 spp": aos_prb["k1_per_step"],
                                    "atmo-prb step 64x64 @ 64 spp": atmo_prb["k1_per_step"],
                                    "hetvol-prb step 96x96 @ 16 spp": hetvol_prb["k1_per_step"],
                                    "vol32-regen-prb step 128x128 @ 16 spp":
                                        vol32_regen_prb["k1_per_step"],
                                    "regen-prb cbox prb step 64x64 @ 16 spp":
                                        regen_prb["cbox_prb"]["k1"],
                                    "regen-prb slab volpath render 64x64 @ 16 spp":
                                        regen_prb["slab_volpath"]["k1"],
                                    "regen-prb slab prb_polarized step 64x64 @ 16 spp":
                                        regen_prb["slab_prb_polarized"]["k1"],
                                    "regen-prb aos prb_volpathaos step 16x16 @ 4 spp":
                                        regen_prb["aos_prb"]["k1"],
                                    "materials render 256x256 @ 64 spp":
                                        materials["k1_per_render"],
                                    "materials-prb step 256x256 @ 64 spp":
                                        materials_prb["k1_per_step"],
                                    "polarimeter render 256x256 @ 64 spp":
                                        polarimeter["k1_per_render"],
                                    "polarimeter-prb step 64x64 @ 16 spp":
                                        polarimeter_prb["k1_per_step"],
                                    **{f"integrators {k} render 256x256 @ 64 spp": v["k1"]
                                       for k, v in integrators.items() if k != "checks"},
                                    "spectral cbox render 256x256 @ 64 spp":
                                        spectral["k1_per_render"],
                                    "spectral cbox-prb step 256x256 @ 64 spp":
                                        spectral_prb["k1_per_step"],
                                    "atmo-spectral pass 64x64 @ 64 spp":
                                        atmo_spectral["k1_per_pass"][0],
                                    "spectral-regen volpath render":
                                        spectral_regen["volpath"]["k1"],
                                    "spectral-regen prbvolpath step":
                                        spectral_regen["prbvolpath"]["k1"],
                                    "ptracer cbox render 256x256 @ 64 spp":
                                        ptracer["k1_per_render"],
                                    "volpathmis het-vol render 96x96 @ 16 spp":
                                        volpathmis["k1_per_render"],
                                    **{f"projective {k} AD step": v["k1_per_step"]
                                       for k, v in projective.items()},
                                    **{f"golds {k}": v["k1"] for k, v in golds.items()
                                       if isinstance(v, dict) and "k1" in v},
                                    "spheres render 256x256 @ 64 spp": spheres["k1_per_render"],
                                    "spheres-prb step 256x256 @ 64 spp":
                                        spheres_prb["k1_per_step"],
                                    **{f"manylights {k} render 256x256 @ 64 spp":
                                       manylights[k]["k1_per_render"]
                                       for k in ("path", "ptracer")},
                                    **{f"sensors {k}": v["k1_per_render"]
                                       for k, v in sensors.items()},
                                    "spheres-mesh render": spheres_mesh["launches"]["K1"]}
    k1_entry.update(step_k1)
    k1_entry.update(hetvol_pass_launches=hetvol["k1_pass_launches"],
                    hetvol_pass_ms=hetvol["k1_pass_ms"],
                    hetvol_pass_back_to_back_ms=hetvol["k1_pass_back_to_back_ms"],
                    hetvol_pass_bound_ms=hetvol["k1_pass_bound_ms"],
                    hetvol_bitwise_vs_plain=hetvol["k1_bitwise_vs_plain"],
                    vol32_bitwise_vs_plain=vol32["k1_bitwise_vs_plain"],
                    atmo_launches=atmo["k1_per_pass"][0],
                    atmo_pass_ms=atmo["k1_pass_ms"],
                    atmo_pass_back_to_back_ms=atmo["k1_pass_back_to_back_ms"],
                    atmo_pass_bound_ms=atmo["k1_pass_bound_ms"],
                    atmo_bitwise_vs_plain=atmo["k1_bitwise_vs_plain"],
                    **{f"{name}_step_launches": {"forward": r["k1_forward"],
                                                 "backward_primal": r["k1_backward_primal"],
                                                 "replay": r["k1_replay"]}
                       for name, r in (("aos_prb", aos_prb), ("atmo_prb", atmo_prb),
                                       ("hetvol_prb", hetvol_prb))},
                    **{f"{name}_{k}": r[f"k1_{k}"]
                       for name, r in (("aos_prb", aos_prb), ("atmo_prb", atmo_prb),
                                       ("hetvol_prb", hetvol_prb))
                       for k in ("step_ms", "step_back_to_back_ms", "step_bound_ms")},
                    **{f"{name}_bitwise_vs_plain": r["k1_bitwise_vs_plain"]
                       for name, r in (("aos_prb", aos_prb), ("atmo_prb", atmo_prb),
                                       ("hetvol_prb", hetvol_prb),
                                       ("vol32_regen_prb", vol32_regen_prb))},
                    vol32_regen_prb_step_launches=dict(zip(
                        ("forward", "backward_primal", "replay"), vol32_regen_prb["k1"])),
                    vol32_regen_prb_step_ms=vol32_regen_prb["k1_step_ms"],
                    vol32_regen_prb_step_bound_ms=vol32_regen_prb["k1_step_bound_ms"],
                    **{f"{name}_render_{k}": r[f"k1_render_{k}"]
                       for name, r in (("materials", materials), ("polarimeter", polarimeter))
                       for k in ("ms", "back_to_back_ms", "bound_ms")},
                    materials_bitwise_vs_plain=materials["k1_bitwise_vs_plain"],
                    polarimeter_bitwise_vs_plain=polarimeter["k1_bitwise_vs_plain"],
                    **{f"{name}_step_launches": {"forward": r["k1_forward"],
                                                 "backward_primal": r["k1_backward_primal"],
                                                 "replay": r["k1_replay"]}
                       for name, r in (("materials_prb", materials_prb),
                                       ("polarimeter_prb", polarimeter_prb))},
                    **{f"{name}_{k}": r[f"k1_{k}"]
                       for name, r in (("materials_prb", materials_prb),
                                       ("polarimeter_prb", polarimeter_prb))
                       for k in ("step_ms", "step_back_to_back_ms", "step_bound_ms")},
                    spectral_bitwise_vs_plain={
                        "cbox render": spectral["k1_bitwise_vs_plain"],
                        "cbox-prb step": spectral_prb["k1_bitwise_vs_plain"],
                        "atmo-spectral pass": atmo_spectral["k1_bitwise_vs_plain"],
                        "regen volpath render": spectral_regen["volpath"]["k1_bitwise_vs_plain"],
                        "regen prbvolpath step":
                            spectral_regen["prbvolpath"]["k1_bitwise_vs_plain"]},
                    spectral_render_ms=spectral["k1_render_ms"],
                    spectral_render_back_to_back_ms=spectral["k1_render_back_to_back_ms"],
                    spectral_render_bound_ms=spectral["k1_render_bound_ms"],
                    spectral_prb_step_launches={"forward": spectral_prb["k1_forward"],
                                                "backward_primal":
                                                    spectral_prb["k1_backward_primal"],
                                                "replay": spectral_prb["k1_replay"]},
                    **{f"spectral_prb_{k}": spectral_prb[f"k1_{k}"]
                       for k in ("step_ms", "step_back_to_back_ms", "step_bound_ms")},
                    **{f"{name}_render_{k}": r[f"k1_render_{k}"]
                       for name, r in (("ptracer", ptracer), ("volpathmis", volpathmis))
                       for k in ("ms", "back_to_back_ms", "bound_ms")},
                    new_paths_bitwise_vs_plain={
                        "ptracer render": ptracer["k1_bitwise_vs_plain"],
                        "volpathmis render": volpathmis["k1_bitwise_vs_plain"],
                        **{f"projective {k} AD step": v["k1_bitwise_vs_plain"]
                           for k, v in projective.items()},
                        "golds rayleigh render": golds["k1_bitwise_vs_plain"],
                        "spheres render": spheres["k1_bitwise_vs_plain"],
                        "spheres-prb step": spheres_prb["k1_bitwise_vs_plain"],
                        **{f"manylights {k} render": manylights[k]["k1_bitwise_vs_plain"]
                           for k in ("path", "ptracer")},
                        **{f"sensors {k}": v["k1_bitwise_vs_plain"] for k, v in sensors.items()}},
                    **{f"{name}_render_{k}": r[f"k1_render_{k}"]
                       for name, r in (("spheres", spheres),
                                       ("manylights_path", manylights["path"]),
                                       ("manylights_ptracer", manylights["ptracer"]))
                       for k in ("ms", "back_to_back_ms", "bound_ms")},
                    spheres_prb_step_launches={"forward": spheres_prb["k1_forward"],
                                               "backward_primal": spheres_prb["k1_backward_primal"],
                                               "replay": spheres_prb["k1_replay"]},
                    **{f"spheres_prb_{k}": spheres_prb[f"k1_{k}"]
                       for k in ("step_ms", "step_back_to_back_ms", "step_bound_ms")},
                    hit_vjp_held_to_autograd={k: v["hit_vjp_held"] for k, v in projective.items()})
    k3_entry.update(step_k3)
    k3_entry["launches"] = l_mma["K3"]
    k3_entry["launches_by_path"] = {f"cbox prb, K3 route, {per_path}": l_mma["K3"],
                                    f"cbox prb, K1 route, {per_path}": l_smem["K3"]}
    k2 = {"route": "cuda", "source": "mitsuba_tpu_torch/csrc/bvh_sweep.cu",
          "replaces": "mitsuba_tpu/ops/bvh_sweep.py:108", "max_abs_err": err,
          "library_ms": None, "bitwise_vs_plain": err == 0.0,
          "spheres_mesh_bitwise_vs_plain": spheres_mesh["k2_bitwise_vs_plain"]}
    report = {"kernels": [
        k1_entry,
        dict(name="bvh_sweep_closest", launches=n_closest, **closest,
             launches_by_path={"mesh path 256x256 @ 16 spp": n_closest,
                               "spheres-mesh path 256x256 @ 16 spp":
                                   spheres_mesh["launches"]["closest"]},
             batch="mesh bounce-0 camera rays", bounce1_ms=bounce1["ms"],
             bounce1_kernel_ms=bounce1["kernel_ms"], bounce1_bound_ms=bounce1["bound_ms"],
             **k2_pass["closest"], **k2),
        dict(name="bvh_sweep_anyhit", launches=n_any, **anyhit,
             launches_by_path={"mesh path 256x256 @ 16 spp": n_any,
                               "spheres-mesh path 256x256 @ 16 spp":
                                   spheres_mesh["launches"]["anyhit"]},
             batch="mesh bounce-0 shadow rays", **k2_pass["anyhit"], **k2),
        k3_entry,
        k4_entry,
    ], "prb": {k: v for k, v in prb.items()},
        "hetvol": hetvol,
        "vol32": vol32,
        "atmo": atmo,
        "aos_prb": aos_prb,
        "atmo_prb": atmo_prb,
        "hetvol_prb": hetvol_prb,
        "vol32_regen_prb": vol32_regen_prb,
        "regen_prb": regen_prb,
        "api": api,
        "materials": materials,
        "materials_prb": materials_prb,
        "polarimeter": polarimeter,
        "polarimeter_prb": polarimeter_prb,
        "integrators": integrators,
        "spectral": spectral,
        "spectral_prb": spectral_prb,
        "atmo_spectral": atmo_spectral,
        "spectral_regen": spectral_regen,
        "ptracer": ptracer,
        "volpathmis": volpathmis,
        "projective": projective,
        "golds": golds,
        "spheres": spheres,
        "spheres_prb": spheres_prb,
        "manylights": manylights,
        "sensors": sensors,
        "spheres_mesh": spheres_mesh,
        "phase_s": PHASE_S}
    log(f"== chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
