"""Differentiable-rendering layer (counterpart of mitsuba_tpu/ad): the PRB
integrator, its render pass as an autograd node, the optimizers, the
Laplacian-preconditioned mesh parameterization (LargeSteps) and the
projective boundary gradients of moving meshes."""
from .largesteps import LargeSteps
from .optimizers import Adam, Optimizer, SGD
from .prb import PRBIntegrator
from .render_ad import derive_seed_grad, prb_pass, prb_pass_lanes
from .projective import ProjectiveIntegrator, projective_render
