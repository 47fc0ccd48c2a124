"""Laplacian-preconditioned mesh optimization ("Large Steps in Inverse
Rendering of Geometry", Nicolet et al. 2021; counterpart of
mitsuba_tpu/ad/largesteps.py).

The reference factorizes (I + lambda L) by Cholesky; here, as in the JAX
package, the solve is matrix-free preconditioned conjugate gradients over
a Laplacian matvec of index gathers and index_add scatters. PyTorch has no
CG, so the loop is written out: the JAX package's jax.scipy.sparse.linalg.cg
step for step (x0 = 0, a Jacobi preconditioner, stop once |r|^2 <= tol^2
|b|^2 or after maxiter steps). ``from_differential`` is differentiable the
way JAX differentiates its cg: the backward solves the same (symmetric
positive definite) system for the cotangent, it does not run through the
iterations.
"""
from __future__ import annotations

import numpy as np
import torch


class LargeSteps:
    """ls = LargeSteps(verts, faces, lambda_); u = ls.to_differential(v);
    v = ls.from_differential(u). Optimize u with a uniform Adam. The tables
    live on `device`: verts' device when verts is a tensor, else the card
    unless the caller names another."""

    def __init__(self, verts, faces, lambda_=19.0, device=None):
        if device is None:
            if torch.is_tensor(verts):
                device = verts.device
            else:
                from ..render.scene_loader import resolve_device

                device = resolve_device(None)
        faces = faces.detach().cpu().numpy() if torch.is_tensor(faces) else faces
        faces = np.asarray(faces, np.int64)
        n = int(verts.shape[0])
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
        e = np.unique(np.sort(e, axis=1), axis=0)
        deg = np.zeros(n, np.float32)
        np.add.at(deg, e[:, 0], 1.0)
        np.add.at(deg, e[:, 1], 1.0)
        self.n = n
        self.lambda_ = float(lambda_)
        self.device = torch.device(device)
        self.edges_a = torch.from_numpy(e[:, 0].copy()).to(self.device)
        self.edges_b = torch.from_numpy(e[:, 1].copy()).to(self.device)
        self.degree = torch.from_numpy(deg).to(self.device)

    def _matvec(self, v):
        """(I + lambda L) v with the combinatorial Laplacian L = D - A."""
        neigh = torch.zeros_like(v).index_add(0, self.edges_a, v[self.edges_b])
        neigh = neigh.index_add(0, self.edges_b, v[self.edges_a])
        return v + self.lambda_ * (self.degree[:, None] * v - neigh)

    def _precond(self, x):
        return x / (1.0 + self.lambda_ * self.degree)[:, None]

    def _solve(self, b, tol, maxiter):
        """x with (I + lambda L) x = b, by preconditioned CG from x = 0."""
        x = torch.zeros_like(b)
        r = b - self._matvec(x)
        z = self._precond(r)
        p, gamma = z, torch.sum(r * z)
        atol2 = tol * tol * torch.sum(b * b)
        for _ in range(maxiter):
            if not bool(torch.sum(r * r) > atol2):
                break
            Ap = self._matvec(p)
            alpha = gamma / torch.sum(p * Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = self._precond(r)
            gamma_new = torch.sum(r * z)
            p = z + (gamma_new / gamma) * p
            gamma = gamma_new
        return x

    def to_differential(self, v):
        """v -> u = (I + lambda L) v."""
        return self._matvec(torch.as_tensor(v, dtype=torch.float32, device=self.device))

    def from_differential(self, u, tol=1e-6, maxiter=500):
        """u -> v solving (I + lambda L) v = u by CG; differentiable in u."""
        u = torch.as_tensor(u, dtype=torch.float32, device=self.device)
        return _Solve.apply(u, self, tol, maxiter)


class _Solve(torch.autograd.Function):
    """The CG solve with the adjoint of a symmetric system: the backward
    solves the same system for the cotangent."""

    @staticmethod
    def forward(ctx, u, ls, tol, maxiter):
        ctx.ls, ctx.tol, ctx.maxiter = ls, tol, maxiter
        return ls._solve(u.detach(), tol, maxiter)

    @staticmethod
    def backward(ctx, g):
        return ctx.ls._solve(g.detach(), ctx.tol, ctx.maxiter), None, None, None
