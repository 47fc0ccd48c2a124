"""Optimizers over scene parameters (counterpart of
mitsuba_tpu/ad/optimizers.py).

As there: ``opt = Adam(lr=...)``, ``opt[key] = value``,
``params.update(opt)``, and the gradients are passed to ``step(grads)``
explicitly, a dict of key -> gradient (for instance ``{key: v.grad}``).
Variables are float32 tensors without autograd history; ``step`` returns
the dict of updated variables.
"""
from __future__ import annotations

import math

import torch


def _as_f32(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32)


class Optimizer:
    def __init__(self, lr):
        self.lr_default = lr
        self.lr = {}
        self.variables = {}
        self.state = {}

    def __setitem__(self, key, value):
        self.variables[key] = _as_f32(value).clone()
        if key not in self.state:
            self._reset(key)

    def __getitem__(self, key):
        return self.variables[key]

    def __contains__(self, key):
        return key in self.variables

    def keys(self):
        return self.variables.keys()

    def items(self):
        return self.variables.items()

    def set_learning_rate(self, lr):
        """A learning rate for every key, or a dict of per-key rates."""
        if isinstance(lr, dict):
            self.lr.update(lr)
        else:
            self.lr_default = lr

    def _lr(self, key):
        return self.lr.get(key, self.lr_default)

    def _reset(self, key):
        pass

    def reset(self, key):
        self._reset(key)


class SGD(Optimizer):
    """Gradient descent with optional momentum."""

    def __init__(self, lr=0.2, momentum=0.0):
        super().__init__(lr)
        self.momentum = momentum

    def _reset(self, key):
        if self.momentum != 0:
            self.state[key] = torch.zeros_like(self.variables[key])

    def step(self, grads):
        for k, g in grads.items():
            if k not in self.variables:
                continue
            g = _as_f32(g).to(self.variables[k].device)
            if self.momentum != 0:
                g = self.momentum * self.state[k] + g
                self.state[k] = g
            self.variables[k] = self.variables[k] - self._lr(k) * g
        return dict(self.variables)


class Adam(Optimizer):
    """Adam; with ``uniform=True`` the second moment is the maximum over the
    parameter's entries (one step size for all of them)."""

    def __init__(self, lr=0.1, beta_1=0.9, beta_2=0.999, epsilon=1e-8, uniform=False):
        super().__init__(lr)
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.uniform = uniform
        self.t = {}

    def _reset(self, key):
        z = torch.zeros_like(self.variables[key])
        self.state[key] = (z, z)
        self.t[key] = 0

    def step(self, grads):
        for k, g in grads.items():
            if k not in self.variables:
                continue
            g = _as_f32(g).to(self.variables[k].device)
            self.t[k] += 1
            t = self.t[k]
            m, v = self.state[k]
            m = self.beta_1 * m + (1 - self.beta_1) * g
            v = self.beta_2 * v + (1 - self.beta_2) * g * g
            self.state[k] = (m, v)
            lr_t = self._lr(k) * math.sqrt(1 - self.beta_2**t) / (1 - self.beta_1**t)
            denom = torch.sqrt(torch.amax(v)) if self.uniform else torch.sqrt(v)
            self.variables[k] = self.variables[k] - lr_t * m / (denom + self.epsilon)
        return dict(self.variables)
