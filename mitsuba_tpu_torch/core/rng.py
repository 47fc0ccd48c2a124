"""Counter-based RNG streams (counterpart of mitsuba_tpu/core/rng.py).

Every draw is threefry2x32(key=(seed, SALT), counter=(lane, dim)), so a
lane's numbers depend only on (seed, lane, dim): they do not change with the
pass partitioning and are bitwise the JAX package's numbers.

PyTorch has no arithmetic on uint32 tensors (add, shifts and compares raise
on the CPU), so the 32-bit words live in int64 tensors and are reduced with
``& 0xFFFFFFFF`` after every add and left shift. The same code runs on the
CPU and the card.

Only the independent sampler is ported: the low-discrepancy and
orthogonal-array modes raise ``NotImplementedError``. ``sample_tea_32`` is
the TEA hash that derives the gradient pass's seed from the primal seed.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROT_0 = (13, 15, 26, 6)
_ROT_1 = (17, 29, 16, 24)
_STREAM_SALT = 0x9E3779B9


def _u32(x, like):
    """Python int or tensor -> int64 tensor holding a uint32 word."""
    if torch.is_tensor(x):
        return x.to(torch.int64) & MASK32
    return torch.tensor(int(x) & MASK32, dtype=torch.int64, device=like.device)


def _rotl(x, d):
    return ((x << d) & MASK32) | (x >> (32 - d))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 block cipher (20 rounds) on uint32 words held in int64.

    Arguments are Python ints or int64 tensors with values in [0, 2^32);
    at least one counter must be a tensor. Returns two int64 tensors."""
    like = c0 if torch.is_tensor(c0) else c1
    k0 = _u32(k0, like)
    k1 = _u32(k1, like)
    x0 = (_u32(c0, like) + k0) & MASK32
    x1 = (_u32(c1, like) + k1) & MASK32
    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    keys = (k0, k1, ks2)
    for block in range(5):
        rots = _ROT_0 if block % 2 == 0 else _ROT_1
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        inj = block + 1
        x0 = (x0 + keys[inj % 3]) & MASK32
        x1 = (x1 + keys[(inj + 1) % 3] + inj) & MASK32
    return x0, x1


def uniform_from_bits(bits):
    """uint32 word -> float32 uniform in [0, 1) with 24-bit precision."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


class RNG:
    """Per-lane random stream with a dimension counter (independent mode).

    ``lane`` is an int64 tensor of uint32 lane keys and ``seed`` a Python
    int. ``dim`` is a Python int on the wavefront, where every lane shares
    its dimension counter, or an int64 tensor [N] of per-lane counters
    under path regeneration (``lanes_rng``), where a restarted lane sits at
    a fresh dimension while the others are deeper in their streams. Both
    forms draw the same numbers for the same (lane, dim)."""

    __slots__ = ("seed", "lane", "dim")

    def __init__(self, seed, lane, dim=0, pixel=None, sidx=None, lds=False, oa=0):
        if lds or oa:
            raise NotImplementedError(
                "low-discrepancy and orthogonal-array RNG modes are not yet ported"
            )
        self.seed = int(seed) & MASK32
        self.lane = lane.to(torch.int64) & MASK32
        self.dim = dim.to(torch.int64) if torch.is_tensor(dim) else int(dim)

    def skip(self, n):
        """The stream n dimensions further on."""
        return RNG(self.seed, self.lane, self.dim + n)

    def next_1d(self):
        b0, _ = threefry2x32(self.seed, _STREAM_SALT, self.lane, self.dim)
        return uniform_from_bits(b0), RNG(self.seed, self.lane, self.dim + 1)

    def next_2d(self):
        b0, b1 = threefry2x32(self.seed, _STREAM_SALT, self.lane, self.dim)
        return (
            uniform_from_bits(b0),
            uniform_from_bits(b1),
            RNG(self.seed, self.lane, self.dim + 2),
        )


def sample_tea_32(v0, v1, rounds=4):
    """TEA hash of two uint32 words (the JAX package's sample_tea_32), on
    Python ints or int64 tensors holding uint32 words. Returns the pair in
    the same kind as its inputs: Python ints when both are ints."""
    tensors = torch.is_tensor(v0) or torch.is_tensor(v1)
    if tensors:
        like = v0 if torch.is_tensor(v0) else v1
        v0, v1 = _u32(v0, like), _u32(v1, like)
    else:
        v0, v1 = int(v0) & MASK32, int(v1) & MASK32
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & MASK32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & MASK32) ^ ((v1 + s) & MASK32)
                    ^ ((v1 >> 5) + 0xC8013EA4) & MASK32)) & MASK32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & MASK32) ^ ((v0 + s) & MASK32)
                    ^ ((v0 >> 5) + 0x7E95761E) & MASK32)) & MASK32
    return v0, v1


def lanes_rng(rng, n):
    """The stream with its shared dimension counter broadcast to one
    counter per lane [n] (the JAX package's integrators/path.py:lanes_rng)."""
    dim = rng.dim if torch.is_tensor(rng.dim) else torch.full(
        (n,), rng.dim, dtype=torch.int64, device=rng.lane.device)
    return RNG(rng.seed, rng.lane, dim.expand(n))


def merge_rng(new, old, m):
    """Per-lane select of two streams of one seed: lanes where m is true
    take `new` (its lane key and dimension), the others keep `old`."""
    new_dim = new.dim if torch.is_tensor(new.dim) else torch.full_like(old.lane, new.dim)
    old_dim = old.dim if torch.is_tensor(old.dim) else torch.full_like(old.lane, old.dim)
    return RNG(old.seed, torch.where(m, new.lane, old.lane), torch.where(m, new_dim, old_dim))
