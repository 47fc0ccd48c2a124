"""Device-memory copy probe: kernel K4 and its plain version (counterpart of
the TPU kernel in scripts/bench_dma.py).

The probe streams windows of `rows` x 128 float32 from a large array into
shared memory, copy i taking the window that starts at row
(i * 7919) mod (T - rows), and adds each window's first element to a sink
once the copy has landed. Its rate is the yardstick of the bytes side of
every kernel's bound: the published 3.35 TB/s beside what the card
reaches.

``copy_probe`` launches the hand-written CUDA kernel ``csrc/dma_probe.cu``
for a tensor on the card and returns the sink; on the CPU it runs
``copy_probe_reference``, a gather of the same offsets. A tensor on the
card never falls back to the plain version.

The probe's data are whole numbers under 2^10 (``probe_array``), so the sink
is an exact integer and the kernel's sum is held exactly against the plain
version's.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

ROW_FLOATS = 128
# the JAX probe's array: 2^18 rows of 128 float32, 128 MiB
PROBE_ROWS = 1 << 18
OFFSET_STRIDE = 7919
# shared memory a block may use on an H100 (232,448 B)
MAX_SMEM = 232448
# the sweep: copy sizes of 4-64 KB and 2-4 window buffers per block, every
# pair whose ring fits in a block's shared memory; each moves at least 1 GiB
COPY_KB = (4, 16, 32, 64)
RINGS = (2, 3, 4)
MIN_BYTES = 1 << 30
# grid cap: far more blocks than an H100 holds at once (132 SMs x 8)
MAX_BLOCKS = 4096


def configs():
    """(rows, ring, n_copies) of every configuration of the sweep."""
    out = []
    for kb in COPY_KB:
        rows = kb * 1024 // (ROW_FLOATS * 4)
        for ring in RINGS:
            if ring * kb * 1024 <= MAX_SMEM:
                out.append((rows, ring, -(-MIN_BYTES // (kb * 1024))))
    return out


def probe_array(device, seed=0, total_rows=PROBE_ROWS):
    """[total_rows, 128] float32 of whole numbers in [0, 2^10), from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 1 << 10, (total_rows, ROW_FLOATS), generator=gen,
                         device=device).to(torch.float32)


def window_offsets(total_rows, rows, n_copies, device):
    """First row of each copy's window: (i * 7919) mod (total_rows - rows)."""
    i = torch.arange(n_copies, dtype=torch.int64, device=device)
    return (i * OFFSET_STRIDE) % (total_rows - rows)


def copy_probe_reference(x, rows, n_copies):
    """Plain version: the sum of the first element of every window, a
    0-dim int64 tensor."""
    off = window_offsets(x.shape[0], rows, n_copies, x.device)
    return x[off, 0].to(torch.int64).sum()


def _check(x, rows, ring, n_copies):
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != ROW_FLOATS:
        raise ValueError(f"copy_probe: x must be float32 [T, {ROW_FLOATS}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("copy_probe: x must be contiguous")
    if not 0 < rows < x.shape[0]:
        raise ValueError(f"copy_probe: rows must be in (0, {x.shape[0]}), got {rows}")
    if ring not in RINGS:
        raise ValueError(f"copy_probe: ring must be one of {RINGS}, got {ring}")
    if ring * rows * ROW_FLOATS * 4 > MAX_SMEM:
        raise ValueError(f"copy_probe: a ring of {ring} x {rows} rows does not fit in "
                         f"{MAX_SMEM} B of shared memory")
    if n_copies < 1:
        raise ValueError("copy_probe: n_copies must be positive")


@functools.cache
def _launcher():
    fn = cuda_build.load("dma_probe").copy_probe_launch
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, cll, ci, ci, cll, vp, ci, vp, vp]
    fn.restype = ci
    return fn


def copy_probe(x, rows, ring, n_copies):
    """The sink (a 0-dim int64 tensor) of n_copies window copies of `rows`
    rows from x, `ring` windows in flight per block. On the card this
    launches K4 (without synchronising) and counts the launch in
    ``copy_probe.launches``; on the CPU it runs the plain version."""
    _check(x, rows, ring, n_copies)
    if x.device.type == "cpu":
        return copy_probe_reference(x, rows, n_copies)
    if x.device.type != "cuda":
        raise ValueError(f"copy_probe: no kernel for device {x.device}")
    sink = torch.zeros(MAX_BLOCKS, dtype=torch.int64, device=x.device)
    blocks = ctypes.c_int(0)
    launch = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(x.data_ptr(), x.shape[0], rows, ring, n_copies, sink.data_ptr(),
                    MAX_BLOCKS, ctypes.addressof(blocks), stream)
    copy_probe.launches += 1
    if rc != 0:
        raise RuntimeError(f"copy_probe: kernel launch failed with CUDA error {rc}")
    return sink.sum()


copy_probe.launches = 0


def measure(x, rows, ring, n_copies, reps=5):
    """(best GB/s over `reps` launches, timed with CUDA events, and the
    sink, checked exactly against the plain version). GB/s counts the
    window bytes moved: n_copies * rows * 512."""
    want = int(copy_probe_reference(x, rows, n_copies))
    got = int(copy_probe(x, rows, ring, n_copies))
    if got != want:
        raise AssertionError(f"copy_probe rows={rows} ring={ring}: sink {got} != plain {want}")
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        copy_probe(x, rows, ring, n_copies)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return n_copies * rows * ROW_FLOATS * 4 / (best * 1e-3) / 1e9, got
