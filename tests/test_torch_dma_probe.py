"""Kernel K4 (the device-memory copy probe) in the port: its plain version
and configurations on the CPU.

The JAX package's probe, scripts/bench_dma.py, cannot run here: its kernel
copies between TPU-only memory spaces (pltpu.HBM, VMEM and SMEM, with DMA
semaphores), which neither the CPU backend nor interpret mode provides. So
the port's plain version is held against a numpy evaluation of the same
contract: copy i takes the window starting at row (i * 7919) mod (T - rows),
and the sink adds each window's first element. The CUDA kernel's sink is
held exactly against the plain version on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from mitsuba_tpu_torch.ops import dma_probe as K4


def _numpy_sink(x, rows, n_copies):
    off = (np.arange(n_copies, dtype=np.int64) * 7919) % (x.shape[0] - rows)
    return int(x[off, 0].astype(np.int64).sum())


@pytest.mark.parametrize("rows,n_copies", [(8, 1000), (64, 300000), (128, 5)])
def test_plain_probe_matches_numpy(rows, n_copies):
    x = K4.probe_array("cpu", seed=1, total_rows=1 << 12)
    assert x.dtype == torch.float32 and x.shape == (1 << 12, 128)
    sink = K4.copy_probe(x, rows, 2, n_copies)
    assert sink.dtype == torch.int64 and int(sink) == _numpy_sink(x.numpy(), rows, n_copies)
    # i * 7919 passes 2^31 beyond i = 271,183: the offsets are int64
    off = K4.window_offsets(x.shape[0], rows, n_copies, "cpu")
    assert off.dtype == torch.int64 and int(off.min()) >= 0 and int(off.max()) < x.shape[0] - rows


def test_probe_array_is_whole_numbers_from_a_seed():
    a = K4.probe_array("cpu", seed=3, total_rows=256)
    assert torch.equal(a, K4.probe_array("cpu", seed=3, total_rows=256))
    assert not torch.equal(a, K4.probe_array("cpu", seed=4, total_rows=256))
    assert torch.equal(a, a.round()) and 0 <= float(a.min()) and float(a.max()) < 1024


def test_configs_fit_and_move_a_gib():
    cfgs = K4.configs()
    kbs = {rows * 512 // 1024 for rows, _, _ in cfgs}
    assert kbs == set(K4.COPY_KB) and {ring for _, ring, _ in cfgs} == set(K4.RINGS)
    for rows, ring, n_copies in cfgs:
        assert ring * rows * 512 <= K4.MAX_SMEM
        assert n_copies * rows * 512 >= 1 << 30
    assert (128, 4) not in {(r, g) for r, g, _ in cfgs}        # 256 KB: does not fit


def test_probe_refusals():
    x = K4.probe_array("cpu", total_rows=64)
    with pytest.raises(ValueError):
        K4.copy_probe(x, 8, 5, 10)                          # ring
    with pytest.raises(ValueError):
        K4.copy_probe(K4.probe_array("cpu", total_rows=1024), 512, 2, 10)   # 512 KB ring
    with pytest.raises(ValueError):
        K4.copy_probe(x[:, :64].contiguous(), 8, 2, 10)     # not [T, 128]
    with pytest.raises(ValueError):
        K4.copy_probe(x, 64, 2, 10)                         # no room for a window
    with pytest.raises(ValueError):
        K4.copy_probe(x.to("meta"), 8, 2, 10)               # no kernel for the device
