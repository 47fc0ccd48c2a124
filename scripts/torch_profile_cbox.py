"""Where the time goes in one Cornell-box render of mitsuba_tpu_torch on a
CUDA card: torch.profiler over one 256x256 @ 64 spp pass (after a warm-up
render), summed by kernel name.

    python3 scripts/torch_profile_cbox.py

Prints the wall time, the device time summed over all kernels, the device
busy share (kernel time over wall time; kernels of one stream do not
overlap), the number of kernel launches, K1's (tri_intersect) share, and
the 15 kernels that take the most device time.
"""
from __future__ import annotations

import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SPP = 64        # the main path's samples per pixel, in one pass
TOP = 15


def _device_us(ev):
    return getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_profile_cbox: needs a CUDA card")
    import mitsuba_tpu_torch as mi

    scene = mi.load_dict(mi.cornell_box())
    mi.render(scene, spp=SPP, seed=1)          # warm-up: build, load, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        img = mi.render(scene, spp=SPP, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert bool(torch.isfinite(img).all())

    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(_device_us(e) for e in rows)
    launches = sum(e.count for e in rows)
    k1 = [e for e in rows if "tri_intersect" in e.key]
    k1_us = sum(_device_us(e) for e in k1)
    print(f"{torch.cuda.get_device_name(0)}: cbox 256x256 @ {SPP} spp, one pass, "
          f"profiled wall {wall * 1e3:.1f} ms")
    print(f"device kernel time {total_us / 1e3:.1f} ms over {launches} launches "
          f"(busy share {total_us / 1e3 / (wall * 1e3):.1%}, "
          f"mean {total_us / max(launches, 1):.1f} us per launch)")
    print(f"K1 tri_intersect: {sum(e.count for e in k1)} launches, {k1_us / 1e3:.2f} ms "
          f"({k1_us / max(total_us, 1):.1%} of device time)")
    print(f"{'kernel':<70} {'count':>6} {'ms':>9} {'share':>7}")
    for e in sorted(rows, key=_device_us, reverse=True)[:TOP]:
        print(f"{e.key[:70]:<70} {e.count:>6} {_device_us(e) / 1e3:>9.2f} "
              f"{_device_us(e) / max(total_us, 1):>7.1%}")


if __name__ == "__main__":
    main()
