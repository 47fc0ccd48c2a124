"""Device-memory copy rate of the card: kernel K4 (mitsuba_tpu_torch/ops/
dma_probe.py, csrc/dma_probe.cu) swept over copy sizes of 4-64 KB and 2-4
windows in flight per block, each configuration moving at least 1 GiB of
windows from a 128 MiB array into shared memory. The counterpart of
scripts/bench_dma.py for a CUDA card.

    python3 scripts/torch_bench_dma.py

Prints the card's name and power limit, then GB/s per configuration (best
of 5 launches, CUDA events), each sink held exactly against its plain
version, and the best rate beside the published 3.35 TB/s of an H100 SXM.
"""
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mitsuba_tpu_torch.ops import dma_probe  # noqa: E402

PUBLISHED_GBPS = 3350.0


def sweep(x, reps=5, log=print):
    """[(rows, ring, KB per copy, GB/s)] of every configuration."""
    rows_out = []
    for rows, ring, n_copies in dma_probe.configs():
        gbps, sink = dma_probe.measure(x, rows, ring, n_copies, reps)
        kb = rows * dma_probe.ROW_FLOATS * 4 / 1024
        log(f"rows={rows:4d} ({kb:5.1f} KB/copy) ring={ring}: {n_copies} copies, "
            f"{gbps:9.1f} GB/s, sink {sink} exact")
        rows_out.append((rows, ring, kb, gbps))
    return rows_out


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_bench_dma: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}")
    x = dma_probe.probe_array("cuda")
    results = sweep(x)
    best = max(results, key=lambda r: r[3])
    print(f"best: {best[3]:.1f} GB/s (rows={best[0]}, ring={best[1]}), "
          f"{best[3] / PUBLISHED_GBPS:.1%} of the published {PUBLISHED_GBPS:.0f} GB/s")


if __name__ == "__main__":
    main()
