"""Build the package's native code and load it with ctypes.

Each CUDA source under ``mitsuba_tpu_torch/csrc/`` exports plain
``extern "C"`` launchers and includes no PyTorch header (only the
directory's own ``*.cuh``), so one nvcc call builds it in seconds. The
host C++ under ``csrc/host/`` (the mesh loaders and the BVH builder) is
built the same way with the host compiler, so it builds where there is no
nvcc too. Each shared library goes to
``build/mitsuba_tpu_torch/`` at the root of the checkout (listed in
.gitignore), under a name keyed by a hash of the sources, the headers and
the flags: an edited source or header is rebuilt at its first use, an
unchanged one is loaded as it is.

Nothing here runs at import time; the first use of a library builds it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mitsuba_tpu_torch"

# sm_90a: Hopper with its arch-specific instructions (wgmma, setmaxnreg).
# -Xptxas -v reports registers, shared memory and spills into the build log.
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Build:
    path: Path        # the shared library
    seconds: float    # compiler wall time; 0.0 when an earlier build was reused
    log: str          # the compiler's output (nvcc's has the -Xptxas -v report)


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _compile(name, compiler, flags, sources, headers=()) -> Build:
    """Compile `sources` with `compiler` and `flags` into one shared
    library, or reuse the one an earlier call built from the same sources,
    headers and flags."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in (*sources, *headers):
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists() and log_path.exists():
        return Build(out, 0.0, log_path.read_text())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename: concurrent builders (several
    # test workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [compiler, *flags, "-o", tmp, *map(str, sources)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{compiler} failed on {name} (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return Build(out, seconds, log)


def build(name: str, flags: tuple = (), source: Path | None = None) -> Build:
    """Compile csrc/<name>.cu (or `source`, which may include csrc's
    headers) with nvcc into a shared library, or reuse the one an earlier
    call built from the same source, headers and flags."""
    source = CSRC / f"{name}.cu" if source is None else Path(source)
    flags = BASE_FLAGS + ("-I", str(CSRC)) + tuple(flags)
    return _compile(name, _nvcc(), flags, [source], sorted(CSRC.glob("*.cuh")))


@functools.cache
def load(name: str, flags: tuple = ()) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    return ctypes.CDLL(str(build(name, flags).path))


# the flags of the JAX package's native/Makefile, so that the BVH builder
# gives the same nodes bit for bit
HOST_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")


def build_host(name: str, sources: tuple) -> Build:
    """Compile the host C++ files csrc/host/<source> with g++ into one
    shared library, or reuse an earlier build."""
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the mesh loaders and the BVH builder need it")
    return _compile(name, cxx, HOST_FLAGS, [CSRC / "host" / s for s in sources])
