"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` exposes a plain C entry point and is compiled by
`nvcc` into its own shared library, `build/kernels/<name>-<hash>.so` at
the root of the checkout, keyed by a hash of the source and the flags, and
loaded with `ctypes`. Nothing is built at import time: the first CUDA call
of a kernel's wrapper builds it, or a caller builds all of them up front
with `build_all`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# sm_90a keeps Hopper's wgmma/setmaxnreg available to later kernels. No
# --use_fast_math, so expf is the accurate one that PyTorch's exp also uses.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# Flags of one kernel alone. blend_forward is built without multiply-add
# contraction: its alpha and transmittance tests are thresholds, and a
# fused multiply-add that rounds once where the plain version rounds twice
# moves an instance across one now and then, which changes that pixel by
# far more than the tolerance. PERF.md gives what this costs the kernel.
KERNEL_FLAGS = {"blend_forward": ("-fmad=false",)}


class BuildResult(NamedTuple):
    name: str
    path: Path
    flags: tuple[str, ...]
    seconds: float      # compile time; 0.0 when the library was cached
    log: str            # nvcc/ptxas output (registers, shared memory)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(name: str, flags: tuple[str, ...] | None = None) -> BuildResult:
    """Compile `csrc/<name>.cu` with `flags` (default: NVCC_FLAGS and its
    KERNEL_FLAGS) unless that library is already built."""
    if flags is None:
        flags = NVCC_FLAGS + KERNEL_FLAGS.get(name, ())
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    path = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if path.exists():
        return BuildResult(name, path, flags, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, path)
    return BuildResult(name, path, flags, seconds, proc.stdout + proc.stderr)


def build_all() -> list[BuildResult]:
    """Build every kernel of `csrc/`."""
    return [build(p.stem) for p in sorted(CSRC_DIR.glob("*.cu"))]


def load(name: str, flags: tuple[str, ...] | None = None) -> ctypes.CDLL:
    """The kernel library `name` built with `flags`, built on first use."""
    return ctypes.CDLL(str(build(name, flags).path))
