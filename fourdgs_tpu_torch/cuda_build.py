"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` exposes a plain C entry point and is compiled by
`nvcc` into its own shared library, `build/kernels/<name>-<hash>.so` at
the root of the checkout, keyed by a hash of the source, the shared
headers `csrc/*.cuh` and the flags, and
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
from concurrent.futures import ThreadPoolExecutor
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

# Flags of one kernel alone. The blend kernels are built without
# multiply-add contraction, so that every product and sum rounds as the
# plain versions' separate operations do: K1 then matches its plain version
# bit for bit. Their threshold tests do not depend on it (alpha_terms.cuh
# rounds those explicitly). PERF.md gives what contraction would save
# (measured once, a few percent of each kernel).
KERNEL_FLAGS = {"blend_forward": ("-fmad=false",),
                "blend_backward": ("-fmad=false",)}


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


def build(name: str) -> BuildResult:
    """Compile `csrc/<name>.cu` with NVCC_FLAGS and its KERNEL_FLAGS unless
    that library is already built."""
    flags = NVCC_FLAGS + KERNEL_FLAGS.get(name, ())
    # The key covers the shared headers of csrc/ too.
    src = b"".join(p.read_bytes() for p in [CSRC_DIR / f"{name}.cu",
                                            *sorted(CSRC_DIR.glob("*.cuh"))])
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
    """Build every kernel of `csrc/`: one nvcc each, all started
    together."""
    names = [p.stem for p in sorted(CSRC_DIR.glob("*.cu"))]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    return ctypes.CDLL(str(build(name).path))
