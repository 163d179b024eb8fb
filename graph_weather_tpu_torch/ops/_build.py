"""Build the port's CUDA sources with nvcc at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface, so it compiles in seconds
without PyTorch's headers. The shared library goes to `_build/` inside the
package (listed in .gitignore), under a name that carries a hash of the
source and the flags: an edited source is rebuilt, an unchanged one is
loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to the log
)

_LIBRARIES: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [
        Path(cuda_home) / "bin" / "nvcc" if cuda_home else None,
        shutil.which("nvcc"),
        Path("/usr/local/cuda/bin/nvcc"),
    ]
    for cand in candidates:
        if cand is not None and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from csrc/ at first use"
    )


def build_log_path(name: str) -> Path:
    """nvcc's output (with ptxas's register and spill report) for `name`."""
    return BUILD_DIR / f"{name}.log"


def load_library(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if its hash changed, then load it (cached)."""
    lib = _LIBRARIES.get(name)
    if lib is not None:
        return lib
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    so_path = BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True,
            text=True,
        )
        build_log_path(name).write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stderr}")
        for stale in BUILD_DIR.glob(f"{name}_*.so"):
            stale.unlink()
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    _LIBRARIES[name] = lib
    return lib
