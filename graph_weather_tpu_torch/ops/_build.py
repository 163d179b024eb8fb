"""Build the port's CUDA sources with nvcc at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface, so it compiles in seconds
without PyTorch's headers. The shared library goes to `_build/` inside the
package (listed in .gitignore), under a name that carries a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags: an edited source
or header is rebuilt, an unchanged one is loaded as it is. `load_libraries`
starts one nvcc per source, all at once (`load_libraries(all_sources())`
builds every kernel of the port). Nothing here runs at import time.
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


def _so_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # what a source may include
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def all_sources() -> list[str]:
    """The name of every csrc/<name>.cu of the port."""
    return sorted(src.stem for src in CSRC_DIR.glob("*.cu"))


def load_libraries(names) -> dict[str, ctypes.CDLL]:
    """Build every `csrc/<name>.cu` whose hash changed, one nvcc process per
    source, all started together; then load them all (cached)."""
    builds = {}
    for name in names:
        if name in _LIBRARIES or name in builds:
            continue
        so_path = _so_path(name)
        if so_path.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
        src = CSRC_DIR / f"{name}.cu"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        builds[name] = (proc, tmp, so_path, src)
    failed = []
    for name, (proc, tmp, so_path, src) in builds.items():
        log, _ = proc.communicate()
        build_log_path(name).write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src}:\n{log}")
            continue
        for stale in BUILD_DIR.glob(f"{name}_*.so"):
            stale.unlink()
        os.replace(tmp, so_path)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _LIBRARIES:
            _LIBRARIES[name] = ctypes.CDLL(str(_so_path(name)))
    return {name: _LIBRARIES[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if its hash changed, then load it (cached:
    after the first call this is a dict lookup, on every kernel launch)."""
    lib = _LIBRARIES.get(name)
    return lib if lib is not None else load_libraries([name])[name]


def c_function(library: str, name: str, argtypes):
    """The C entry `name` of csrc/<library>.cu, built at first use, with its
    argument types set (each returns a cudaError_t as an int)."""
    fn = getattr(load_library(library), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
