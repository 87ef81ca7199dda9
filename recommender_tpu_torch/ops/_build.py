"""Build the port's CUDA kernels from this checkout's sources, at first use.

Each kernel is one ``ops/csrc/<name>.cu`` file with a plain C interface,
which may include the headers beside it (``csrc/*.cuh``). ``nvcc`` compiles
it for Hopper (``sm_90a``) into a shared library under
``build/recommender_tpu_torch/`` at the repository root, named by a hash of
the source, every header and the flags, and ``ctypes`` loads it. An edit
of the source or of a header therefore builds a new library; an unchanged
one is reused. Nothing is built on
import: the CPU tests import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "recommender_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libraries: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, the toolkit's default location, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    ``defines`` (``"-DNAME=value"``) build a variant of it under a name of
    its own; ``load`` takes only the source as it is."""
    so = library_path(name, defines)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {name}.cu:\n{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed and loaded once."""
    lib = _libraries.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _libraries[name] = lib
    return lib
