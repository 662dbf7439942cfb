"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` holds kernels behind a plain C interface. It is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root, named after a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
reused. Libraries build on first use.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): "
            "the port's CUDA kernels are built from source at first use"
        )
    return path


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Optional[str]:
    """Compile ``csrc/<name>.cu`` unless its current library exists.

    Returns nvcc's output if it compiled, None if the library was current;
    raises RuntimeError if the compile fails.
    """
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed: {name}: nvcc exited {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
