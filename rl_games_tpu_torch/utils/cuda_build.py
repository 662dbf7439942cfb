"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` holds kernels behind a plain C interface. It is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root, named after a hash of the source
and its flags, so an edited source is rebuilt and an unchanged one is
reused. Libraries build on first use; ``build_all`` compiles several
sources at once, one ``nvcc`` process each.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)
# Flags of single sources. gae.cu is built without fused multiply-adds so
# that each product and sum rounds as in ``gae_plain``; fused_mlp.cu is a
# chain of matrix products and keeps the FMAs.
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {
    "gae": ("-fmad=false",),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): "
            "the port's CUDA kernels are built from source at first use"
        )
    return path


def nvcc_flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def source_names() -> Tuple[str, ...]:
    return tuple(sorted(p.stem for p in CSRC_DIR.glob("*.cu")))


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Optional[str]]:
    """Compile every ``csrc/<name>.cu`` of ``names`` (all sources when None)
    whose current library is missing, all ``nvcc`` runs started together.

    Returns, per name, nvcc's output if it compiled and None if the library
    was current; raises RuntimeError if a compile fails.
    """
    names = source_names() if names is None else tuple(names)
    logs: Dict[str, Optional[str]] = {}
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = None
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial library
        logs[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def build(name: str) -> Optional[str]:
    """Compile ``csrc/<name>.cu`` unless its current library exists."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
