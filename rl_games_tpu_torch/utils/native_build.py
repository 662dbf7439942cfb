"""Build the repository's native C++ sources with the host compiler and
load them with ctypes.

The host-compiler sibling of ``cuda_build.py``: ``native/<name>/<name>.cc``
(the env stepper ``native/cpuenv/cpuenv.cc``) is compiled by ``g++`` with
the flags of its Makefile into a shared library under ``build/native/`` at
the repository root, named after a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is reused. Nothing is
written under ``native/``. A library is built at first use; the compiler
writes a file of its own and the finished library is renamed into place,
so processes that build at the same time never load a partial one.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# native/cpuenv/Makefile's flags (its -Wall only adds warnings)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_loaded: Dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError(
            "g++ not found on PATH: the native env stepper (native/cpuenv/cpuenv.cc) "
            "is built from source at first use and needs a C++17 compiler"
        )
    return path


def source_path(name: str) -> Path:
    return NATIVE_DIR / name / f"{name}.cc"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source_path(name).read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Optional[str]:
    """Compile ``native/<name>/<name>.cc`` unless its current library
    exists. Returns the compiler's output, or None if the library was
    current; raises RuntimeError if the compile fails."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(source_path(name))],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {source_path(name)} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>/<name>.cc``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
