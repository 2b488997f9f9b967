"""Build the package's CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles ``gaussian_process_tpu_torch/csrc/*.cu`` for ``sm_90a``
into a shared library with a plain C interface, under
``gaussian_process_tpu_torch/_build/`` (listed in ``.gitignore``). The file
name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import
time; :func:`load` is called by the kernel wrappers on their first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("gram_matvec.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless a library for their exact content exists.
    Records the compile seconds and ``-Xptxas -v`` report in ``build_info``."""
    lib_path = BUILD_DIR / f"libgp_kernels_{_digest()}.so"
    if lib_path.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("cached", True)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    # build to a private name, then rename: concurrent processes never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC_DIR / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr[-8000:]}"
        )
    os.replace(tmp, lib_path)
    (BUILD_DIR / "ptxas.log").write_text(proc.stderr)
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    build_info.update(
        seconds=seconds,
        cached=False,
        nvcc=version.stdout.strip().splitlines()[-1] if version.stdout else "",
        ptxas=proc.stderr,
    )
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gm_matvec_full.argtypes = [p, p, p, p, p, i, p, i, i, i, i, i, i, p]
        lib.gm_matvec_full.restype = i
        lib.gm_matvec_sym.argtypes = [p, p, p, p, i, p, i, i, i, i, i, p]
        lib.gm_matvec_sym.restype = i
        lib.gm_smem_bytes.argtypes = [i, i, i]
        lib.gm_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib
