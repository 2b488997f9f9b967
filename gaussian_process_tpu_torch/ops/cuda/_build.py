"""Build the package's CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles ``gaussian_process_tpu_torch/csrc/*.cu`` for ``sm_90a``
(one process per source, in parallel) and links them into a shared library
with a plain C interface, under ``gaussian_process_tpu_torch/_build/``
(listed in ``.gitignore``) or where
``utils.profiling.enable_persistent_compile_cache`` points. The file name
carries a hash of the sources, the headers and the flags, so an edited
source is rebuilt and a stale library is never loaded. Nothing here runs at import
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
DEFAULT_BUILD_DIR = PKG_DIR / "_build"
# where the library is built and looked for (moved by
# utils.profiling.enable_persistent_compile_cache)
BUILD_DIR = DEFAULT_BUILD_DIR
SOURCES = ("chol_panel.cu", "gram.cu", "gram_bwd.cu", "gram_matvec.cu",
           "gram_matvec_full_matern.cu", "gram_matvec_full_d8.cu",
           "gram_matvec_full_d8_matern.cu", "gram_matvec_full_sliced.cu",
           "gram_matvec_full_sliced_matern.cu", "gram_matvec_bwd.cu", "gram_matvec_bwd_rbf.cu",
           "gram_matvec_bwd_matern12.cu", "gram_matvec_bwd_matern32.cu",
           "gram_matvec_bwd_matern52.cu", "gram_matvec_bwd_sliced.cu",
           "gram_matvec_bwd_sliced_rbf.cu", "gram_matvec_bwd_sliced_matern.cu",
           "gram_matvec_bwd_sym.cu", "gram_matvec_bwd_sym_matern.cu",
           "gram_matvec_bwd_sym_sliced.cu", "gram_matvec_sym.cu", "gram_matvec_sym_matern.cu",
           "gram_matvec_sym_sliced.cu")
HEADERS = ("gram_matvec_common.cuh", "gram_matvec_full.cuh", "gram_matvec_sym.cuh",
           "gram_matvec_bwd.cuh", "gram_matvec_bwd_sym.cuh", "gram_matvec_slice.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless a library for their exact content exists.
    One ``nvcc -c`` per source, all started together, then one link.
    Records the compile seconds (in all, and each source's until its
    compiler exits) and the ``-Xptxas -v`` report in ``build_info``."""
    lib_path = BUILD_DIR / f"libgp_kernels_{_digest()}.so"
    if lib_path.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("cached", True)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    # build in a private directory, then rename the library: concurrent
    # processes never load a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{Path(s).stem}.o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC_DIR / s)]
                for s, obj in zip(SOURCES, objs)]
        # each compiler's output goes to a file (a pipe could fill and stall
        # it while another is waited on); its wall seconds are recorded
        outs = [open(f"{obj}.log", "w+") for obj in objs]
        procs = [subprocess.Popen(c, stdout=o, stderr=subprocess.STDOUT, text=True)
                 for c, o in zip(cmds, outs)]
        per_source = {}
        while len(per_source) < len(procs):
            for src, proc in zip(SOURCES, procs):
                if src not in per_source and proc.poll() is not None:
                    per_source[src] = time.perf_counter() - t0
            time.sleep(0.1)
        logs = []
        for o in outs:
            o.seek(0)
            logs.append(o.read())
            o.close()
        for cmd, proc, err in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err[-8000:]}"
                )
        so = os.path.join(tmp, "lib.so")
        link = [nvcc, "-shared", "-o", so, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"link failed:\n{' '.join(link)}\n{proc.stderr[-8000:]}")
        os.replace(so, lib_path)
    seconds = time.perf_counter() - t0
    ptxas = "".join(logs)
    (BUILD_DIR / "ptxas.log").write_text(ptxas)
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    build_info.update(
        seconds=seconds,
        cached=False,
        nvcc=version.stdout.strip().splitlines()[-1] if version.stdout else "",
        ptxas=ptxas,
        source_seconds=per_source,
    )
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gm_matvec_sym.argtypes = [p, p, p, p, p, p, p, i, p, i, p, i, i, i, i, i, i, i, p,
                                      i, p]
        lib.gm_matvec_sym.restype = i
        lib.gm_matvec_full_tc.argtypes = [*[p] * 8, i, p, *[i] * 11, p]
        lib.gm_matvec_full_tc.restype = i
        lib.gm_full_tc_x_width.argtypes = [i, i, i]
        lib.gm_full_tc_x_width.restype = i
        lib.gm_matvec_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, p, *[i] * 14, p]
        lib.gm_matvec_bwd.restype = i
        lib.gm_bwd_full_x_width.argtypes = [i, i, i]
        lib.gm_bwd_full_x_width.restype = i
        lib.gm_bwd_full_resident.argtypes = [i, i, i, i, i, i]
        lib.gm_bwd_full_resident.restype = i
        lib.gm_matvec_bwd_sym.argtypes = [p, p, p, p, p, i, p, i, p, i, i, i, i, i, i, i, p, i,
                                          p]
        lib.gm_matvec_bwd_sym.restype = i
        lib.gm_gram.argtypes = [p, p, p, p, i, p, i, i, i, i, i, i, i, i, p]
        lib.gm_gram.restype = i
        lib.gm_gram_bwd.argtypes = [p, p, p, p, p, p, p, i, p, i, i, i, i, i, i, i, i,
                                    ctypes.POINTER(ctypes.c_longlong), p]
        lib.gm_gram_bwd.restype = i
        lib.gm_chol_inv_panel.argtypes = [p, p, p, i, i, p]
        lib.gm_chol_inv_panel.restype = i
        _lib = lib
    return _lib
