"""Build and load the CUDA kernels of ``csrc/`` (route: ``nvcc`` into a
shared library with a plain C interface, loaded through ``ctypes``).

The build runs at first use, never at import: it compiles
``csrc/grad_sync.cu`` for ``sm_90a`` into :data:`BUILD_DIR`, under a name
keyed by the source's and flags' hash, so an edited source is rebuilt and
an unchanged one is reused.  A failed build raises; nothing falls back to
the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "grad_sync.cu"


def _build_dir() -> Path:
    """``build/`` at the checkout's root when the package runs from a
    source checkout (``<root>/src/repro_torch``), else ``build/`` inside
    the installed package, beside ``csrc/``.  Never a directory shared
    with anything else."""
    pkg = Path(__file__).resolve().parents[1]
    if pkg.parent.name == "src":
        return pkg.parent.parent / "build"
    return pkg / "build"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_convert_copy": [_P, _I, _P, _I, _LL, _I, _P],
    "repro_fused_pack": [_P, _I, _LL, _LL, _P],
    "repro_fused_unpack": [_P, _I, _LL, _LL, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"grad_sync-{digest[:12]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless this source is already built.  Returns
    (library path, seconds spent compiling, compiler output)."""
    so = library_path()
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not os.access(BUILD_DIR, os.W_OK):
        raise RuntimeError(f"kernel build directory {BUILD_DIR} is not "
                           f"writable")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)   # atomic: concurrent ranks may build at once
    return so, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib
