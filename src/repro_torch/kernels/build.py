"""Build and load the CUDA kernels of ``csrc/`` (route: ``nvcc`` into a
shared library with a plain C interface, loaded through ``ctypes``).

The build runs at first use, never at import: it compiles every
``csrc/*.cu`` for ``sm_90a`` (one ``nvcc`` per source, all started
together) and links the objects into one shared library in
:data:`BUILD_DIR`, under a name keyed by the hash of every source and the
flags, so an edited source is rebuilt and an unchanged tree is reused.  A
failed build raises; nothing falls back to the plain versions.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_convert_copy": [_P, _I, _P, _I, _LL, _I, _P],
    "repro_bucket_pack": [_P, _I, _LL, _LL, _P],
    "repro_fused_pack": [_P, _I, _LL, _LL, _P],
    "repro_fused_unpack": [_P, _I, _LL, _LL, _P],
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P],
    "repro_flash_attention_tc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _P],
    "repro_flash_attention_bwd": [_P] * 11 + [_I] * 10 + [_P],
    "repro_flash_attention_tc_smem": [_I],
    "repro_rglru_scan": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _LL,
                         _P],
    "repro_rglru_scan_scratch": [_I, _I, _I],
    "repro_rwkv6_wkv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P, _LL, _P],
    "repro_rwkv6_wkv_scratch": [_I, _I, _I, _I],
}
# entry points that return a size in bytes; every other returns an int
_LL_RESULT = ("repro_rglru_scan_scratch", "repro_rwkv6_wkv_scratch")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"kernels-{h.hexdigest()[:12]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless these sources are already built.
    Returns (library path, seconds spent compiling, compiler output); the
    output is kept beside the library, so a build found ready still
    returns it (with 0 seconds)."""
    so = library_path()
    if so.exists():
        log = so.with_suffix(".log")
        return so, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not os.access(BUILD_DIR, os.W_OK):
        raise RuntimeError(f"kernel build directory {BUILD_DIR} is not "
                           f"writable")
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for obj, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{out}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *(str(o) for o, _ in jobs)],
                              capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{log[-1]}")
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp_log = so.with_suffix(f".{os.getpid()}.log")
    tmp_log.write_text("".join(log))
    os.replace(tmp_log, so.with_suffix(".log"))
    os.replace(tmp, so)   # atomic: concurrent ranks may build at once
    return so, time.perf_counter() - t0, "".join(log)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _LL if name in _LL_RESULT else ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib
