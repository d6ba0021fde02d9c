"""Build and load the port's CUDA kernels (`src/repro_torch/csrc/*.cu`).

Each source is compiled by its own `nvcc` process, all started together,
for `sm_90a`, then linked into one shared library with a plain C
interface that `ctypes` loads. Nothing here includes PyTorch's headers,
so a build takes seconds. The library lands in `build/repro_torch/<hash>/`
at the root of the checkout (listed in `.gitignore`); the hash covers the
sources and the flags, so an edited source is rebuilt on its next use.

Nothing is built when the package is imported: the first kernel launch
calls `library()`. A missing `nvcc` or a failed build raises; there is
no fallback to the plain versions.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("radix_hist.cu", "tree_dist.cu", "spmv.cu",
           "bitmap_intersect.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "radix_hist_tile_elems": (),
    "radix_hist_launch": (_P, _I, _P, _P, _P, _P),
    "tree_dist_launch": (_P, _P, _I, _I, _P, _P, _I, _P, _P),
    "spmv_csr_launch": (_P, _P, _P, _P, _I, _I, _P, _P),
    "arc_sum_launch": (_P, _P, _I, _P, _I, _I, _I, _P, _P),
    "bitmap_intersect_launch": (_P, _P, _LL, _I, _I, _P, _P),
}

_lib = None


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if their hash has no library yet; return its
    path. The compiler's register/shared-memory report (`-Xptxas -v`) is
    kept beside the library as `build.log`."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        t0 = time.perf_counter()
        objs = [tmp / (Path(name).stem + ".o") for name in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / name),
                                   "-o", str(obj)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for name, obj in zip(SOURCES, objs)]
        logs = []
        for name, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                for p in procs:
                    p.kill()
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2],
                               *map(str, objs), "-o", str(tmp / LIB_NAME)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        logs.append(f"== built in {time.perf_counter() - t0:.2f} s\n")
        (tmp / "build.log").write_text("\n".join(logs))
        os.replace(tmp / "build.log", out_dir / "build.log")
        os.replace(tmp / LIB_NAME, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build_log() -> str:
    """The compiler report of the current sources' build ('' if unbuilt)."""
    log = BUILD_ROOT / _digest() / "build.log"
    return log.read_text() if log.exists() else ""
