"""Build the CUDA kernels of `csrc/` into one shared library and load it.

`nvcc` compiles every `csrc/*.cu` for `sm_90a`, one process per source, all
started together, then links the objects into `csrc/build/libgt_kernels.so`
(plain C entry points, no PyTorch headers, so the build takes seconds),
which is loaded with ctypes. The build runs on first use and again whenever
a source or header is newer than the library; `csrc/build/build.log` keeps the
compiler's output (`-Xptxas -v`: registers, shared memory and spills of
each kernel).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
SOURCES = ("geo_embedding.cu", "geo_embedding_bwd.cu", "sinkhorn.cu", "radius_search.cu")
HEADERS = ("tf32_mma.cuh",)
LIBRARY = os.path.join(BUILD_DIR, "libgt_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # name: argtypes (all return int: the cudaError_t after the launch)
    "gt_geo_embedding": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P],
    "gt_geo_embedding_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P],
    "gt_geo_embedding_bwd_chunks": [],
    "gt_sinkhorn": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "gt_radius_search_group": [_P, _I, _P, _I, _P, _P, _P, _P],
    "gt_radius_search_info": [_I, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the kernels in csrc/")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _stale() -> bool:
    if not os.path.exists(LIBRARY):
        return True
    built = os.path.getmtime(LIBRARY)
    return any(os.path.getmtime(os.path.join(CSRC_DIR, s)) > built for s in SOURCES + HEADERS)


def build() -> str:
    """Compile the kernels if the library is missing or stale; returns its path."""
    if not _stale():
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    tag = f"{os.getpid()}.tmp"
    objects = [os.path.join(BUILD_DIR, f"{os.path.splitext(s)[0]}.{tag}.o") for s in SOURCES]
    commands = [[nvcc, *flags, "-Xptxas", "-v", "-c", "-o", obj, os.path.join(CSRC_DIR, src)]
                for src, obj in zip(SOURCES, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for cmd in commands]
    outputs = [proc.communicate() for proc in procs]
    log = [" ".join(cmd) + "\n" + out + err for cmd, (out, err) in zip(commands, outputs)]
    failed = [(cmd[-1], proc.returncode, err) for cmd, proc, (_, err) in zip(commands, procs, outputs)
              if proc.returncode != 0]
    tmp = f"{LIBRARY}.{tag}"
    if not failed:
        link = [nvcc, *flags, "-shared", "-o", tmp, *objects]
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(("link", proc.returncode, proc.stderr))
    with open(BUILD_LOG, "w") as f:
        f.write("".join(log))
    for obj in objects:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        name, code, err = failed[0]
        raise RuntimeError(f"nvcc failed on {name} (exit {code}):\n{err[-4000:]}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point typed."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
