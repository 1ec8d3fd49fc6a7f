"""The SVD of small matrices on the card without a read-back to the host.

`torch.linalg.svd` of a CUDA tensor of matrices no larger than 32 x 32 runs
cuSOLVER's batched Jacobi SVD (`gesvdjBatched`), then reads two results back
to the host: its error check and its convergence check (each a wait for the
card to run everything queued). `svd` makes the same cuSOLVER call, through
the cuSOLVER library torch itself loads, with the parameters and the output
layout of torch 2.11's `svd_cusolver` (tolerance the dtype's epsilon, 400
sweeps, singular values sorted), and reads nothing back: its results are
`torch.linalg.svd`'s bit for bit, so code that compares against the plain
path (the benchmark's reference) sees the same numbers. Where cuSOLVER
reports a matrix as failed or not converged (where torch would raise or redo
it with another solver), and where a matrix holds a value that is not
finite, that matrix's U, S and Vh are NaN. The first call on a device holds
the call against `torch.linalg.svd` on a probe batch (one read-back); should
another torch version decide otherwise, `svd` warns and takes
`torch.linalg.svd` on that device from then on. CPU tensors, inputs that
require grad (the call has no backward), other dtypes than float32 and
matrices beyond 32 x 32 take `torch.linalg.svd`.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import warnings
from typing import Tuple

import torch

MAX_DIM = 32  # gesvdjBatched's limit on both matrix sides
MAX_SWEEPS = 400  # torch's cusolver_gesvdj_max_sweeps
_EIG_MODE_VECTOR = 1  # CUSOLVER_EIG_MODE_VECTOR
_MAGMA = torch._C._LinalgBackend.Magma  # with MAGMA preferred, torch.linalg.svd does not call cuSOLVER

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library_path() -> str:
    """torch's cuSOLVER: the `nvidia-cusolver` wheel's library where torch
    came with one, else the one the loader finds by name."""
    try:
        import nvidia.cusolver as wheel
    except ImportError:
        wheel = None
    for root in getattr(wheel, "__path__", []) or []:
        found = sorted(p for p in glob.glob(os.path.join(root, "lib", "libcusolver.so*"))
                       if os.path.basename(p).startswith("libcusolver.so"))
        if found:
            return found[-1]
    return "libcusolver.so.{}".format(11 if (torch.version.cuda or "12").split(".")[0] == "12" else 12)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(_library_path())
    lib.cusolverDnCreate.argtypes = [ctypes.POINTER(_P)]
    lib.cusolverDnSetStream.argtypes = [_P, _P]
    lib.cusolverDnCreateGesvdjInfo.argtypes = [ctypes.POINTER(_P)]
    lib.cusolverDnXgesvdjSetTolerance.argtypes = [_P, ctypes.c_double]
    lib.cusolverDnXgesvdjSetMaxSweeps.argtypes = [_P, _I]
    lib.cusolverDnXgesvdjSetSortEig.argtypes = [_P, _I]
    lib.cusolverDnSgesvdjBatched_bufferSize.argtypes = [_P, _I, _I, _I, _P, _I, _P, _P, _I, _P, _I, ctypes.POINTER(_I),
                                                         _P, _I]
    lib.cusolverDnSgesvdjBatched.argtypes = [_P, _I, _I, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P, _I]
    return lib


def _check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: cuSOLVER status {status}")


@functools.lru_cache(maxsize=None)
def _handle(device_index: int) -> int:
    """One cuSOLVER handle a device, made once."""
    handle = _P()
    with torch.cuda.device(device_index):
        _check(_library().cusolverDnCreate(ctypes.byref(handle)), "cusolverDnCreate")
    return handle.value


@functools.lru_cache(maxsize=None)
def _params() -> int:
    """The Jacobi parameters torch sets for f32: tolerance eps, 400 sweeps, sorted."""
    lib, params = _library(), _P()
    _check(lib.cusolverDnCreateGesvdjInfo(ctypes.byref(params)), "cusolverDnCreateGesvdjInfo")
    _check(lib.cusolverDnXgesvdjSetTolerance(params, torch.finfo(torch.float32).eps), "cusolverDnXgesvdjSetTolerance")
    _check(lib.cusolverDnXgesvdjSetMaxSweeps(params, MAX_SWEEPS), "cusolverDnXgesvdjSetMaxSweeps")
    _check(lib.cusolverDnXgesvdjSetSortEig(params, 1), "cusolverDnXgesvdjSetSortEig")
    return params.value


def _f_contiguous(shape, dtype, device) -> torch.Tensor:
    """An empty (*, m, n) tensor whose matrices are column-major."""
    return torch.empty(tuple(shape[:-2]) + (shape[-1], shape[-2]), dtype=dtype, device=device).transpose(-2, -1)


def _failed(info: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Per matrix of a (*, m, n): whether cuSOLVER's `info` (one int a
    matrix) reports it failed or not converged, or it holds a value that is
    not finite."""
    return (info != 0).reshape(a.shape[:-2]) | ~torch.isfinite(a).all(dim=-1).all(dim=-1)


def _fail_nan(u: torch.Tensor, s: torch.Tensor, vh: torch.Tensor, failed: torch.Tensor) -> None:
    """NaN, in place, in U, S and Vh of each matrix that `failed` (*) marks;
    no read-back."""
    u.masked_fill_(failed[..., None, None], float("nan"))
    s.masked_fill_(failed[..., None], float("nan"))
    vh.masked_fill_(failed[..., None, None], float("nan"))


def _gesvdj(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    m, n = a.shape[-2:]
    batch = a.numel() // (m * n)
    work_a = a.transpose(-2, -1).contiguous()  # column-major, overwritten by the call
    u = _f_contiguous(a.shape[:-2] + (m, m), a.dtype, a.device)
    v = _f_contiguous(a.shape[:-2] + (n, n), a.dtype, a.device)
    s = torch.empty(a.shape[:-2] + (min(m, n),), dtype=a.dtype, device=a.device)
    info = torch.empty(batch, dtype=torch.int32, device=a.device)
    lib = _library()
    handle, params = _handle(a.device.index or 0), _params()
    with torch.cuda.device(a.device):
        _check(lib.cusolverDnSetStream(handle, torch.cuda.current_stream(a.device).cuda_stream), "cusolverDnSetStream")
        lwork = _I()
        args = (handle, _EIG_MODE_VECTOR, m, n, work_a.data_ptr(), m, s.data_ptr(), u.data_ptr(), m, v.data_ptr(), n)
        _check(lib.cusolverDnSgesvdjBatched_bufferSize(*args, ctypes.byref(lwork), params, batch),
               "gesvdjBatched_bufferSize")
        work = torch.empty(max(lwork.value, 1), dtype=a.dtype, device=a.device)
        _check(lib.cusolverDnSgesvdjBatched(*args, work.data_ptr(), lwork.value, info.data_ptr(), params, batch),
               "gesvdjBatched")
    vh = v.transpose(-2, -1)
    _fail_nan(u, s, vh, _failed(info, a))
    return u, s, vh


def _probe(device: torch.device) -> torch.Tensor:
    """3 x 3 matrices as LGR's fits give them: generic, zero, rank 1 and
    rank 2 (whose singular vectors rounding decides), on `device`."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 3, 3, generator=g, dtype=torch.float64)
    a[1] = 0.0
    a[2] = torch.outer(a[2, 0], a[2, 1])
    a[3, :, 2] = 0.0
    a[4] = a[4] * 1e-6
    return a.to(device, torch.float32)


def matches_torch(device) -> bool:
    """Whether `svd`'s own call gives `torch.linalg.svd`'s U, S and Vh bit
    for bit, strides included, on a probe batch on the CUDA `device`; read
    back once a card."""
    device = torch.device(device)
    return _matches_torch(torch.cuda.current_device() if device.index is None else device.index)


@functools.lru_cache(maxsize=None)
def _matches_torch(index: int) -> bool:
    device = torch.device("cuda", index)
    a = _probe(device)
    same = all(torch.equal(g, w) and g.stride() == w.stride()
               for x in (a, a[:7], a[2]) for g, w in zip(_gesvdj(x), torch.linalg.svd(x)))
    if not same:
        warnings.warn(f"ops/svd.py: cuSOLVER's gesvdjBatched, called as torch {torch.__version__} is assumed to call "
                      f"it, differs from torch.linalg.svd on {device}; taking torch.linalg.svd there")
    return same


def svd(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U, S, Vh) of the matrices a (*, m, n), as `torch.linalg.svd(a)`
    (full matrices) returns them; on the card, with no read-back."""
    m, n = a.shape[-2:]
    if (a.device.type != "cuda" or a.requires_grad or a.dtype != torch.float32 or m > MAX_DIM or n > MAX_DIM
            or a.numel() == 0 or torch.backends.cuda.preferred_linalg_library() == _MAGMA
            or not matches_torch(a.device)):
        return torch.linalg.svd(a)
    return _gesvdj(a)
