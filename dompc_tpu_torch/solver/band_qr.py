"""Block-tridiagonal chain solve: the hand-written CUDA band-QR kernel, its
plain PyTorch twin, and the launch counter.

:func:`band_solve` solves N independent block-tridiagonal systems with t
right-hand-side columns (D (N,S,b,b); U, Lo (N,S-1,b,b); rhs (N,S,b,t)).
On a CUDA tensor it launches ``csrc/band_qr.cu`` (built with ``nvcc`` for
``sm_90a`` at first use, into ``build/`` at the repository root) and
raises if the build or the launch fails; on a CPU tensor it runs the twin
:func:`band_solve_qr_multi`.  There is no fallback between the two.

The kernel replaces the TPU kernels ``_band_fwd_kernel`` and
``_band_bwd_kernel`` of the JAX package's ``solver/pallas_band.py``
(see the note at the top of the CUDA source for its design and bound).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "band_qr.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMEM_MAX = 232448            # dynamic shared memory one H100 block may use

_lib = None


def band_solve_qr_multi(D, U, Lo, rhs):
    """Pivot-free block-tridiagonal solve, batched over chains (the twin of
    the kernel; port of the JAX package's ``bbd.band_solve_qr_multi``).

    Sequential block-QR elimination: at each stage one R-only QR of the
    augmented (2b, 3b+t) panel eliminates the sub-diagonal block; the
    trailing rows carry on.  D: (N,S,b,b); U, Lo: (N,S-1,b,b);
    rhs: (N,S,b,t).  Returns (N,S,b,t).
    """
    N, S, b, t = rhs.shape
    zero = D.new_zeros((N, b, b))
    Dh, Uh, rh = D[:, 0], (U[:, 0] if S > 1 else zero), rhs[:, 0]
    factors = []
    for k in range(1, S):
        U_n = U[:, k] if k < S - 1 else zero
        M = torch.cat([torch.cat([Dh, Uh, zero, rh], dim=-1),
                       torch.cat([Lo[:, k - 1], D[:, k], U_n, rhs[:, k]],
                                 dim=-1)], dim=-2)
        Rm = torch.linalg.qr(M, mode="r")[1]               # (N, 2b, 3b+t)
        factors.append((Rm[:, :b, :b], Rm[:, :b, b:2 * b],
                        Rm[:, :b, 2 * b:3 * b], Rm[:, :b, 3 * b:]))
        Dh, Uh, rh = (Rm[:, b:, b:2 * b], Rm[:, b:, 2 * b:3 * b],
                      Rm[:, b:, 3 * b:])
    Rf = torch.linalg.qr(torch.cat([Dh, rh], dim=-1), mode="r")[1]
    x1 = torch.linalg.solve_triangular(Rf[:, :b, :b], Rf[:, :b, b:],
                                       upper=True)
    x2 = torch.zeros_like(x1)
    xs = [x1]
    for R_k, B_k, C_k, c_k in reversed(factors):
        x_k = torch.linalg.solve_triangular(R_k, c_k - B_k @ x1 - C_k @ x2,
                                            upper=True)
        xs.append(x_k)
        x1, x2 = x_k, x1
    return torch.stack(xs[::-1], dim=1)


def _nvcc():
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the band-QR kernel is built from "
                       "csrc/band_qr.cu with the CUDA toolkit")


def build():
    """Compile the kernel into ``build/`` unless a build of the same source
    exists.  Returns (library path, seconds spent, compiler log)."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libband_qr_{tag[:16]}.so"
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
    os.replace(tmp, so)         # atomic: a concurrent build never loads half
    return so, time.perf_counter() - t0, proc.stderr


def _load():
    global _lib
    if _lib is None:
        so, _, _ = build()
        lib = ctypes.CDLL(str(so))
        argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        for name in ("band_qr_solve_f32", "band_qr_solve_f64"):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes(b, t, dtype):
    """Dynamic shared memory of one block (mirrors ``launch`` in the CUDA
    source)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return itemsize * (2 * b * (3 * b + t) + 2 * b + 3 * b * t + 2)


def _check(D, U, Lo, rhs):
    if not (D.ndim == U.ndim == Lo.ndim == rhs.ndim == 4):
        raise ValueError("band_solve expects D (N,S,b,b), U/Lo (N,S-1,b,b), "
                         "rhs (N,S,b,t)")
    N, S, b, b2 = D.shape
    t = rhs.shape[-1]
    if b2 != b or tuple(rhs.shape[:3]) != (N, S, b) or \
            tuple(U.shape) != (N, max(S - 1, 0), b, b) or \
            tuple(Lo.shape) != tuple(U.shape) or S < 1:
        raise ValueError(
            f"band_solve shapes: D {tuple(D.shape)}, U {tuple(U.shape)}, "
            f"Lo {tuple(Lo.shape)}, rhs {tuple(rhs.shape)}")
    if len({a.dtype for a in (D, U, Lo, rhs)}) != 1 or \
            D.dtype not in (torch.float32, torch.float64):
        raise TypeError("band_solve takes float32 or float64 tensors of one "
                        "dtype")
    if len({a.device for a in (D, U, Lo, rhs)}) != 1:
        raise ValueError("band_solve inputs must lie on one device")
    return N, S, b, t


def band_solve(D, U, Lo, rhs):
    """Solve the chains: the CUDA kernel for CUDA tensors, the twin for CPU
    tensors.  Counts kernel launches in ``band_solve.launches``."""
    N, S, b, t = _check(D, U, Lo, rhs)
    if D.device.type == "cpu":
        return band_solve_qr_multi(D, U, Lo, rhs)
    if D.device.type != "cuda":
        raise ValueError(f"band_solve: unsupported device {D.device}")
    if not all(a.is_contiguous() for a in (D, U, Lo, rhs)):
        raise ValueError("band_solve: CUDA inputs must be contiguous")
    if smem_bytes(b, t, D.dtype) > SMEM_MAX:
        raise ValueError(f"band_solve: panel (b={b}, t={t}) exceeds one "
                         "block's shared memory")
    lib = _load()
    x = torch.empty_like(rhs)
    F = torch.empty((N, max(S - 1, 1), b, 3 * b + t), dtype=D.dtype,
                    device=D.device)
    fn = lib.band_qr_solve_f32 if D.dtype == torch.float32 \
        else lib.band_qr_solve_f64
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream(D.device).cuda_stream
        err = fn(D.data_ptr(), U.data_ptr(), Lo.data_ptr(), rhs.data_ptr(),
                 x.data_ptr(), F.data_ptr(), N, S, b, t, stream)
    if err != 0:
        raise RuntimeError(f"band_qr kernel launch failed: cudaError {err}")
    band_solve.launches += 1
    return x


band_solve.launches = 0
