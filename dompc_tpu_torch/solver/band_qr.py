"""Block-tridiagonal chain solves: the two hand-written CUDA sweeps, their
plain PyTorch version, and the launch counters.

Both wrappers solve N independent block-tridiagonal systems with t
right-hand-side columns (D (N,S,b,b); U, Lo (N,S-1,b,b); rhs (N,S,b,t)).
On a CUDA tensor they launch their kernel (built with ``nvcc`` for
``sm_90a`` at first use, into ``build/`` at the repository root) and raise
if the build or the launch fails; on a CPU tensor they run the plain
version :func:`band_solve_qr_multi`.  There is no fallback between the
two.

* :func:`band_solve` launches ``csrc/band_qr.cu`` (float and double, one
  block per chain), which replaces the TPU kernels ``_band_fwd_kernel``
  and ``_band_bwd_kernel`` of the JAX package's ``solver/pallas_band.py``;
* :func:`band_solve_tiled` launches ``csrc/band_sweep_tiled.cu`` (float
  only, one warp per chain, the chain's factors resident in shared
  memory), which replaces ``_band_sweep_kernel`` of the same file.

The note at the top of each CUDA source gives its design and bound.
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

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {"band_qr": _CSRC / "band_qr.cu",
           "band_sweep_tiled": _CSRC / "band_sweep_tiled.cu"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMEM_MAX = 232448            # dynamic shared memory one H100 block may use
TILED_MAX_G = 8              # chains (warps) per block of the tiled kernel

_libs = {}


def band_solve_qr_multi(D, U, Lo, rhs):
    """Pivot-free block-tridiagonal solve, batched over chains (the plain
    version of both kernels; port of the JAX package's
    ``bbd.band_solve_qr_multi``).

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
    raise RuntimeError("nvcc not found: the band kernels are built from "
                       "dompc_tpu_torch/csrc with the CUDA toolkit")


def _so_path(name):
    src = SOURCES[name].read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def build():
    """Compile every kernel source into ``build/`` unless a build of the
    same source and flags exists: one ``nvcc`` per source, all started
    together.  Returns {name: (library path, seconds spent, compiler
    log)}."""
    started, out = {}, {}
    try:
        for name, src in SOURCES.items():
            so = _so_path(name)
            if so.exists():
                out[name] = (so, 0.0, "")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            started[name] = (proc, so, tmp, time.perf_counter())
        for name, (proc, so, tmp, t0) in started.items():
            _, log = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCES[name]}:\n{log}")
            os.replace(tmp, so)     # atomic: a concurrent build never
            out[name] = (so, time.perf_counter() - t0, log)  # loads half
    finally:
        for proc, _, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


_ARGTYPES = {
    "band_qr": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                + [ctypes.c_void_p],
                ("band_qr_solve_f32", "band_qr_solve_f64")),
    "band_sweep_tiled": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p], ("band_sweep_tiled_f32",)),
}


def _load(name):
    if name not in _libs:
        if not _so_path(name).exists():
            build()
        lib = ctypes.CDLL(str(_so_path(name)))
        argtypes, fns = _ARGTYPES[name]
        for fn_name in fns:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def smem_bytes(b, t, dtype):
    """Dynamic shared memory of one ``band_qr`` block (mirrors ``launch``
    in its CUDA source)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return itemsize * (2 * b * (3 * b + t) + 2 * b + 3 * b * t + 2)


def tiled_plan(S, b, t, chains_per_tile=None):
    """Launch layout of the tiled kernel: (G chains per block, whether the
    factors F stay in shared memory, dynamic shared bytes per block).
    Mirrors ``band_sweep_tiled_f32`` in its CUDA source.  By default G is
    as many chains as fit with their factors (at most ``TILED_MAX_G``);
    when one chain's factors do not fit, F goes to a global scratch and G
    is as many chains as fit without them."""
    n_p = 3 * b + t
    work = 2 * b * n_p + 2 * b + 3 * b * t      # panel, reflector, x's
    fac = max(S - 1, 1) * b * n_p               # the chain's factors
    if chains_per_tile is None:
        G = min(SMEM_MAX // (4 * (work + fac)), TILED_MAX_G)
        f_smem = G >= 1
        if not f_smem:
            G = min(SMEM_MAX // (4 * work), TILED_MAX_G)
    else:
        G = int(chains_per_tile)
        if not 1 <= G <= 32:
            raise ValueError(f"chains_per_tile={chains_per_tile}: 1..32 "
                             "chains (warps) per block")
        f_smem = 4 * G * (work + fac) <= SMEM_MAX
    smem = 4 * G * (work + (fac if f_smem else 0))
    if G < 1 or smem > SMEM_MAX:
        raise ValueError(f"tiled band sweep: panel (b={b}, t={t}) of "
                         f"{G} chains exceeds one block's shared memory")
    return G, f_smem, smem


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


def _stream(dev):
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


def band_solve(D, U, Lo, rhs):
    """Solve the chains: the band-QR kernel for CUDA tensors, the plain
    version for CPU tensors.  Counts kernel launches in
    ``band_solve.launches``."""
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
    lib = _load("band_qr")
    x = torch.empty_like(rhs)
    F = torch.empty((N, max(S - 1, 1), b, 3 * b + t), dtype=D.dtype,
                    device=D.device)
    fn = lib.band_qr_solve_f32 if D.dtype == torch.float32 \
        else lib.band_qr_solve_f64
    err = fn(D.data_ptr(), U.data_ptr(), Lo.data_ptr(), rhs.data_ptr(),
             x.data_ptr(), F.data_ptr(), N, S, b, t, _stream(D.device))
    if err != 0:
        raise RuntimeError(f"band_qr kernel launch failed: cudaError {err}")
    _band_solve.launches += 1
    return x


# the counters live on the wrappers; the wrappers count through these
# aliases, so a caller that rebinds the module's names (to record the
# inputs, say) still counts on the real wrapper
_band_solve = band_solve
band_solve.launches = 0


def band_solve_tiled(D, U, Lo, rhs, chains_per_tile=None):
    """The same solve with the tiled sweep (the port of the JAX package's
    ``band_solve_qr_pallas``): float32 only, as there.  CUDA tensors
    launch ``csrc/band_sweep_tiled.cu`` with the layout of
    :func:`tiled_plan`; CPU tensors run the plain version.  Counts kernel
    launches in ``band_solve_tiled.launches``."""
    N, S, b, t = _check(D, U, Lo, rhs)
    if D.dtype != torch.float32:
        raise TypeError("band_solve_tiled takes float32 tensors (the tiled "
                        f"sweep is float32 only), got {D.dtype}")
    if D.device.type == "cpu":
        return band_solve_qr_multi(D, U, Lo, rhs)
    if D.device.type != "cuda":
        raise ValueError(f"band_solve_tiled: unsupported device {D.device}")
    if not all(a.is_contiguous() for a in (D, U, Lo, rhs)):
        raise ValueError("band_solve_tiled: CUDA inputs must be contiguous")
    G, f_smem, _ = tiled_plan(S, b, t, chains_per_tile)
    lib = _load("band_sweep_tiled")
    x = torch.empty_like(rhs)
    F = D.new_empty((1,) if f_smem else (N, max(S - 1, 1), b, 3 * b + t))
    err = lib.band_sweep_tiled_f32(
        D.data_ptr(), U.data_ptr(), Lo.data_ptr(), rhs.data_ptr(),
        x.data_ptr(), F.data_ptr(), N, S, b, t, G, int(f_smem),
        _stream(D.device))
    if err != 0:
        raise RuntimeError(
            f"band_sweep_tiled kernel launch failed: cudaError {err}")
    _band_solve_tiled.launches += 1
    return x


_band_solve_tiled = band_solve_tiled
band_solve_tiled.launches = 0
