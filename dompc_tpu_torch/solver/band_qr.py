"""Block-tridiagonal chain solves: the two hand-written CUDA sweeps, their
plain PyTorch version, their launch plans, and the launch counters.

Both wrappers solve N independent block-tridiagonal systems with t
right-hand-side columns (D (N,S,b,b); U, Lo (N,S-1,b,b); rhs (N,S,b,t)).
On a CUDA tensor they launch their kernel (built with ``nvcc`` for
``sm_90a`` at first use, into ``build/`` at the repository root) and raise
if the build or the launch fails; on a CPU tensor they run the plain
version :func:`band_solve_qr_multi`.  There is no fallback between the
two.

* :func:`band_solve` launches ``csrc/band_qr.cu`` (float and double), which
  replaces the TPU kernels ``_band_fwd_kernel`` and ``_band_bwd_kernel`` of
  the JAX package's ``solver/pallas_band.py``: one thread block per chain,
  one panel column per thread;
* :func:`band_solve_tiled` launches ``csrc/band_sweep_tiled.cu`` (float
  only), which replaces ``_band_sweep_kernel`` of the same file: one warp
  per chain, G chains per block, each lane owning ``tiled_cols`` panel
  columns, the pivot column exchanged with warp shuffles.

Both keep each thread's panel columns in registers, in a row bucket (a
template instance of the kernel) chosen from b by :func:`row_bucket`; the
column-step machinery is ``csrc/band_core.cuh``, shared by both sources.
A column step is the same scaled Householder reflector as on the TPU; the
kernels are bound by the S*b dependent column steps of a chain, not by
bytes or flops, and use neither tensor cores nor TMA (a 26-row panel takes
rank-1 updates in full precision; its blocks are not 16-byte sized).
:func:`qr_plan` and :func:`tiled_plan` mirror the launchers' plans in the
CUDA sources, which check the plan they are given against their own.  The
notes at the top of each CUDA source give the design and bound.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {"band_qr": _CSRC / "band_qr.cu",
           "band_sweep_tiled": _CSRC / "band_sweep_tiled.cu"}
HEADERS = (_CSRC / "band_core.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMEM_MAX = 232448            # dynamic shared memory one H100 block may use
ROW_BUCKETS = (4, 8, 13, 16, 32, 64, 97)   # kernel instances (band_core.cuh)
TILED_MAX_G = 4              # chains (warps) per block of the tiled kernel
TILED_MIN_BLOCKS = 3         # its __launch_bounds__: 3 blocks of 4 warps an SM

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


# --------------------------------------------------------------------------
# launch plans (mirrors of qr_plan / tiled_plan in csrc/band_core.cuh)
# --------------------------------------------------------------------------

class Plan(NamedTuple):
    """A kernel launch: ``rows`` the row bucket (kernel instance),
    ``width`` the physical panel columns of one group (band_qr: threads a
    block; tiled: 32 lanes times ``tiled_cols``), ``chunk``/``chunks`` the
    right-hand sides a group solves and the groups a chain takes,
    ``buffers`` the staging buffers (2 when they fit: prefetch one stage
    ahead), ``G`` the groups (chains) a block, ``smem`` the dynamic shared
    bytes a block."""
    rows: int
    width: int
    chunk: int
    chunks: int
    buffers: int
    G: int
    smem: int


def row_bucket(b):
    """The smallest row bucket >= b (the register arrays' size)."""
    for rows in ROW_BUCKETS:
        if b <= rows:
            return rows
    raise ValueError(f"band kernels: b={b} exceeds the widest row bucket "
                     f"{ROW_BUCKETS[-1]}")


def qr_max_threads(rows):
    """Threads a ``band_qr`` block of a row bucket may have."""
    return max(256, (3 * rows + 1 + 31) // 32 * 32)


def tiled_cols(rows):
    """Panel columns a lane of the tiled kernel owns (room for >= 16
    right-hand sides beside the 3 * rows structural columns)."""
    return (3 * rows + 16 + 31) // 32


def _chunk(t, room):
    tmax = min(max(t, 1), room)
    nch = -(-t // tmax) if t > 0 else 1
    return (-(-t // nch) if t > 0 else 0), nch


def _quad(n):
    return (n + 3) // 4 * 4


def _group_words(rows, b, width, tcp, nbuf):
    # two reflector slots of 2 rows + 1 words rounded up to 4; nbuf staging
    # buffers, each the larger of the next stage's rows (b, width) and the
    # staged F_k: its blocks padded to quad(rows) columns, rows of stride
    # 3 quad(rows) + quad(tcp), rows past b staged (as zeros) in the
    # unrolled buckets (rows <= 32); three x blocks of tcp right-hand sides
    # at the ring stride (csrc/band_core.cuh:ring_stride)
    staged = (rows if rows <= 32 else b) * (3 * _quad(rows) + _quad(tcp))
    ring = (rows | 1) if rows > 32 else \
        _quad(rows) + (0 if (_quad(rows) // 4) % 2 else 4)
    return 2 * _quad(2 * rows + 1) + nbuf * _quad(max(b * width, staged)) \
        + _quad(3 * ring * tcp)


def _fit(b, t, width, itemsize, tcp, nch, rows):
    """(width, tcp, nch, buffers, words) of a group; while it does not fit
    one block's shared memory the right-hand sides go to more, narrower
    chunks (mirrors ``fit`` in csrc/band_core.cuh)."""
    n = nch
    while True:
        w = width or (3 * b + tcp + 31) // 32 * 32
        nbuf = 2 if itemsize * _group_words(rows, b, w, tcp, 2) <= SMEM_MAX \
            else 1
        words = _group_words(rows, b, w, tcp, nbuf)
        if itemsize * words <= SMEM_MAX or tcp <= 1:
            return w, tcp, nch, nbuf, words
        tcp = (t + n) // (n + 1)
        nch = -(-t // tcp)
        n += 1


def qr_plan(b, t, dtype):
    """Launch plan of ``band_qr``: one block of ``width`` threads (3b + t
    rounded up to 32) per chain and right-hand-side chunk.  Raises
    ValueError for panels no instance takes."""
    rows = row_bucket(b)
    itemsize = torch.empty((), dtype=dtype).element_size()
    tcp, nch = _chunk(t, qr_max_threads(rows) - 3 * b)
    width, tcp, nch, nbuf, words = _fit(b, t, 0, itemsize, tcp, nch, rows)
    if itemsize * words > SMEM_MAX:
        raise ValueError(f"band_solve: panel (b={b}, t={t}) exceeds one "
                         "block's shared memory")
    return Plan(rows, width, tcp, nch, nbuf, 1, itemsize * words)


def tiled_plan(b, t, chains_per_tile=None):
    """Launch plan of the tiled kernel (float32): one warp per chain and
    right-hand-side chunk, G warps a block.  G is set by registers, not
    shared memory: the kernel's ``__launch_bounds__(128, 3)`` caps a thread
    at 168 registers so that 3 blocks of G = ``TILED_MAX_G`` = 4 warps (12
    warps, 12 chains) fit an SM, and a batch of 128 flagship problems
    (1152 chains over 132 SMs: 9 an SM) is resident in one wave.  Shared
    memory (reflector slots, staging, x vectors: 9.8 KB a warp at the
    flagship) lowers G only for panels too wide for 4 warps.
    ``chains_per_tile`` forces G (1..TILED_MAX_G)."""
    rows = row_bucket(b)
    tcp, nch = _chunk(t, 32 * tiled_cols(rows) - 3 * b)
    width, tcp, nch, nbuf, words = _fit(b, t, 32 * tiled_cols(rows), 4, tcp,
                                        nch, rows)
    if chains_per_tile is None:
        G = min(TILED_MAX_G, SMEM_MAX // (4 * words))
    else:
        G = int(chains_per_tile)
        if not 1 <= G <= TILED_MAX_G:
            raise ValueError(f"chains_per_tile={chains_per_tile}: 1.."
                             f"{TILED_MAX_G} chains (warps) per block")
    if G < 1 or 4 * G * words > SMEM_MAX:
        raise ValueError(f"tiled band sweep: panel (b={b}, t={t}) of {G} "
                         "chains exceeds one block's shared memory")
    return Plan(rows, width, tcp, nch, nbuf, G, 4 * G * words)


# --------------------------------------------------------------------------
# build and load
# --------------------------------------------------------------------------

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
    src = SOURCES[name].read_bytes() + b"".join(h.read_bytes()
                                                for h in HEADERS)
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def build():
    """Compile every kernel source into ``build/`` unless a build of the
    same sources and flags exists: one ``nvcc`` per source, all started
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


_INSTANCE = (re.compile(r"band_qr_kernelI([fd])Li(\d+)E"),
             re.compile(r"band_sweep_tiled_kernelILi(\d+)E"))


def ptxas_report(log):
    """Per kernel instance, what ``nvcc -Xptxas -v`` reported: registers,
    static shared bytes, stack frame and spill bytes.  Returns a list of
    dicts with an ``instance`` label such as ``band_qr<float,13>`` or
    ``band_sweep_tiled<13>``."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            qr, tl = (p.search(name) for p in _INSTANCE)
            label = (f"band_qr<{'float' if qr.group(1) == 'f' else 'double'}"
                     f",{qr.group(2)}>" if qr else
                     f"band_sweep_tiled<{tl.group(1)}>" if tl else name)
            cur = dict(instance=label, registers=None, smem=0, stack=0,
                       spill_stores=0, spill_loads=0)
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem"] = int(m.group(1))
    return rows


_ARGTYPES = {
    "band_qr": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                + [ctypes.c_void_p],
                ("band_qr_solve_f32", "band_qr_solve_f64")),
    "band_sweep_tiled": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
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


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

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


def launcher(name, D, U, Lo, rhs, chains_per_tile=None):
    """(launch, x): a function that launches kernel ``name``
    (``"band_qr"`` or ``"band_sweep_tiled"``) once on the given contiguous
    CUDA inputs, into the solution ``x`` and a factor scratch allocated
    here, on the current stream; it raises if the launch is refused.  It
    neither checks the inputs nor counts: the wrappers do both, and
    ``chip_smoke.py`` times the kernel's device time with it."""
    N, S, b, t = rhs.shape
    if name == "band_qr":
        plan = qr_plan(b, t, D.dtype)
        fn = _load(name).band_qr_solve_f32 if D.dtype == torch.float32 \
            else _load(name).band_qr_solve_f64
        extra = ()
    else:
        plan = tiled_plan(b, t, chains_per_tile)
        fn = _load(name).band_sweep_tiled_f32
        extra = (plan.G,)
    x = torch.empty_like(rhs)
    F = D.new_empty((N * plan.chunks, S, b, 3 * b + plan.chunk))
    args = (D.data_ptr(), U.data_ptr(), Lo.data_ptr(), rhs.data_ptr(),
            x.data_ptr(), F.data_ptr(), N, S, b, t, plan.chunk, plan.chunks,
            *extra, _stream(D.device))

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError "
                               f"{err}")

    launch.inputs = (D, U, Lo, rhs, F)     # kept alive with the closure
    return launch, x


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
    launch, x = launcher("band_qr", D, U, Lo, rhs)
    launch()
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
    launch, x = launcher("band_sweep_tiled", D, U, Lo, rhs, chains_per_tile)
    launch()
    _band_solve_tiled.launches += 1
    return x


_band_solve_tiled = band_solve_tiled
band_solve_tiled.launches = 0
