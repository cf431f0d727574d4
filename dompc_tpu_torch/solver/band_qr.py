"""Block-tridiagonal chain solves: the hand-written CUDA sweeps, their
plain PyTorch version, their launch plans, and the launch counters.

Both wrappers solve N independent block-tridiagonal systems with t
right-hand-side columns (D (N,S,b,b); U, Lo (N,S-1,b,b); rhs (N,S,b,t)).
On a CUDA tensor they launch their kernel (built with ``nvcc`` for
``sm_90a`` at first use, into ``build/`` at the repository root) and raise
if the build or the launch fails; on a CPU tensor they run the plain
version :func:`band_solve_qr_multi`.  There is no fallback between the
two.

* :func:`band_solve` replaces the TPU kernels ``_band_fwd_kernel`` and
  ``_band_bwd_kernel`` of the JAX package's ``solver/pallas_band.py``
  (float and double) with one of two kernels, chosen from b before the
  launch (:func:`qr_kernel`): ``csrc/band_qr.cu`` for b <= 32 (one thread
  block per chain, one panel column per thread, in registers) and
  ``csrc/band_qr_wide.cu`` for 33 <= b <= 97 (one block per chain, the
  panel in shared memory, blocked Householder with a compact-WY trailing
  update streamed in column tiles);
* :func:`band_solve_tiled` launches ``csrc/band_sweep_tiled.cu`` (float
  only), which replaces ``_band_sweep_kernel`` of the same file with a
  design per row bucket: up to b = 16 one warp per chain, G chains per
  block, each lane owning ``tiled_cols`` panel columns, the pivot column
  exchanged with warp shuffles; at b = 17..32 one block of a few warps
  per chain (one panel column a thread, as ``band_qr.cu``); at b = 33..97
  one block per
  chain with ``band_qr_wide``'s blocked-WY sweep.

``band_qr.cu`` and the tiled kernel's buckets up to 32 keep each thread's
panel columns in registers, in a row bucket (a template instance of the
kernel) chosen from b by :func:`row_bucket`; their column-step machinery
is ``csrc/band_core.cuh``.  The wide bands' blocked-WY sweep is
``csrc/band_wide.cuh``, shared by ``band_qr_wide.cu`` and the tiled
kernel.  A column step is the same scaled Householder reflector as on the
TPU in every kernel; the kernels are bound by the S*b dependent column
steps of a chain, not by bytes.  The narrow instances use neither tensor
cores nor TMA (a 13-wide block is not 16-byte sized); the wide ones run
their trailing products on the float64 tensor cores (never TF32: the
1e22-diagonal barrier chains need full precision).
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
           "band_qr_wide": _CSRC / "band_qr_wide.cu",
           "band_sweep_tiled": _CSRC / "band_sweep_tiled.cu"}
HEADERS = (_CSRC / "band_core.cuh", _CSRC / "band_wide.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMEM_MAX = 232448            # dynamic shared memory one H100 block may use
ROW_BUCKETS = (4, 8, 13, 16, 32, 64, 97)   # kernel instances (band_core.cuh)
NARROW_MAX = 32              # band_qr.cu's widest bucket; band_qr_wide.cu above
WIDE_THREADS = 512           # a band_qr_wide block (csrc/band_qr_wide.cu)
TILED_MAX_G = 4              # chains per block of the tiled kernel, b <= 16
TILED_MIN_BLOCKS = 3         # its __launch_bounds__ up to bucket 16: 3 blocks
#                              of 4 warps an SM

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
    ``width`` the physical panel columns of one group (band_qr and the
    tiled kernel's bucket 32: threads a chain; the tiled kernel's buckets
    up to 16: 32 lanes times ``tiled_cols``; band_qr_wide and the tiled
    kernel's wide buckets: the threads of its block), ``chunk``/``chunks``
    the right-hand sides a group solves
    and the groups a chain takes, ``buffers`` the staging buffers (2 when
    they fit: prefetch one stage, or one column tile, ahead), ``G`` the
    groups (chains) a block, ``smem`` the dynamic shared bytes a block,
    ``tile`` band_qr_wide's trailing-update tile width (0 elsewhere)."""
    rows: int
    width: int
    chunk: int
    chunks: int
    buffers: int
    G: int
    smem: int
    tile: int = 0


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


def qr_kernel(b):
    """The kernel :func:`band_solve` launches for band width b:
    ``"band_qr"`` (b <= 32) or ``"band_qr_wide"`` (33 <= b <= 97)."""
    return "band_qr_wide" if row_bucket(b) > NARROW_MAX else "band_qr"


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


def _wide_words(b, nt, nbuf, itemsize):
    # the panel (column stride: 4 times an odd number >= 2b), beta and R's
    # diagonal, then the larger of the packed Gram matrix and nbuf tile
    # buffers (2b rows) and W (b rows), rows of nt + 32 / itemsize words
    # (csrc/band_qr_wide.cu:plan_words)
    q = (2 * b + 3) // 4
    ldp = 4 * (q + 1 - q % 2)
    ldc = nt + 32 // itemsize
    tiles = nbuf * _quad(2 * b * ldc) + _quad(b * ldc)
    return _quad(ldp * b) + 2 * _quad(b) + max(_quad(b * (b - 1) // 2), tiles)


def wide_plan(b, t, dtype):
    """Launch plan of ``band_qr_wide`` (33 <= b <= 97): one block of
    ``WIDE_THREADS`` per chain, all t right-hand sides in one chunk (the
    trailing columns stream through shared memory in tiles of ``tile``
    columns: the widest of 32, 16 and 8 that fits, with two ``buffers``
    when they fit, else one)."""
    rows = row_bucket(b)
    itemsize = torch.empty((), dtype=dtype).element_size()
    for nt in (32, 16, 8):
        for nbuf in (2, 1):
            smem = itemsize * _wide_words(b, nt, nbuf, itemsize)
            if smem <= SMEM_MAX:
                return Plan(rows, WIDE_THREADS, t, 1, nbuf, 1, smem, nt)
    raise ValueError(f"band_solve: panel (b={b}) exceeds one block's shared "
                     "memory")


def qr_plan(b, t, dtype):
    """Launch plan of the kernel :func:`band_solve` launches: for b <= 32
    ``band_qr``, one block of ``width`` threads (3b + t rounded up to 32)
    per chain and right-hand-side chunk; above, :func:`wide_plan`.  Raises
    ValueError for panels no instance takes."""
    rows = row_bucket(b)
    if rows > NARROW_MAX:
        return wide_plan(b, t, dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    tcp, nch = _chunk(t, qr_max_threads(rows) - 3 * b)
    width, tcp, nch, nbuf, words = _fit(b, t, 0, itemsize, tcp, nch, rows)
    if itemsize * words > SMEM_MAX:
        raise ValueError(f"band_solve: panel (b={b}, t={t}) exceeds one "
                         "block's shared memory")
    return Plan(rows, width, tcp, nch, nbuf, 1, itemsize * words)


def tiled_plan(b, t, chains_per_tile=None):
    """Launch plan of the tiled kernel (float32), by row bucket; G
    (``chains_per_tile`` forces it) is the chains a block.

    * Buckets <= 16: one warp per chain and right-hand-side chunk, G warps
      a block.  G is set by registers, not shared memory: the kernel's
      ``__launch_bounds__(128, 3)`` caps a thread at 168 registers so that
      3 blocks of G = ``TILED_MAX_G`` = 4 warps (12 warps, 12 chains) fit
      an SM, and a batch of 128 flagship problems (1152 chains over 132
      SMs: 9 an SM) is resident in one wave.  Shared memory (reflector
      slots, staging, x vectors: 9.8 KB a warp at the flagship) lowers G
      only for panels too wide for 4 warps.
    * Bucket 32 (b = 17..32): ``band_qr``'s plan (``width`` = 3b + chunk
      threads rounded up to 32, one panel column a thread), one chain a
      block, G = 1 (2 to 4 chains a block measured no faster anywhere, and
      slower where the chains could each have had an SM).
    * Buckets 64 and 97 (b = 33..97): :func:`wide_plan` in float32, one
      block of ``WIDE_THREADS`` a chain, G = 1.

    Raises ValueError for a G outside 1..the most the bucket allows."""
    rows = row_bucket(b)
    if rows >= NARROW_MAX:      # band_solve's plan: band_qr or wide_plan
        plan, gmax, G = qr_plan(b, t, torch.float32), 1, 1
        words = plan.smem // 4
    else:
        tcp, nch = _chunk(t, 32 * tiled_cols(rows) - 3 * b)
        width, tcp, nch, nbuf, words = _fit(b, t, 32 * tiled_cols(rows), 4,
                                            tcp, nch, rows)
        plan = Plan(rows, width, tcp, nch, nbuf, 1, 4 * words)
        gmax = TILED_MAX_G
        G = min(TILED_MAX_G, SMEM_MAX // (4 * words))
    if chains_per_tile is not None:
        G = int(chains_per_tile)
        if not 1 <= G <= gmax:
            raise ValueError(f"chains_per_tile={chains_per_tile}: 1..{gmax} "
                             f"chains a block at b={b}, t={t}")
    if G < 1 or 4 * G * words > SMEM_MAX:
        raise ValueError(f"tiled band sweep: panel (b={b}, t={t}) of {G} "
                         "chains exceeds one block's shared memory")
    return plan._replace(G=G, smem=4 * G * words)


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


_INSTANCE = re.compile(
    r"(band_qr|band_qr_wide|band_sweep_tiled)_kernelI(?:([fd])Li|Li)(\d+)E")


def ptxas_report(log):
    """Per kernel instance, what ``nvcc -Xptxas -v`` reported: registers,
    static shared bytes, stack frame and spill bytes.  Returns a list of
    dicts with an ``instance`` label such as ``band_qr<float,13>``,
    ``band_qr_wide<double,97>`` or ``band_sweep_tiled<13>``."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            k = _INSTANCE.search(name)
            dt = k and {"f": "float,", "d": "double,", None: ""}[k.group(2)]
            label = f"{k.group(1)}<{dt}{k.group(3)}>" if k else name
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
    "band_qr_wide": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p],
                     ("band_qr_wide_solve_f32", "band_qr_wide_solve_f64")),
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
    (``"band_qr"``, ``"band_qr_wide"`` (each for the widths of
    :func:`qr_kernel`) or ``"band_sweep_tiled"``) once on the given contiguous
    CUDA inputs, into the solution ``x`` and a factor scratch allocated
    here, on the current stream; it raises if the launch is refused.  It
    neither checks the inputs nor counts: the wrappers do both, and
    ``chip_smoke.py`` times the kernel's device time with it."""
    N, S, b, t = rhs.shape
    if name in ("band_qr", "band_qr_wide"):
        if name != qr_kernel(b):
            raise ValueError(f"{name} does not take b={b}: {qr_kernel(b)} "
                             "does")
        plan = qr_plan(b, t, D.dtype)
        suffix = "f32" if D.dtype == torch.float32 else "f64"
        fn = getattr(_load(name), f"{name}_solve_{suffix}")
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
    """Solve the chains: a band-QR kernel for CUDA tensors (``band_qr``
    for b <= 32, ``band_qr_wide`` for 33 <= b <= 97, decided from the
    shape before the launch: one function, two launch plans, no fallback
    between them), the plain version for CPU tensors.  Counts the launches
    of both kernels in ``band_solve.launches``, and those of
    ``band_qr_wide`` also in ``band_solve.wide_launches``."""
    N, S, b, t = _check(D, U, Lo, rhs)
    if D.device.type == "cpu":
        return band_solve_qr_multi(D, U, Lo, rhs)
    if D.device.type != "cuda":
        raise ValueError(f"band_solve: unsupported device {D.device}")
    if not all(a.is_contiguous() for a in (D, U, Lo, rhs)):
        raise ValueError("band_solve: CUDA inputs must be contiguous")
    name = qr_kernel(b)
    launch, x = launcher(name, D, U, Lo, rhs)
    launch()
    _band_solve.launches += 1
    if name == "band_qr_wide":
        _band_solve.wide_launches += 1
    return x


# the counters live on the wrappers; the wrappers count through these
# aliases, so a caller that rebinds the module's names (to record the
# inputs, say) still counts on the real wrapper
_band_solve = band_solve
band_solve.launches = 0
band_solve.wide_launches = 0


def band_solve_tiled(D, U, Lo, rhs, chains_per_tile=None):
    """The same solve with the tiled sweep (the port of the JAX package's
    ``band_solve_qr_pallas``): float32 only, as there.  CUDA tensors
    launch ``csrc/band_sweep_tiled.cu`` (one launch, every b up to 97,
    the design chosen by the row bucket) with the layout of
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
