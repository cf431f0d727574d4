"""Where a launch of ``band_qr_wide`` spends its clock cycles, by phase.

    python3 scripts/wide_probe.py [--out F]

Builds a copy of ``csrc/band_qr_wide.cu``, with ``csrc/band_wide.cuh`` (the
device code it shares with ``band_sweep_tiled.cu``) inlined, into
``build/wide_probe/`` with
``clock64()`` stamps at the anchors of :data:`ANCHORS` (thread 0 of block
0 records each, so the cycles are those of one chain), launches it at
:data:`SHAPES`, holds each solution to the plain version on a CPU copy,
and prints per shape the total cycles and the cycles between consecutive
anchors, summed over stages: the panel's column steps (warp 0's chain of
a step, and its wait for the other warps), G, T's levels,
the trailing products, and the back substitution's staging, products and
triangular solves.  Needs an NVIDIA GPU and ``nvcc``; the stamps cost a
few cycles each and nothing else.  The anchors are literal lines of
``band_wide.cuh``: after an edit there, update :data:`ANCHORS` (the probe
raises on an anchor it does not find once).
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from dompc_tpu_torch.solver import band_qr  # noqa: E402

LOG = 16384   # stamps kept
# (text in the source, stamp before it (True) or after it, phase name)
ANCHORS = [
    ("  for (int e = 0; e < S; ++e) {\n", False, "stage load"),
    ("    // ---- 1. the panel", True, "panel"),
    ("      const T bj = beta[j];\n", True, "panel chain"),
    ("        make_reflector<T, RL>(P, ldp, j + 1, m, col, beta, rdiag, lane);\n",
     False, "panel wait"),
    ("    // ---- 2. R_e to F", True, "R and G"),
    ("    __syncthreads();  // R has left the strict upper part", True,
     "T level"),
    ("    for (int s = 1; s < b; s *= 2) {\n", False, "T level X"),
    ("      __syncthreads();\n      constexpr int kEl", True, "T level TX"),
    ("    // ---- 3-4.", True, "trailing"),
    ("  // ---- 5. back substitution", True, "back substitution"),
    ("    const int nj = k + 2 < S ? 2 * b : (k + 1 < S ? b : 0);", False,
     "bs staging"),
    ("      // y = c_k - [B_k C_k] X", True, "bs products"),
    ("      // R_k x = y", True, "bs solve"),
    ("    __syncthreads();  // x_k is written", True, "bs next"),
]
SHAPES = [((1, 11, 83, 2), "float64"), ((1, 11, 83, 2), "float32"),
          ((9, 21, 84, 24), "float64")]


def probe_source(src):
    """The kernel's source with a stamp at every anchor (each anchor must
    appear once) and one at the end of the chain's solve."""
    hdr = ("__device__ long long wide_probe_log[2][%d];\n"
           "__device__ int wide_probe_n;\n"
           "#define WIDE_STAMP(k) if (threadIdx.x == 0 && blockIdx.x == 0 "
           "&& wide_probe_n < %d) { wide_probe_log[0][wide_probe_n] = k; "
           "wide_probe_log[1][wide_probe_n] = clock64(); ++wide_probe_n; }\n"
           % (LOG, LOG))
    src = src.replace("namespace wide {", hdr + "namespace wide {", 1)
    for k, (text, before, _) in enumerate(ANCHORS):
        if src.count(text) != 1:
            raise ValueError(f"wide_probe: anchor not found once: {text!r}")
        stamp = f"WIDE_STAMP({k})\n"
        src = src.replace(text, stamp + text if before else text + stamp)
    end = src.index("}  // namespace wide")
    close = src.rindex("\n}\n", 0, end)
    src = src[:close] + f"\n  WIDE_STAMP({len(ANCHORS)})\n}}\n" + \
        src[close + 3:]
    return src + '''
extern "C" int wide_probe_read(long long* out, int* n) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(n, wide_probe_n, sizeof(int));
  cudaMemcpyFromSymbol(out, wide_probe_log, sizeof(long long) * 2 * %d);
  int z = 0;
  cudaMemcpyToSymbol(wide_probe_n, &z, sizeof(int));
  return (int)cudaGetLastError();
}
''' % LOG


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wide_probe needs an NVIDIA GPU")
    out = band_qr.BUILD_DIR / "wide_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "band_qr_wide_probe.cu"
    hdr = (band_qr._CSRC / "band_wide.cuh").read_text()
    kernel = band_qr.SOURCES["band_qr_wide"].read_text().replace(
        '#include "band_wide.cuh"\n', hdr.replace("#pragma once\n", ""))
    src.write_text(probe_source(kernel))
    so = out / "libband_qr_wide_probe.so"
    r = subprocess.run([band_qr._nvcc(), *band_qr.NVCC_FLAGS, "-o", str(so),
                        str(src)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    names = [a[2] for a in ANCHORS] + ["end"]
    rows = []
    for shape, dname in SHAPES:
        N, S, b, t = shape
        dt = getattr(torch, dname)
        rng = np.random.default_rng(0)
        arrays = [rng.standard_normal((N, S, b, b)) + 3 * b * np.eye(b),
                  0.5 * rng.standard_normal((N, S - 1, b, b)),
                  0.5 * rng.standard_normal((N, S - 1, b, b)),
                  rng.standard_normal((N, S, b, t))]
        D, U, Lo, rhs = [torch.as_tensor(a, dtype=dt, device="cuda")
                         for a in arrays]
        plan = band_qr.qr_plan(b, t, dt)
        x = torch.empty_like(rhs)
        F = D.new_empty((N, S, b, 3 * b + plan.chunk))
        fn = getattr(lib, "band_qr_wide_solve_"
                     + ("f32" if dt == torch.float32 else "f64"))
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        buf, n = (ctypes.c_longlong * (2 * LOG))(), ctypes.c_int()
        for _ in range(2):        # the second launch is the one read
            lib.wide_probe_read(buf, ctypes.byref(n))
            err = fn(D.data_ptr(), U.data_ptr(), Lo.data_ptr(),
                     rhs.data_ptr(), x.data_ptr(), F.data_ptr(), N, S, b, t,
                     plan.chunk, plan.chunks,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"band_qr_wide probe launch: {err}")
            torch.cuda.synchronize()
        lib.wide_probe_read(buf, ctypes.byref(n))
        ids, clk = buf[:n.value], buf[LOG:LOG + n.value]
        phases = collections.Counter()
        for a, c0, c1 in zip(ids, clk, clk[1:]):
            phases[names[a]] += c1 - c0
        ref = band_qr.band_solve_qr_multi(*[a.cpu() for a in (D, U, Lo,
                                                              rhs)])
        row = dict(shape=list(shape), dtype=dname,
                   rel_err=float((x.cpu() - ref).abs().max()
                                 / ref.abs().max()),
                   total_cycles=clk[-1] - clk[0],
                   cycles=dict(phases.most_common()))
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))


if __name__ == "__main__":
    main()
