"""Where a band kernel's time goes on the card: the forward sweep against
the back substitution, in SM clock cycles.

    python3 -m dompc_tpu_torch.tools.band_probe [--out FILE]

Builds probed copies of both band kernels into ``build/probe/``: the
committed sources with two ``clock64()`` reads added to
``band_core.cuh:solve_chain`` (when the forward sweep of a group ends and
when its back substitution ends), and nothing else changed.  Each kernel
(``band_qr`` in float32 and float64, ``band_sweep_tiled`` in float32)
runs at the flagship shape (9 chains, S=21, b=13, t=12) and at a batch of
128 flagship problems (1152 chains).  Prints one JSON line per kernel and
shape, and writes them to ``--out`` when given:

* ``device_ms``: the committed (unprobed) kernel's device time per launch,
  by :func:`device_ms`;
* ``fwd_cycles_per_step``: the median over groups of the forward sweep's
  cycles over its S*b column steps;
* ``backsub_cycles``: the median over groups of the back substitution's
  cycles;
* ``implied_ghz``: the slowest group's cycles over the probed kernel's
  device time (the SM clock when one wave holds every group);
* ``sm_clock``: ``nvidia-smi``'s SM clock and power while the kernel runs
  in a loop, and the card's name and power limit.

Needs CUDA and ``nvcc``; exits non-zero without them.
"""
import argparse
import ctypes
import json
import subprocess
import sys
import time

import numpy as np

SLEEP_CYCLES = 100_000_000   # >= 50 ms at the H100's 1.98 GHz boost clock

# (anchor in band_core.cuh, text inserted before it)
_PROBES = (
    ("  const int S = ch.S, b = ch.b, tc = ch.tc, tcp = ch.tcp;\n",
     "  const long long probe_t0 = clock64();\n"),
    ("  // back substitution: F_k staged in shared memory",
     "  if (Grp::rank() == 0)\n    band_probe_clk[2 * probe_item<Grp>()]"
     " = clock64() - probe_t0;\n"),
)
_PROBE_END = ("    if (k > 0 && nbuf == 1) {\n      Grp::sync();  // F_k fully"
              " read before the one buffer is refilled\n      fetch(k - 1);"
              "\n    }\n  }\n")
_PROBE_DEFS = '''
__device__ long long band_probe_clk[1 << 14];
template <class Grp> __device__ __forceinline__ long long probe_item();
template <> __device__ __forceinline__ long long probe_item<BlockGroup>() {
  return blockIdx.x;
}
template <> __device__ __forceinline__ long long probe_item<WarpGroup>() {
  return (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
}
'''
_READER = '''
extern "C" int band_probe_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, band::band_probe_clk,
                                   n * sizeof(long long));
}
'''


def probe_source(core):
    """``band_core.cuh`` with the probes added (raises if an anchor moved)."""
    for anchor, text in _PROBES:
        if core.count(anchor) != 1:
            raise ValueError(f"band_probe: anchor not found once: {anchor!r}")
        core = core.replace(anchor, text + anchor)
    if core.count(_PROBE_END) != 1:
        raise ValueError("band_probe: end-of-sweep anchor not found once")
    core = core.replace(_PROBE_END, _PROBE_END + (
        "  if (Grp::rank() == 0)\n    band_probe_clk[2 * probe_item<Grp>()"
        " + 1] = clock64() - probe_t0;\n"))
    head, tail = core.split("// One (chain, right-hand-side chunk)", 1)
    return head + _PROBE_DEFS + "\n// One (chain, right-hand-side chunk)" + tail


def device_ms(launch, reps):
    """Mean device milliseconds of one launch: the card sleeps while the
    host queues all ``reps`` launches behind the first event, so the
    events time the kernels back to back and not the host.  Raises if the
    host took longer to queue them than the shortest possible sleep."""
    import torch
    launch()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    h0 = time.perf_counter()
    t0.record()
    for _ in range(reps):
        launch()
    t1.record()
    host_ms = (time.perf_counter() - h0) * 1e3
    torch.cuda.synchronize()
    if host_ms >= SLEEP_CYCLES / 1.98e9 * 1e3:
        raise RuntimeError(f"queueing {reps} launches took {host_ms:.1f} ms: "
                           "the host was not ahead of the card")
    return t0.elapsed_time(t1) / reps


def _smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi failed"


def _build_probed(band_qr):
    """Compile the probed sources; returns {name: ctypes library}."""
    out_dir = band_qr.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for hdr in band_qr.HEADERS:     # the probes go into band_core.cuh
        text = hdr.read_text()
        (out_dir / hdr.name).write_text(
            probe_source(text) if hdr.name == "band_core.cuh" else text)
    procs = {}
    for name, src in band_qr.SOURCES.items():
        cu = out_dir / src.name
        cu.write_text(src.read_text() + _READER)
        so = out_dir / f"lib{name}_probe.so"
        procs[name] = (subprocess.Popen(
            [band_qr._nvcc(), *band_qr.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        _, log = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the probed {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        argtypes, fns = band_qr._ARGTYPES[name]
        for fn in fns:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the JSON lines here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("band_probe needs CUDA")
    from dompc_tpu_torch.solver import band_qr

    band_qr.build()
    plain_libs = {name: band_qr._load(name) for name in band_qr.SOURCES}
    probed = _build_probed(band_qr)
    card = _smi("name,power.limit")
    rows = []
    S, b, t = 21, 13, 12
    for kname, dname in (("band_qr", "float32"), ("band_qr", "float64"),
                         ("band_sweep_tiled", "float32")):
        dt = getattr(torch, dname)
        for N in (9, 9 * 128):
            rng = np.random.default_rng(N)
            D = rng.standard_normal((N, S, b, b)) + 3 * b * np.eye(b)
            U = 0.5 * rng.standard_normal((N, S - 1, b, b))
            Lo = 0.5 * rng.standard_normal((N, S - 1, b, b))
            rhs = rng.standard_normal((N, S, b, t))
            D, U, Lo, rhs = [torch.as_tensor(a, dtype=dt, device="cuda")
                             for a in (D, U, Lo, rhs)]
            launch, _ = band_qr.launcher(kname, D, U, Lo, rhs)
            ms = device_ms(launch, 30)
            band_qr._libs[kname] = probed[kname]
            try:
                plaunch, _ = band_qr.launcher(kname, D, U, Lo, rhs)
                probed_ms = device_ms(plaunch, 30)
                plaunch()
                torch.cuda.synchronize()
                clk = (ctypes.c_longlong * (2 * N))()
                if probed[kname].band_probe_read(clk, 2 * N) != 0:
                    raise RuntimeError("band_probe: reading the probes failed")
            finally:
                band_qr._libs[kname] = plain_libs[kname]
            cyc = np.array(clk[:], dtype=np.float64).reshape(N, 2)
            for _ in range(max(1, int(300 / ms))):    # ~0.3 s of launches
                launch()
            sm_clock = _smi("clocks.sm,clocks.max.sm,power.draw")
            torch.cuda.synchronize()
            row = dict(kernel=kname, dtype=dname, shape=[N, S, b, t],
                       device_ms=ms, probed_ms=probed_ms,
                       fwd_cycles_per_step=float(np.median(cyc[:, 0]))
                       / (S * b),
                       backsub_cycles=float(np.median(cyc[:, 1] - cyc[:, 0])),
                       total_cycles=float(np.median(cyc[:, 1])),
                       implied_ghz=float(cyc[:, 1].max()) / (probed_ms * 1e6),
                       sm_clock=sm_clock, card=card)
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)


if __name__ == "__main__":
    main()
