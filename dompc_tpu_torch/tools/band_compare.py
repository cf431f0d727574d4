"""Time the chain sweep of this checkout against another checkout's, on one
card, at the shapes where the band kernels changed.

    python3 -m dompc_tpu_torch.tools.band_compare [--parent DIR] [--out F]
                                                  [--mhe | --tiled]

For each case of :data:`CASES` (the wide bands the main paths launch and
the flagship as a control), both checkouts' ``solver/band_qr.py`` solve the
same seeded chains with the kernel their ``band_solve`` launches; the
device time of one launch is measured in turns (parent, this, this,
parent) with launches queued while the card sleeps
(:func:`band_probe.device_ms`).  Each solution is held to the plain
version on a CPU copy.  One JSON line per case; ``--out`` also writes them
to a file.  ``DIR`` is an unpacked checkout (``git archive``): its kernels
build into ``DIR/build``.

With ``--tiled`` the kernel is ``band_sweep_tiled`` (float32) at the cases
of :data:`TILED_CASES` (``chip_smoke.py`` phase 3's float32 shapes, every
row bucket), timed the same way, with this checkout's ``band_solve``
kernel on the same inputs.

With ``--mhe`` it times instead the float64 ``tridiag`` MHE step of
``chip_smoke.py`` phase 10 (``mhe_run`` on ``mhe_measurements``), each
checkout's own, in a fresh process per turn with the kernels built
beforehand: one JSON line per turn, then the means.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..solver import band_qr
from ..solver.bbd import spike_shapes
from .band_probe import device_ms


# (name, shape, dtype, 1e22 diagonal): the rotating-masses MHE's bordered
# band (b=83, row bucket 97), row bucket 64, the polymerization's BBD
# chains at b=84 (t=24), the SPIKE segments and reduced system of a b=83
# chain of 48 stages, and the flagship (row bucket 13) as a control
SEG, RED = spike_shapes(83, 2)
CASES = [("mhe_rotating", (1, 11, 83, 2), "float32", False),
         ("mhe_rotating", (1, 11, 83, 2), "float64", False),
         ("mhe_rotating_1e22", (1, 11, 83, 2), "float32", True),
         ("bucket64", (1, 11, 50, 2), "float32", False),
         ("bucket64", (1, 11, 50, 2), "float64", False),
         ("poly_bbd_b84", (9, 21, 84, 24), "float64", False),
         ("mhe_spike_seg", SEG, "float64", False),
         ("mhe_spike_red", RED, "float64", False),
         ("flagship", (9, 21, 13, 12), "float32", False),
         ("flagship", (9, 21, 13, 12), "float64", False)]


# (name, shape, 1e22 diagonal): chip_smoke.py phase 3's float32 shapes
TILED_CASES = [("flagship", (9, 21, 13, 12), False),
               ("batch128", (9 * 128, 21, 13, 12), False),
               ("flagship_width_S101", (9, 101, 13, 12), False),
               ("diag_1e22", (9, 21, 13, 12), True),
               ("lv_root", (1, 26, 8, 1), False),
               ("kinematic_bicycle", (1, 11, 15, 1), False),
               ("kite", (1, 41, 13, 1), False),
               ("dip_chain", (1, 101, 23, 1), False),
               ("dip_spike_seg", (13, 7, 23, 47), False),
               ("dip_spike_red", (1, 12, 23, 1), False),
               ("lv_nodes", (8, 26, 32, 1), False),
               ("dynamic_bicycle", (1, 11, 21, 1), False),
               ("industrial_poly", (9, 21, 24, 24), False),
               ("bucket64", (1, 11, 50, 2), False),
               ("mhe_rotating", (1, 11, 83, 2), False),
               ("mhe_rotating_1e22", (1, 11, 83, 2), True)]


def band_case(N, S, b, t, seed, huge=False):
    """Diagonally dominant chains from a numpy seed (as chip_smoke.py's)."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((N, S, b, b)) + 3 * b * np.eye(b)
    U = 0.5 * rng.standard_normal((N, S - 1, b, b))
    Lo = 0.5 * rng.standard_normal((N, S - 1, b, b))
    rhs = rng.standard_normal((N, S, b, t))
    if huge:
        D[:, :, 0, 0] = 1e22
    return D, U, Lo, rhs


def load_module(checkout):
    """``solver/band_qr.py`` of another checkout, as its own module."""
    path = Path(checkout) / "dompc_tpu_torch" / "solver" / "band_qr.py"
    spec = importlib.util.spec_from_file_location("parent_band_qr", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_name(mod, b):
    return mod.qr_kernel(b) if hasattr(mod, "qr_kernel") else "band_qr"


# one turn of --mhe, run in the checkout (its chip_smoke.py and package)
MHE_CHILD = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from dompc_tpu_torch.solver import band_qr
band_qr.build()
ys = cs.on_cpu(cs.mhe_measurements)
run = cs.mhe_run(ys, "tridiag")
print("MHE_STEP " + json.dumps(dict(
    ms=[st["ms"] for st in run["steps"]],
    iters=[st["iters"] for st in run["steps"]],
    success=[st["success"] for st in run["steps"]],
    launches=run["launches"])))
"""


def mhe_turns(checkouts, card):
    """The tridiag MHE step of each checkout in turns (parent, this, this,
    parent): a list of rows."""
    order = ["parent", "this", "this", "parent"] if "parent" in checkouts \
        else ["this", "this"]
    env = dict(os.environ, DOMPC_TPU_X64="1")
    rows = []
    for who in order:
        out = subprocess.run([sys.executable, "-c", MHE_CHILD],
                             cwd=checkouts[who], env=env, capture_output=True,
                             text=True, timeout=600)
        line = next((ln for ln in out.stdout.splitlines()
                     if ln.startswith("MHE_STEP ")), None)
        if out.returncode or line is None:
            raise SystemExit(f"--mhe turn {who} failed:\n{out.stderr[-3000:]}")
        row = dict(json.loads(line[len("MHE_STEP "):]), turn=who, card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    means = {who: float(np.mean([r["ms"][0] for r in rows
                                 if r["turn"] == who]))
             for who in checkouts}
    print(json.dumps({"mhe_tridiag_step_ms_mean": means, "card": card}),
          flush=True)
    return rows + [{"mhe_tridiag_step_ms_mean": means, "card": card}]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--mhe", action="store_true")
    ap.add_argument("--tiled", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("band_compare needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.mhe:
        checkouts = {"this": str(Path(__file__).resolve().parents[2])}
        if args.parent:
            checkouts["parent"] = str(Path(args.parent).resolve())
        write_lines(args.out, mhe_turns(checkouts, card))
        return
    mods = {"this": band_qr}
    if args.parent:
        mods["parent"] = load_module(args.parent)
    for mod in mods.values():
        mod.build()
    cases = [(n, sh, "float32", h) for n, sh, h in TILED_CASES] \
        if args.tiled else CASES
    lines = []
    for seed, (name, shape, dname, huge) in enumerate(cases):
        dt = getattr(torch, dname)
        b, t = shape[2], shape[3]
        arrays = [torch.as_tensor(a, dtype=dt, device="cuda")
                  for a in band_case(*shape, seed, huge)]
        ref = band_qr.band_solve_qr_multi(*[a.cpu() for a in arrays])
        row = dict(case=name, shape=list(shape), dtype=dname, card=card)
        launches = {}
        variants = dict(mods)
        if args.tiled:
            variants["this_band_solve"] = band_qr
        for who, mod in variants.items():
            kname = kernel_name(mod, b) if not args.tiled \
                or who == "this_band_solve" else "band_sweep_tiled"
            launch, x = mod.launcher(kname, *arrays)
            launch()
            torch.cuda.synchronize()
            row[f"{who}_kernel"] = kname
            row[f"{who}_rel_err"] = float((x.cpu() - ref).abs().max()
                                          / ref.abs().max())
            first = device_ms(launch, 1)
            launches[who] = (launch, max(2, min(30, int(300 / first))))
            row[f"{who}_plan"] = (
                mod.tiled_plan(b, t) if kname == "band_sweep_tiled"
                else mod.qr_plan(b, t, dt))._asdict()
        order = ["parent", "this", "this", "parent"] if args.parent \
            else ["this", "this"]
        order += [who for who in variants if who.startswith("this_")] * 2
        times = {who: [] for who in variants}
        for who in order:
            launch, reps = launches[who]
            times[who].append(device_ms(launch, reps))
        for who, ts in times.items():
            row[f"{who}_ms"] = ts
        if args.parent:
            row["speedup"] = float(np.mean(times["parent"])
                                   / np.mean(times["this"]))
        if args.tiled:
            row["vs_band_solve"] = float(np.mean(times["this"]) / np.mean(
                times["this_band_solve"]))
        print(json.dumps(row), flush=True)
        lines.append(row)
        del launches
    write_lines(args.out, lines)


def write_lines(path, rows):
    """The rows as JSON lines to ``path`` (nothing when it is None)."""
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text("".join(json.dumps(r) + "\n" for r in rows))


if __name__ == "__main__":
    main()
