"""Approximate-MPC sampling of the CSTR example in either package and dtype.

The flagship robust CSTR with T_R's upper bound 140 set after setup and set
up again (examples/CSTR_approximate_mpc/main.py:34-35), the example's state
box and seed, one batched call of the sampler's solver (tol 1e-4, 60
iterations) over the first N states, on the CPU.  Prints, per state,
whether it certified, its iterations, its KKT error and its first input, so
that the two packages can be compared in float32 and in float64:

    python scripts/ampc_dtype_parity.py jax32 16
    python scripts/ampc_dtype_parity.py port32 16

(``jax64`` / ``port64`` for float64).  Each run imports one package only.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LBX, UBX = [0.2, 0.2, 100.0, 100.0], [1.8, 1.8, 138.0, 138.0]


def main(which, n):
    if which.startswith("port"):
        os.environ["DOMPC_TPU_PLATFORM"] = "cpu"
        if which == "port64":
            os.environ["DOMPC_TPU_X64"] = "1"
        import torch
        torch.set_num_threads(2)
        from dompc_tpu_torch.systems import cstr_robust_mpc as build
        from dompc_tpu_torch.approximateMPC import (AMPCSampler,
                                                    AMPCSamplerSettings)
        from dompc_tpu_torch.parallel import (make_batch_solver,
                                              initial_guess_from_x0)
    elif which.startswith("jax"):
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", which == "jax64")
        from __graft_entry__ import _build_cstr_mpc as build
        from dompc_tpu.approximateMPC import AMPCSampler, AMPCSamplerSettings
        from dompc_tpu.parallel import (make_batch_solver,
                                        initial_guess_from_x0)
    else:
        raise SystemExit(f"unknown mode {which!r}: jax32, jax64, port32 "
                         "or port64")
    mpc = build(n_horizon=20)
    mpc.bounds["upper", "_x", "T_R"] = 140.0
    mpc.setup()
    sampler = AMPCSampler(mpc, AMPCSamplerSettings(n_samples=1024))
    plan = sampler.default_sampling_plan(seed=0, lbx=LBX, ubx=UBX)[:n]
    solve = make_batch_solver(mpc, tol=1e-4, max_iter=60)
    x0s = np.stack([c["x0"] for c in plan])
    t0 = time.perf_counter()
    sol, u0 = solve(x0s, initial_guess_from_x0(mpc, x0s))

    def host(a):
        a = a.detach().cpu().double().numpy() if hasattr(a, "detach") else a
        return np.asarray(a, dtype=float)

    print(json.dumps(dict(
        mode=which, states=n, s=time.perf_counter() - t0,
        certified=host(sol.success).astype(int).tolist(),
        iterations=host(sol.iterations).astype(int).tolist(),
        kkt_err=host(sol.kkt_err).tolist(), F=host(u0)[:, 0].tolist())))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 16)
