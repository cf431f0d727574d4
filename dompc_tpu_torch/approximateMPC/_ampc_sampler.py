"""Training-data generation for approximate MPC (PyTorch port of the JAX
package's ``approximateMPC/_ampc_sampler.py``).

Uniform box sampling of (x0, u_prev) from the MPC bounds (reference
``do_mpc/approximateMPC/_ampc_sampler.py:38-527``) and open-loop one-step
solves or closed-loop trajectories.  The open-loop path solves whole batches
with the batch-first solver (``parallel.make_batch_solver``): the
reference's sequential solver calls become a handful of calls on the
device.

As in the JAX package, ``u_prev`` is drawn for every sample but does not
reach the solves: the batch solver's parameter vector carries the MPC's own
``u0`` (``_assemble_opt_p``), so the open-loop data pairs (x0, u_prev) with
an input computed for u_prev = ``mpc._u0``.  ``sample_closed_loop`` feeds the
simulator's output ``y`` back as the next state.  Both differ from do-mpc
and are kept for parity with the JAX package.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ._ampcsettings import AMPCSamplerSettings
from ..sampling import SamplingPlanner
from ..simulator import Simulator


class AMPCSampler:
    def __init__(self, mpc, settings: AMPCSamplerSettings | None = None):
        self.mpc = mpc
        self.settings = settings or AMPCSamplerSettings()

    def default_sampling_plan(self, n_samples=None, seed=0, lbx=None,
                              ubx=None, lbu=None, ubu=None):
        """Uniform box sampling of x0 (and u_prev when the policy uses it),
        reference ``approx_mpc_sampling_plan_box`` (:236-283).  The box
        defaults to the MPC bounds and can be overridden (hard-constrained
        problems are often infeasible from box corners)."""
        st = self.settings
        n = n_samples or st.n_samples
        mpc = self.mpc
        rng = np.random.default_rng(seed)
        x_lb = mpc._x_lb.data if lbx is None else np.asarray(lbx, float)
        x_ub = mpc._x_ub.data if ubx is None else np.asarray(ubx, float)
        u_lb = mpc._u_lb.data if lbu is None else np.asarray(lbu, float)
        u_ub = mpc._u_ub.data if ubu is None else np.asarray(ubu, float)
        sp = SamplingPlanner(overwrite=st.overwrite_sampler)
        sp.data_dir = st.data_dir + "/"
        sp.set_sampling_var(
            "x0", lambda: rng.uniform(x_lb, x_ub))
        sp.set_sampling_var(
            "u_prev", lambda: rng.uniform(u_lb, u_ub))
        return sp.gen_sampling_plan(n)

    def sample_open_loop_batched(self, plan, batch_size=64, tol=1e-6,
                                 max_iter=60):
        """One-step MPC solves for the whole plan in batches on the MPC's
        device.  Returns (X, U_prev, U_opt, success) numpy arrays."""
        from ..parallel import make_batch_solver, initial_guess_from_x0

        mpc = self.mpc
        solve_batch = make_batch_solver(mpc, tol=tol, max_iter=max_iter)
        x0s = np.stack([np.asarray(c["x0"]).reshape(-1) for c in plan])
        u_prevs = np.stack([np.asarray(c["u_prev"]).reshape(-1)
                            for c in plan])
        w0s = initial_guess_from_x0(mpc, x0s)
        n = x0s.shape[0]
        U = np.zeros((n, mpc.model.n_u))
        OK = np.zeros(n, bool)
        for i0 in range(0, n, batch_size):
            sl = slice(i0, min(i0 + batch_size, n))
            sol, u0s = solve_batch(x0s[sl], w0s[sl])
            U[sl] = u0s.detach().to("cpu", torch.float64).numpy()
            OK[sl] = sol.success.cpu().numpy()
        return x0s, u_prevs, U, OK

    def sample_closed_loop(self, plan, simulator: Simulator,
                           trajectory_length=10):
        """Closed-loop trajectories per plan case (reference :387-526)."""
        mpc = self.mpc
        rows = []
        for case in plan:
            x0 = np.asarray(case["x0"], dtype=float).reshape(-1)
            mpc.reset_history() if hasattr(mpc, "reset_history") else None
            mpc.x0 = x0
            simulator.x0 = x0
            mpc.set_initial_guess()
            x = x0
            for _ in range(trajectory_length):
                u_prev = mpc._u0.data.copy()
                u0 = mpc.make_step(x)
                ok = mpc.solver_stats.get("success", False)
                rows.append((x.copy(), u_prev, u0.reshape(-1), ok))
                y = simulator.make_step(u0)
                x = np.asarray(y).reshape(-1)
        X = np.stack([r[0] for r in rows])
        U_prev = np.stack([r[1] for r in rows])
        U = np.stack([r[2] for r in rows])
        OK = np.array([r[3] for r in rows])
        return X, U_prev, U, OK

    def save_dataset(self, X, U_prev, U, OK, name=None):
        """Persist the full and feasible-only datasets
        (reference: data_*_all.pkl / data_*_opt.pkl, :362-382)."""
        st = self.settings
        os.makedirs(st.data_dir, exist_ok=True)
        name = name or st.dataset_name
        full = {"x0": X, "u_prev": U_prev, "u_opt": U, "success": OK}
        with open(os.path.join(st.data_dir, f"{name}_all.pkl"), "wb") as f:
            pickle.dump(full, f)
        opt = {k: v[OK] for k, v in full.items()}
        with open(os.path.join(st.data_dir, f"{name}_opt.pkl"), "wb") as f:
            pickle.dump(opt, f)
        return full, opt
