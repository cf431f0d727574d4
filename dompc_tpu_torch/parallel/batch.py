"""Batched and sharded NMPC solves (PyTorch port of the JAX package's
``parallel/batch.py``).

One batch-first interior-point solve serves a whole batch of (x0, w0)
problem instances of one MPC: every iteration evaluates the B instances'
derivatives together and sweeps all their KKT chains in one band-kernel
launch.  Each instance's result is the one it would get alone.

Across devices the idiom is torch's one process per device, joined into a
``torch.distributed`` process group (:func:`init_distributed`), where the
JAX package runs one process over a device mesh: :func:`make_sharded_solver`
gives each rank a contiguous block of the batch and gathers the results
on every rank.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .._config import resolve_device
from ..solver.ipm import IPMSettings, IPMSolution
from ..tools import _profiler as profiler


def initial_guess_from_x0(mpc, x0s):
    """Per-instance primal initial guess: broadcast each x0 into every state
    slot (the batched analogue of MPC.set_initial_guess).  numpy in, numpy
    out."""
    L = mpc.layout
    n = L.size
    xs = mpc._x_scaling.data
    map_x = -np.ones(n, int)
    for key in L.offsets:
        if key[0] == "x_node":
            map_x[L.sl(key)] = np.arange(mpc.model.n_x)
        elif key[0] == "x_coll":
            map_x[L.sl(key)] = np.tile(np.arange(mpc.model.n_x),
                                       mpc.n_total_coll_points)
    base = np.zeros(n)
    for key in L.offsets:
        if key[0] == "u":
            base[L.sl(key)] = mpc._u0.data / mpc._u_scaling.data
        elif key[0] == "z":
            nrep = L.sizes[key] // max(mpc.model.n_z, 1)
            base[L.sl(key)] = np.tile(
                mpc._z0.data / mpc._z_scaling.data, nrep)
    x0s = np.asarray(x0s, dtype=float)
    scaled = x0s / xs[None, :]
    w0s = np.tile(base, (x0s.shape[0], 1))
    mask = map_x >= 0
    w0s[:, mask] = scaled[:, map_x[mask]]
    return w0s


def make_batch_solver(mpc, tol=1e-6, max_iter=60, use_structured=True,
                      warm=True, throughput_mode=False, rti_iters=0,
                      chunk=None, **ipm_overrides):
    """Return ``solve_batch(x0s, w0s, lam0s=None, mu0=None, zl0s=None,
    zu0s=None) -> (sol, u0s)``: one batch-first solve over problem
    instances of the given (set-up) MPC, on its device and in its dtype.

    ``x0s``: (B, n_x) initial states; ``w0s``: (B, n_w_opt) primal initial
    guesses (e.g. :func:`initial_guess_from_x0`).  Returns the
    :class:`IPMSolution` with a leading batch axis and the per-instance
    first input u0 = w[u(0,0)] * scaling, (B, n_u).  Cold calls leave
    ``lam0s`` None; warm calls pass ``(lam0s, mu0, zl0s, zu0s)`` from a
    previous solution, ``mu0`` (scalar or (B,)) defaulting to the MPC's
    ``warm_start_mu``.

    ``throughput_mode`` drops the regularization ladder, the second-order
    correction, the polish and restoration, and takes one refinement pass
    in the float64 band solve (three otherwise) -- the JAX package's
    settings for large-batch moderate-tolerance solves.  ``chunk`` solves
    a batch as sequential sub-batches of ``chunk`` instances (B must be a
    multiple of it).  ``rti_iters > 0`` selects real-time iteration for
    warm calls (``lam0s`` given): exactly that many damped Newton steps,
    plus drift corrections with ``rti_drift_tol`` (the ``rti_*`` settings
    pass through ``ipm_overrides``); a cold call runs the genuine cold
    program, the full globalized loop.  ``warm`` is accepted for the JAX
    signature and unused there too.
    ``solve_batch.ipm`` is the underlying solver (its ``newton_steps``
    counts the batch's Newton steps).  A solving call (with ``chunk``, each
    sub-batch) runs in span ``batch.solve``; copying a host array or scalar
    onto the device is a host sync there (``sync.x0``, ``sync.w0``, ...).
    """
    st = mpc.settings
    if throughput_mode or rti_iters:
        kw = dict(tol=tol, max_iter=max_iter, reg_retries=0, use_soc=False,
                  do_polish=False, rti_iters=rti_iters, use_resto=False)
        kw.update(ipm_overrides)   # explicit overrides win
        ipm_settings = IPMSettings(**kw)
        n_refine = 1
    else:
        ipm_settings = IPMSettings(tol=tol, max_iter=max_iter,
                                   **ipm_overrides)
        n_refine = 3
    solve = mpc._make_solver(ipm_settings,
                             "condensed" if use_structured else "dense",
                             n_refine=n_refine)
    base_pvec = mpc._tensor(mpc._assemble_opt_p(np.zeros(mpc.model.n_x)))
    T_sync = mpc._to_device
    x0_sl = mpc._p_sl["x0"]
    u_sl = mpc.layout.sl(("u", 0, 0))
    u_scaling = mpc._tensor(mpc._u_scaling.data)

    def solve_batch(x0s, w0s, lam0s=None, mu0=None, zl0s=None, zu0s=None):
        B = x0s.shape[0]
        if chunk and B > chunk:
            assert B % chunk == 0, (
                f"batch {B} must be a multiple of chunk {chunk}")
            outs = []
            for i in range(0, B, chunk):
                sl = slice(i, i + chunk)
                outs.append(solve_batch(
                    x0s[sl], w0s[sl],
                    None if lam0s is None else lam0s[sl],
                    mu0 if (mu0 is None or np.ndim(mu0) == 0) else mu0[sl],
                    None if zl0s is None else zl0s[sl],
                    None if zu0s is None else zu0s[sl]))
            sols, u0s = zip(*outs)
            sol = IPMSolution(*(torch.cat(xs) for xs in zip(*sols)))
            return sol, torch.cat(u0s)
        with profiler.span("batch.solve"):
            pvec = base_pvec.expand(B, -1).clone()
            pvec[:, x0_sl] = T_sync("x0", x0s)
            if lam0s is None:
                # cold: the solver's own initialization (the JAX package
                # runs it through the warm program with the cold
                # multipliers, the same arithmetic, to save a compile)
                sol = solve(T_sync("w0", w0s), pvec)
            else:
                if mu0 is None:
                    mu0 = st.warm_start_mu
                if zl0s is None:
                    # zeros fall through init_state's z_init default per
                    # entry
                    zl0s = torch.zeros((B, solve.n_bound_duals))
                    zu0s = torch.zeros((B, solve.n_bound_duals))
                sol = solve(T_sync("w0", w0s), pvec, T_sync("lam0", lam0s),
                            T_sync("mu0", mu0), T_sync("zl0", zl0s),
                            T_sync("zu0", zu0s))
            return sol, sol.w[:, u_sl] * u_scaling

    solve_batch.ipm = solve
    return solve_batch


def make_shift_fn(mpc):
    """Receding-horizon warm-start shift for batched solutions.

    Returns ``shift(sol) -> (w, lam, zl, zu)`` advancing an IPMSolution by
    one stage along the nominal scenario branch (last stage duplicated),
    the acados-style RTI warm start.  Works on (B, ...) batches or single
    vectors (indexes the last axis)."""
    maps = mpc._build_shift_maps()

    def shift(sol):
        dev = sol.w.device
        iw, il, iz = (torch.as_tensor(maps[k], device=dev)
                      for k in ("w", "lam", "z"))
        return (sol.w[..., iw], sol.lam[..., il],
                sol.zl[..., iz], sol.zu[..., iz])

    return shift


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Join this process to the ``torch.distributed`` process group.

    Arguments default to the JAX package's environment variables
    (``COORDINATOR_ADDRESS`` as ``host:port``, ``NUM_PROCESSES``,
    ``PROCESS_ID``); without an address the call does nothing and returns
    False.  Otherwise the group is made over ``tcp://<address>`` with NCCL
    on the card and gloo when ``DOMPC_TPU_PLATFORM=cpu``; on the card the
    local device ``process_id % torch.cuda.device_count()`` is selected
    first, so that every MPC set up afterwards lives on it, and the group
    is bound to it (NCCL makes its communicator here, not inside the first
    solve).  One process per device, started by any launcher that sets the
    three variables (no ``torchrun`` needed).  Returns True."""
    coordinator_address = (coordinator_address
                           or os.environ.get("COORDINATOR_ADDRESS"))
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", 1))
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", 0))
    kw = {}
    if resolve_device().type == "cuda":
        local = process_id % torch.cuda.device_count()
        torch.cuda.set_device(local)
        backend = "nccl"
        kw["device_id"] = torch.device("cuda", local)
    else:
        backend = "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)
    return True


def batch_mesh(n_devices=None, axis_name="batch"):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over every rank of the
    process group, where the JAX package makes a ``Mesh`` over the first
    ``n_devices`` devices.  With one process per device, a mesh over fewer
    ranks would leave the others outside the collectives of
    :func:`make_sharded_solver`, so ``n_devices`` other than the world size
    raises ``ValueError``.  Every rank calls it; it needs
    :func:`init_distributed` first."""
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("batch_mesh needs a process group: call "
                           "init_distributed first")
    n = dist.get_world_size()
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"batch_mesh over {n_devices} ranks: the mesh "
                         f"spans the whole process group of {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, list(range(n)),
                      mesh_dim_names=(axis_name,))


def make_sharded_solver(mpc, mesh=None, tol=1e-6, max_iter=60,
                        axis_name="batch", use_structured=True,
                        throughput_mode=False, warm=False):
    """Shard the batch axis over the ranks of a 1-D mesh.

    Returns ``(solve, mesh)``.  Every rank passes the global batch,
    ``solve(x0s, w0s)``, or with ``warm=True`` ``solve(x0s, w0s, lam0s,
    mu0s, zl0s, zu0s)`` for receding-horizon warm starts (``mu0s`` a scalar
    or (B,)).  Each rank solves its contiguous block of B / size rows with
    its own :func:`make_batch_solver` on its device, and every rank returns
    the global ``(u0s (B, n_u), iterations (B,), n_ok)``: u0s and the
    iterations gathered over the mesh, ``n_ok`` the success count summed
    over it (the JAX package's ``psum``).  A batch the mesh size does not
    divide raises ``ValueError``.
    """
    if mesh is None:
        mesh = batch_mesh(axis_name=axis_name)
    group = mesh.get_group(axis_name)
    size = mesh.size()
    rank = mesh.get_local_rank(axis_name)
    solve_batch = make_batch_solver(mpc, tol=tol, max_iter=max_iter,
                                    use_structured=use_structured,
                                    throughput_mode=throughput_mode)

    def gather(local):
        parts = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(parts, local.contiguous(), group=group)
        return torch.cat(parts)

    n_args = 6 if warm else 2

    def solve(x0s, w0s, *warm_args):
        if 2 + len(warm_args) != n_args:
            raise TypeError(f"solve takes {n_args} arrays (warm={warm}), "
                            f"got {2 + len(warm_args)}")
        B = x0s.shape[0]
        if B % size:
            raise ValueError(f"batch {B} is not divisible by the mesh size "
                             f"{size}")
        k = B // size
        sl = slice(rank * k, (rank + 1) * k)
        rows = [a if a is None or np.ndim(a) == 0 else a[sl]
                for a in (x0s, w0s) + warm_args]
        sol, u0 = solve_batch(*rows)
        n_ok = sol.success.to(torch.float32).sum()
        dist.all_reduce(n_ok, op=dist.ReduceOp.SUM, group=group)
        return gather(u0), gather(sol.iterations), n_ok

    solve.solve_batch = solve_batch
    return solve, mesh
