"""Carry a controller's numeric state across from the JAX package.

The parity tests build the JAX MPC and the port's MPC from the same
construction code (model constants and uncertainty values come along that way), then
start both solvers from the same numeric point with :func:`load_mpc_state`.
Only numpy arrays cross: this module imports nothing of JAX.
"""
import numpy as np

# scalings and bounds: the transcription is built from them at setup
STRUCT_KEYS = ("_x_scaling", "_u_scaling", "_z_scaling", "_x_lb", "_x_ub",
               "_u_lb", "_u_ub", "_z_lb", "_z_ub", "_x_terminal_lb",
               "_x_terminal_ub")
STATE_KEYS = ("opt_x_num", "opt_p_num", "_lam_warm", "_zl_warm",
              "_zu_warm", "_u0", "initial_run", "_t0") + STRUCT_KEYS


def mpc_state_arrays(mpc):
    """The numeric state of an MPC of either package, as numpy arrays under
    :data:`STATE_KEYS` (absent warm-start arrays are left out)."""
    out = {}
    for key in STATE_KEYS:
        if key == "initial_run":
            out[key] = bool(mpc.flags["initial_run"])
            continue
        val = getattr(mpc, key, None)
        if val is None:
            continue
        val = getattr(val, "data", val)      # NumStruct -> its flat vector
        out[key] = np.array(val, dtype=float)
    return out


def load_mpc_state(mpc, arrays):
    """Load numeric state (as produced by :func:`mpc_state_arrays` on a JAX
    MPC) into a set-up port MPC: decision vector, parameter vector, warm
    multipliers and bound duals, previous input, time, the initial-run
    flag, scalings and bounds.  Scalings or bounds that differ from the
    port MPC's own rebuild its transcription and solver.  Layouts must
    match (same model, same settings)."""
    assert mpc.flags["setup"], "set up the MPC before loading state"
    changed = False
    for key in STRUCT_KEYS:
        if key in arrays and not np.array_equal(getattr(mpc, key).data,
                                                arrays[key]):
            getattr(mpc, key).data[:] = arrays[key]
            changed = True
    if changed:
        mpc._prepare_nlp()
        mpc._create_solver()
    if arrays["opt_x_num"].shape != (mpc.n_opt_x,) or \
            arrays["opt_p_num"].shape != (mpc.n_opt_p,):
        raise ValueError("state does not match this MPC's layout")
    mpc._u0.data[:] = arrays["_u0"]
    for key in ("_lam_warm", "_zl_warm", "_zu_warm", "_t0"):
        if key in arrays:
            setattr(mpc, key, np.array(arrays[key], dtype=float))
    mpc.opt_x_num = np.array(arrays["opt_x_num"], dtype=float)
    mpc.opt_p_num = np.array(arrays["opt_p_num"], dtype=float)
    mpc.flags["initial_run"] = bool(arrays["initial_run"])
    mpc.flags["set_initial_guess"] = True
    return mpc
