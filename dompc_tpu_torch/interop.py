"""Carry numeric state across from the JAX package.

The parity tests build the JAX objects and the port's from the same
construction code (model constants and uncertainty values come along that
way), then start both from the same numeric point: an MPC's solver with
:func:`load_mpc_state`, an MHE's with :func:`load_mhe_state`, a Simulator
or an EKF with :func:`load_loop_state`.  An approximate-MPC policy's weights
cross as the JAX package's flax parameter tree of numpy arrays
(:func:`ampc_params_to_torch`, :func:`ampc_params_from_torch`), the layout
both packages pickle.
Only numpy arrays cross: this module imports nothing of JAX.
"""
import numpy as np
import torch

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
    if "_lam_warm" in arrays:   # a solve leaves its multipliers in both
        mpc.lam_g_num = mpc._lam_warm
    mpc.opt_x_num = np.array(arrays["opt_x_num"], dtype=float)
    mpc.opt_p_num = np.array(arrays["opt_p_num"], dtype=float)
    mpc.flags["initial_run"] = bool(arrays["initial_run"])
    mpc.flags["set_initial_guess"] = True
    return mpc


LOOP_KEYS = ("x0", "z0", "t0", "P0")


def loop_state_arrays(obj):
    """The numeric state of a ``Simulator`` or an ``EKF`` of either package
    (x0, z0, t0 and, for an EKF, P0) as numpy arrays under
    :data:`LOOP_KEYS`."""
    out = {}
    for key in LOOP_KEYS:
        val = getattr(obj, key, None)
        if val is not None:
            out[key] = np.array(getattr(val, "data", val), dtype=float)
    return out


def load_loop_state(obj, arrays):
    """Copy numeric state (as produced by :func:`loop_state_arrays`, or any
    subset of x0, z0, t0, P0 as numpy arrays) into a port ``Simulator`` or
    ``EKF``, so that it continues where the other package's object is.  A
    Simulator's next z guess follows z0."""
    for key in LOOP_KEYS:
        if key in arrays:
            setattr(obj, key, np.array(arrays[key], dtype=float))
    if "z0" in arrays and hasattr(obj, "_z_guess"):
        obj._z_guess = obj.z0.data.copy()
    return obj


MHE_KEYS = ("opt_x_num", "_lam_warm", "_zl_warm", "_zu_warm", "_x0",
            "_p_est0", "_u0", "_z0", "_t0", "initial_run", "_y")


def mhe_state_arrays(mhe):
    """The numeric state of an MHE of either package, as numpy arrays under
    :data:`MHE_KEYS`: the decision vector, the warm multipliers and bound
    duals (absent before the first solve), the arrival point x0 and
    p_est0, u0, z0, the time, the initial-run flag and the measurement
    history ``data._y`` that the default ``y_fun`` reads."""
    out = {"initial_run": bool(mhe.flags["initial_run"]),
           "_y": np.array(mhe.data._y, dtype=float)}
    for key in MHE_KEYS[:-2]:
        val = getattr(mhe, key, None)
        if val is not None:
            out[key] = np.array(getattr(val, "data", val), dtype=float)
    return out


def load_mhe_state(mhe, arrays):
    """Load numeric state (as produced by :func:`mhe_state_arrays` on a JAX
    MHE) into a set-up port MHE with the same layout, so that its next
    ``make_step`` starts where the other one's would."""
    assert mhe.flags["setup"], "set up the MHE before loading state"
    if arrays["opt_x_num"].shape != (mhe.n_opt_x,):
        raise ValueError("state does not match this MHE's layout")
    mhe.opt_x_num = np.array(arrays["opt_x_num"], dtype=float)
    for key in ("_lam_warm", "_zl_warm", "_zu_warm", "_t0"):
        if key in arrays:
            setattr(mhe, key, np.array(arrays[key], dtype=float))
    for key in ("_x0", "_p_est0", "_u0", "_z0"):
        getattr(mhe, key).data[:] = arrays[key]
    mhe.data._y = np.array(arrays["_y"], dtype=float)
    mhe.flags["initial_run"] = bool(arrays["initial_run"])
    mhe.flags["set_initial_guess"] = True
    return mhe


def ampc_params_to_torch(params_np):
    """A flax parameter tree of an approximate-MPC policy, ``{"params":
    {"Dense_i": {"kernel": (in, out), "bias": (out,)}}}`` (numpy or any
    array), as a ``state_dict`` of the port's ``FeedforwardNN`` (float32
    CPU tensors; ``layers.i.weight`` is the kernel transposed)."""
    dense = params_np["params"]
    state = {}
    for i in range(len(dense)):
        layer = dense[f"Dense_{i}"]
        state[f"layers.{i}.weight"] = torch.as_tensor(
            np.asarray(layer["kernel"], dtype=np.float32).T.copy())
        state[f"layers.{i}.bias"] = torch.as_tensor(
            np.asarray(layer["bias"], dtype=np.float32).copy())
    return state


def ampc_params_from_torch(net):
    """The port's ``FeedforwardNN`` weights as the JAX package's flax
    parameter tree of numpy arrays (the inverse of
    :func:`ampc_params_to_torch`)."""
    return {"params": {
        f"Dense_{i}": {
            "kernel": layer.weight.detach().cpu().numpy().T.copy(),
            "bias": layer.bias.detach().cpu().numpy().copy()}
        for i, layer in enumerate(net.layers)}}
