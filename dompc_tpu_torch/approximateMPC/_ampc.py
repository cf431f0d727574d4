"""Neural surrogate of the MPC policy (PyTorch port of the JAX package's
``approximateMPC/_ampc.py``).

The MLP is a ``torch.nn.Module`` whose parameters are float32, as flax keeps
them; it computes in the dtype of its input, casting the weights at the call
(flax's ``promote_dtype``), so the same weights give the same policy as the
JAX package's in float64.  Input/output min-max scaling comes from the MPC
box bounds as in the reference (``set_shift_values`` ref :283-300, finite
bounds required ref :251-257), and ``make_step`` (ref :374-428) clips to the
input bounds.  The policy lives on the MPC's device and computes in its
dtype; ``approx.net.to(device)`` moves it.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ._ampcsettings import ApproximateMPCSettings
from ..interop import ampc_params_to_torch, ampc_params_from_torch

_ACTS = {"tanh": torch.tanh, "relu": torch.relu, "sigmoid": torch.sigmoid,
         "linear": lambda x: x}

# flax's default kernel init, lecun_normal: a normal truncated at two
# standard deviations, rescaled to unit variance (the constant is the
# standard deviation of the unit normal truncated to [-2, 2])
_TRUNC_STD = 0.87962566103423978


class FeedforwardNN(nn.Module):
    """MLP policy network (reference FeedforwardNN, _ampc.py:32-111):
    ``n_hidden_layers`` dense layers with ``act_fn``, then a dense output
    layer with ``output_act_fn``.  Parameters are float32; the weights are
    drawn as flax's defaults (lecun-normal kernels, zero biases) from a
    CPU generator seeded with ``seed``."""

    def __init__(self, n_in, n_out, n_hidden_layers=3, n_neurons=50,
                 act_fn="tanh", output_act_fn="linear", seed=0):
        super().__init__()
        self.act_fn, self.output_act_fn = act_fn, output_act_fn
        widths = [n_in] + [n_neurons] * n_hidden_layers + [n_out]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, dtype=torch.float32)
            for a, b in zip(widths[:-1], widths[1:]))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in self.layers:
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=gen)
                layer.bias.zero_()

    def forward(self, x):
        act, last = _ACTS[self.act_fn], len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))
            x = act(x) if i < last else _ACTS[self.output_act_fn](x)
        return x


class ApproxMPC:
    """Approximate MPC policy u = pi(x0[, u_prev]) (reference :32)."""

    def __init__(self, mpc, settings: ApproximateMPCSettings | None = None):
        self.mpc = mpc
        self.settings = settings or ApproximateMPCSettings()
        model = mpc.model
        self.n_x = model.n_x
        self.n_u = model.n_u
        # input includes u_prev when an rterm was set (reference :219-234)
        self.use_u_prev = bool(np.any(mpc.rterm_factor.data != 0)) \
            or mpc._rterm_fun_sym is not None
        self.n_in = self.n_x + (self.n_u if self.use_u_prev else 0)
        self.n_out = self.n_u
        self.dtype = mpc._dtype
        self.net = FeedforwardNN(
            n_in=self.n_in, n_out=self.n_out,
            n_hidden_layers=self.settings.n_hidden_layers,
            n_neurons=self.settings.n_neurons,
            act_fn=self.settings.act_fn,
            output_act_fn=self.settings.output_act_fn).to(mpc._device)
        self.set_shift_values()

    @property
    def device(self):
        """The device the policy's weights are on."""
        return self.net.layers[0].weight.device

    @property
    def params(self):
        """The weights as the JAX package's flax parameter tree of numpy
        arrays; assigning such a tree loads it."""
        return ampc_params_from_torch(self.net)

    @params.setter
    def params(self, params_np):
        self.net.load_state_dict(ampc_params_to_torch(params_np))

    # ------------------------------------------------------------- scaling
    def set_shift_values(self):
        """Min-max input/output scaling from the MPC box bounds
        (reference :283-300)."""
        mpc = self.mpc
        x_lb, x_ub = mpc._x_lb.data, mpc._x_ub.data
        u_lb, u_ub = mpc._u_lb.data, mpc._u_ub.data
        assert np.all(np.isfinite(x_lb)) and np.all(np.isfinite(x_ub)), \
            "ApproxMPC requires finite state bounds for scaling."
        assert np.all(np.isfinite(u_lb)) and np.all(np.isfinite(u_ub)), \
            "ApproxMPC requires finite input bounds for scaling."
        in_lb = np.concatenate([x_lb, u_lb]) if self.use_u_prev else x_lb
        in_ub = np.concatenate([x_ub, u_ub]) if self.use_u_prev else x_ub
        self.in_shift = in_lb
        self.in_range = np.where(in_ub > in_lb, in_ub - in_lb, 1.0)
        self.out_shift = u_lb
        self.out_range = np.where(u_ub > u_lb, u_ub - u_lb, 1.0)
        self.u_lb, self.u_ub = u_lb, u_ub

    def scale_inputs(self, x):
        return (x - self.in_shift) / self.in_range

    def rescale_outputs(self, y):
        return y * self.out_range + self.out_shift

    # ------------------------------------------------------------- runtime
    def __call__(self, params, x_scaled):
        """The network with the weights ``params`` (a flax parameter tree)
        on scaled inputs (a tensor of the policy's device)."""
        return torch.func.functional_call(
            self.net, {k: v.to(self.device)
                       for k, v in ampc_params_to_torch(params).items()},
            (x_scaled,))

    def make_step(self, x0, u_prev=None, clip_to_bounds=True):
        """Evaluate the learned policy (reference :374-428)."""
        x0 = np.asarray(x0, dtype=float).reshape(-1)
        if self.use_u_prev:
            assert u_prev is not None, "policy input includes u_prev"
            u_prev = np.asarray(u_prev, dtype=float).reshape(-1)
            inp = np.concatenate([x0, u_prev])
        else:
            inp = x0
        xin = torch.as_tensor(self.scale_inputs(inp)[None, :],
                              dtype=self.dtype, device=self.device)
        with torch.no_grad():
            y = self.net(xin)[0].to("cpu", torch.float64).numpy()
        u0 = self.rescale_outputs(y)
        if clip_to_bounds:
            u0 = np.clip(u0, self.u_lb, self.u_ub)
        return u0.reshape(-1, 1)

    # ------------------------------------------------------------ storage
    def save_to_state_dict(self, path="approx_mpc.pkl"):
        """Pickle the weights in the JAX package's layout (a flax parameter
        tree of numpy arrays), so that either package loads them."""
        with open(path, "wb") as f:
            pickle.dump(self.params, f)

    def load_from_state_dict(self, path="approx_mpc.pkl"):
        with open(path, "rb") as f:
            self.params = pickle.load(f)
