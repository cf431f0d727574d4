"""Supervised training of the ApproxMPC policy (PyTorch port of the JAX
package's ``approximateMPC/_trainer.py``).

Adam + MSE with a train/validation split, shuffling and plateau learning-rate
scheduling (reference ``do_mpc/approximateMPC/_trainer.py:38-506``), on the
policy's device and in its dtype.  With ``TrainerSettings.data_parallel``
and a ``torch.distributed`` process group of more than one rank
(``parallel.init_distributed``), every batch is split over the ranks and
the gradients are summed with ``all_reduce``, the torch counterpart of the
JAX package's batch sharding over a device mesh.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ._ampcsettings import TrainerSettings


class Trainer:
    def __init__(self, approx_mpc, settings: TrainerSettings | None = None):
        self.approx_mpc = approx_mpc
        self.settings = settings or TrainerSettings()
        self.history = {"train_loss": [], "val_loss": [], "lr": [],
                        "update_norm": []}

    def default_training(self, X, U, U_prev=None, seed=0):
        """Train on (x0[, u_prev]) -> u_opt pairs; returns history."""
        st = self.settings
        am = self.approx_mpc
        if am.use_u_prev:
            assert U_prev is not None
            inputs = np.concatenate([X, U_prev], axis=1)
        else:
            inputs = X
        Xs = am.scale_inputs(inputs)
        Ys = (U - am.out_shift) / am.out_range

        n = Xs.shape[0]
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        n_train = int(st.train_split * n)
        tr, va = perm[:n_train], perm[n_train:]
        dev = am.device

        def T(a):
            return torch.as_tensor(a, dtype=am.dtype, device=dev)

        Xtr, Ytr = T(Xs[tr]), T(Ys[tr])
        Xva, Yva = T(Xs[va]), T(Ys[va])

        net = am.net
        params = list(net.parameters())
        # optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)
        opt = torch.optim.Adam(params, lr=st.learning_rate, eps=1e-8)

        def loss_fn(xb, yb):
            return torch.mean((net(xb) - yb) ** 2)

        # Data parallel: every rank holds the same data, seed and weights,
        # so the shuffles agree (the JAX package's single controller); each
        # takes its contiguous slice of a batch, and the all-reduced sum of
        # the slices' mean-loss gradients over the world size is the whole
        # batch's.  Adam then takes the same step on every rank.
        world = (dist.get_world_size() if st.data_parallel
                 and dist.is_available() and dist.is_initialized() else 1)
        self._world_size = world
        rank = dist.get_rank() if world > 1 else 0
        warned_unsharded = False

        def step_loss(xb, yb):
            """Backward of this rank's share of a batch; the batch's loss."""
            nonlocal warned_unsharded
            n_b = xb.shape[0]
            if world == 1 or n_b % world:
                if world > 1 and not warned_unsharded:
                    warned_unsharded = True
                    warnings.warn(
                        f"data_parallel=True but batch size {n_b} is not "
                        f"divisible by the world size {world}; this (and "
                        "any further such) batch runs unsharded. Choose "
                        "batch_size as a multiple of the world size.")
                loss = loss_fn(xb, yb)
                loss.backward()
                return loss.detach()
            k = n_b // world
            sl = slice(rank * k, (rank + 1) * k)
            loss = loss_fn(xb[sl], yb[sl])
            loss.backward()
            flat = torch.cat([p.grad.reshape(-1) for p in params]
                             + [loss.detach().reshape(1)])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            flat /= world
            i = 0
            for p in params:
                p.grad.copy_(flat[i:i + p.numel()].view_as(p))
                i += p.numel()
            return flat[-1]

        best_val = np.inf
        patience = 0
        lr_mult = 1.0
        bs = st.batch_size
        steps_per_epoch = max(1, len(tr) // bs)
        for epoch in range(st.n_epochs):
            if st.shuffle:
                order = torch.as_tensor(rng.permutation(len(tr)), device=dev)
                Xtr, Ytr = Xtr[order], Ytr[order]
            # plateau scheduling scales the post-Adam update: Adam's step
            # is invariant to uniform gradient scaling, and scaling the
            # update is exactly learning-rate scaling
            for group in opt.param_groups:
                group["lr"] = st.learning_rate * lr_mult
            ep_loss = 0.0
            ep_norm = 0.0
            for i in range(steps_per_epoch):
                xb = Xtr[i * bs:(i + 1) * bs]
                yb = Ytr[i * bs:(i + 1) * bs]
                before = [p.detach().clone() for p in params]
                opt.zero_grad(set_to_none=True)
                loss = step_loss(xb, yb)
                opt.step()
                # the global norm of this step's parameter change
                upd_norm = torch.sqrt(sum(
                    ((p.detach() - b) ** 2).sum()
                    for p, b in zip(params, before)))
                loss_h, norm_h = torch.stack(
                    [loss.double(), upd_norm.double()]).tolist()
                ep_loss += loss_h
                ep_norm += norm_h
            ep_loss /= steps_per_epoch
            ep_norm /= steps_per_epoch
            if len(va):
                with torch.no_grad():
                    val = float(loss_fn(Xva, Yva))
            else:
                val = ep_loss
            self.history["train_loss"].append(ep_loss)
            self.history["val_loss"].append(val)
            self.history["lr"].append(lr_mult * st.learning_rate)
            self.history["update_norm"].append(ep_norm)
            if st.scheduler_flag:
                if val < best_val - 1e-12:
                    best_val = val
                    patience = 0
                else:
                    patience += 1
                    if patience >= st.scheduler_patience:
                        lr_mult *= st.scheduler_factor
                        patience = 0
            if st.print_frequency and epoch % st.print_frequency == 0:
                print(f"epoch {epoch}: train {ep_loss:.3e} val {val:.3e}")
        if st.save_history:
            os.makedirs(st.results_dir, exist_ok=True)
            np.savez(os.path.join(st.results_dir, "history.npz"),
                     **{k: np.asarray(v) for k, v in self.history.items()})
        return self.history

    def plot_history(self, save_fig=False, fig_name="training_history.png"):
        """Loss/LR curves over epochs (reference:
        do_mpc/approximateMPC/_trainer.py:295-382, ``visualize_training``).

        Returns (fig, ax) so callers can restyle; with ``save_fig`` the
        figure is written to ``settings.results_dir``."""
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(2, 1, sharex=True, figsize=(7, 5))
        epochs = np.arange(len(self.history["train_loss"]))
        ax[0].semilogy(epochs, self.history["train_loss"],
                       label="train loss")
        if any(v is not None for v in self.history["val_loss"]):
            ax[0].semilogy(epochs, self.history["val_loss"],
                           label="val loss")
        ax[0].set_ylabel("MSE loss")
        ax[0].legend()
        ax[1].semilogy(epochs, self.history["lr"], label="learning rate")
        ax[1].set_ylabel("learning rate")
        ax[1].set_xlabel("epoch")
        ax[1].legend()
        fig.tight_layout()
        if save_fig:
            os.makedirs(self.settings.results_dir, exist_ok=True)
            fig.savefig(os.path.join(self.settings.results_dir, fig_name))
        return fig, ax
