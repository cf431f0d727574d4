"""Matplotlib result/prediction monitor (reference:
do_mpc/graphics.py:40-511), over the port's ``data.MPCData`` / ``Data``.
matplotlib is imported by the functions that draw, never at import."""
from __future__ import annotations

import numpy as np

from .tools import Structure


class Graphics:
    """Line-based monitor over a :class:`~dompc_tpu_torch.data.Data` object."""

    def __init__(self, data):
        self.data = data
        self.line_list: list[dict] = []
        self.pred_lines = Structure()
        self.result_lines = Structure()

    def add_line(self, var_type, var_name, axis, **pltkwargs):
        """Register a line for variable (var_type, var_name) on the given
        matplotlib axis (reference :242)."""
        assert var_type in ("_x", "_u", "_z", "_tvp", "_p", "_aux",
                            "_time", "_y")
        self.line_list.append({
            "var_type": var_type, "var_name": var_name, "axis": axis,
            "kwargs": pltkwargs, "result_handles": [], "pred_handles": [],
        })

    def reset_axes(self):
        for line in self.line_list:
            line["axis"].relim()
            line["axis"].autoscale_view()

    def reset_prop_cycle(self):
        for line in self.line_list:
            line["axis"].set_prop_cycle(None)

    def clear(self, lines=None):
        for line in self.line_list:
            for h in line["result_handles"] + line["pred_handles"]:
                h.remove()
            line["result_handles"] = []
            line["pred_handles"] = []

    def plot_results(self, t_ind=None):
        """Plot logged trajectories up to t_ind (reference :289); inputs
        are drawn as zero-order-hold steps like the reference."""
        t = self.data._time[:t_ind].reshape(-1) if t_ind is not None \
            else self.data._time.reshape(-1)
        for line in self.line_list:
            vt, vn = line["var_type"], line["var_name"]
            arr = self.data[vt, vn] if vn else self.data[vt]
            arr = arr[:len(t)]
            self.clear_line(line, "result_handles")
            kwargs = dict(line["kwargs"])
            if vt == "_u":
                kwargs.setdefault("drawstyle", "steps-post")
            handles = line["axis"].plot(t, arr, **kwargs)
            line["result_handles"] = list(handles)
            # finest-key storage: (vt, vn, element) -> [handle]; any
            # prefix (e.g. just (vt, vn) or (vt,)) queries the flattened
            # union (reference result_lines power indexing)
            for i, h in enumerate(handles):
                self.result_lines[(vt, vn, i)] = [h]

    def clear_line(self, line, key):
        for h in line[key]:
            h.remove()
        line[key] = []

    def plot_predictions(self, t_ind=-1):
        """Plot the stored prediction trajectories at step t_ind — requires
        ``store_full_solution=True`` (reference :312)."""
        layout = getattr(self.data, "_pred_layout", None)
        assert layout is not None, (
            "plot_predictions requires store_full_solution=True")
        t_ind = int(t_ind) if t_ind != -1 else self.data._time.shape[0] - 1
        t0 = float(self.data._time[t_ind, 0])
        t_step = self.data.meta_data.get("t_step", 1.0)
        for line in self.line_list:
            vt, vn = line["var_type"], line["var_name"]
            if vt not in ("_x", "_u", "_z", "_aux"):
                continue
            if vt == "_aux":
                traj = layout.extract_aux(
                    self.data._opt_aux_num[t_ind], vn)
            else:
                opt_x_num = self.data._opt_x_num[t_ind]
                traj = layout.extract(opt_x_num, vt, vn)  # (n_el, T, nsc)
            n_el, T, n_scen = traj.shape
            tgrid = t0 + t_step * np.arange(T)
            self.clear_line(line, "pred_handles")
            # every scenario branch of element i inherits the color of
            # element i's result line (reference graphics.py:312-349: the
            # robust-MPC fan is color-matched to the measured trajectory)
            result_handles = line["result_handles"]
            handles = []
            kwargs = dict(line["kwargs"])
            step_style = {"drawstyle": "steps-post"} if vt == "_u" else {}
            for i in range(n_el):
                color = (result_handles[i].get_color()
                         if i < len(result_handles) else None)
                for s in range(n_scen):
                    hs = line["axis"].plot(
                        tgrid, traj[i, :, s], "--",
                        **({"color": color} if color else {}),
                        **step_style, **kwargs)
                    handles += list(hs)
                    # (vt, vn, element, scenario) -> handles; prefixes
                    # query flattened unions (reference pred_lines)
                    self.pred_lines[(vt, vn, i, s)] = list(hs)
            line["pred_handles"] = handles


def default_plot(data, states_list=None, dense_states_list=None,
                 inputs_list=None, aux_list=None, **kwargs):
    """Auto-generated figure with one axis per variable (reference :350)."""
    import matplotlib.pyplot as plt

    specs = data._specs
    states_list = states_list if states_list is not None \
        else specs["_x"].names
    inputs_list = inputs_list if inputs_list is not None \
        else specs["_u"].names
    aux_list = aux_list if aux_list is not None else specs["_aux"].names
    n_ax = len(states_list) + len(inputs_list) + len(aux_list)
    fig, axes = plt.subplots(max(n_ax, 1), sharex=True, **kwargs)
    axes = np.atleast_1d(axes)
    g = Graphics(data)
    i = 0
    for name in states_list:
        g.add_line("_x", name, axes[i])
        axes[i].set_ylabel(name)
        i += 1
    for name in inputs_list:
        g.add_line("_u", name, axes[i])
        axes[i].set_ylabel(name)
        i += 1
    for name in aux_list:
        g.add_line("_aux", name, axes[i])
        axes[i].set_ylabel(name)
        i += 1
    axes[-1].set_xlabel("time")
    g.plot_results()
    return fig, axes, g


def animate(graphics, fig, n_steps=None, export_path="./", export_name="anim",
            overwrite=False, format="gif", fps=5, writer=None):
    """Closed-loop animation exported as gif/mp4 (reference :447)."""
    from matplotlib.animation import FuncAnimation, ImageMagickWriter, \
        FFMpegWriter

    if n_steps is None:
        n_steps = graphics.data._time.shape[0]

    def update(t_ind):
        graphics.plot_results(t_ind=t_ind + 1)
        if getattr(graphics.data, "_pred_layout", None) is not None:
            graphics.plot_predictions(t_ind=t_ind)
        graphics.reset_axes()

    anim = FuncAnimation(fig, update, frames=n_steps)
    if writer is None:
        if format == "gif":
            writer = ImageMagickWriter(fps=fps)
        else:
            writer = FFMpegWriter(fps=fps)
    import os
    path = os.path.join(export_path, f"{export_name}.{format}")
    try:
        anim.save(path, writer=writer)
    except Exception:  # imagemagick/ffmpeg may be absent; fall back
        anim.save(path.replace(f".{format}", ".html"), writer="html")
    return anim
