"""Tic/toc timer (reference: do_mpc/tools/_timer.py:6-61)."""
import time
import numpy as np


class Timer:
    def __init__(self, name="timer"):
        self.name = name
        self.times = []
        self._t0 = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self):
        assert self._t0 is not None, "call tic() first"
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def info(self):
        t = np.asarray(self.times)
        if t.size == 0:
            print(f"{self.name}: no measurements")
            return
        print(f"{self.name}: n={t.size} total={t.sum():.4g}s "
              f"mean={t.mean():.4g}s min={t.min():.4g}s max={t.max():.4g}s")

    def hist(self, bins=10):
        try:
            import matplotlib.pyplot as plt
        except ImportError:  # pragma: no cover
            return None
        fig, ax = plt.subplots()
        ax.hist(self.times, bins=bins)
        ax.set_xlabel("time [s]")
        ax.set_ylabel("count")
        return fig
