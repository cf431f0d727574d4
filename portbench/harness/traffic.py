"""The one traffic generator: plant states for every call of a cell, drawn
by the parameters of the cell's traffic file.

A traffic file (``portbench/traffic/<name>.json``) holds:

* ``mode``: the name of the traffic mode, ``portbench/traffic/<mode>.py``,
  which says what a call does with the states (:mod:`portbench.harness.registry`);
* ``batch``: the instances per call;
* ``pool_seed``: the plants' states are drawn once from this fixed seed,
  the same for every run; the run's seed orders them and draws the moves,
  so every run does the same work in another order;
* ``state``: the spread of the pool around the configuration's
  ``x_nominal``: ``rel_sigma`` (a number or one per state) and
  ``clip_lo``/``clip_hi`` (one bound per state, or null for none);
* ``move_rel_sigma``: a fleet's period moves every base state by
  ``x_k = base * (1 + move_rel_sigma * eps_k)``, eps_k fresh N(0, 1),
  clipped again;
* ``mu0``: the barrier parameter of warm calls (where the mode warm-starts);
* ``trace_calls``: calls under the profiler in a ``--trace 1`` run;
* ``check_calls``: calls of the window whose answers the reference judges.

Every draw of a run comes from one ``numpy`` generator seeded with the
run's seed, in a fixed order: the same seed gives the same states.
"""
from __future__ import annotations

import numpy as np


def _vec(v, n, default):
    return np.broadcast_to(np.asarray(default if v is None else v,
                                      dtype=float), (n,)).copy()


def summary(sol):
    """What a set-up solve found, for the run's log line."""
    return dict(certified=int(sol.success.sum()),
                iterations_mean=float(sol.iterations.float().mean()))


class StateStream:
    """Seeded plant states of one run."""

    def __init__(self, traffic, x_nominal, seed):
        st = traffic["state"]
        nominal = np.asarray(x_nominal, dtype=float)
        n = nominal.size
        self.lo = _vec(st.get("clip_lo"), n, -np.inf)
        self.hi = _vec(st.get("clip_hi"), n, np.inf)
        z = np.random.default_rng(int(traffic["pool_seed"])).standard_normal(
            (int(traffic["batch"]), n))
        rel = _vec(st.get("rel_sigma", 0.0), n, 0.0)
        self.pool = np.clip(nominal * (1.0 + rel * z), self.lo, self.hi)
        self.move = float(traffic.get("move_rel_sigma", 0.0))
        self.rng = np.random.default_rng(int(seed))
        self.base = None

    def shuffled(self):
        """The pool in an order drawn from the run's seed."""
        return self.pool[self.rng.permutation(len(self.pool))]

    def fleet(self):
        """The fleet's base states: the pool, in the run's order."""
        self.base = self.shuffled()
        return self.base

    def period(self):
        """The next period's states of the fleet."""
        eps = self.rng.standard_normal(self.base.shape)
        return np.clip(self.base * (1.0 + self.move * eps), self.lo, self.hi)
