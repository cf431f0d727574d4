"""Traffic mode ``cold_sample_completed``: ``cold_sample`` for the
polymerization reactor, whose T_adiab is derived from the other states.
Each call draws the pool in a fresh order as ``cold_sample`` does, sets
every state's T_adiab from its (m_W, m_A, m_P, T_R)
(``portbench/reference/poly.py:complete_state``, as
examples/industrial_poly/main.py sets it) and solves the states cold, from
``initial_guess_from_x0``.

Set-up makes one untimed call."""
from portbench.harness.traffic import summary
from portbench.reference.poly import complete_state


def setup(run):
    sol, _ = call(run, states(run))
    return {"cold": summary(sol)}


def states(run):
    return complete_state(run.stream.shuffled())


def call(run, x0s):
    return run.prog.solve(x0s, run.prog.cold_guess(x0s))
