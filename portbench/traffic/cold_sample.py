"""Traffic mode ``cold_sample``: every call solves its states cold, from
``initial_guess_from_x0``, as a sampling study or a fleet restart does.

Set-up makes one untimed call; each call of the window hands over the
pool in a fresh order (``StateStream.shuffled``)."""
from portbench.harness.traffic import summary


def setup(run):
    sol, _ = call(run, states(run))
    return {"cold": summary(sol)}


def states(run):
    return run.stream.shuffled()


def call(run, x0s):
    return run.prog.solve(x0s, run.prog.cold_guess(x0s))
