"""Traffic mode ``warm_fleet``: a parked fleet of plants answered every
period, each period warm-started from the last period's answer.

Set-up solves the whole fleet cold (the warm start the traffic needs) and
makes one untimed warm period.  Each call of the window hands over the
fleet's states moved about their base (``StateStream.period``) with the
last answer's (w, lam, zl, zu) and the traffic's ``mu0``."""
from portbench.harness.traffic import summary


def setup(run):
    base = run.stream.fleet()
    sol, _ = run.prog.solve(base, run.prog.cold_guess(base))
    info = {"cold": summary(sol)}
    run.state = sol
    sol, _ = call(run, run.stream.period())
    info["warm"] = summary(sol)
    return info


def states(run):
    return run.stream.period()


def call(run, x0s):
    s = run.state
    sol, u0 = run.prog.solve(x0s, s.w, s.lam, float(run.traffic["mu0"]),
                             s.zl, s.zu)
    run.state = sol
    return sol, u0
