"""newton_steps_per_call: the batch's Newton steps per call (the growth of
the solver's ``newton_steps`` counter), mean over the window."""


def read(ctx):
    return sum(c["steps"] for c in ctx.calls) / len(ctx.calls)
