"""oracle_replay_pct: the share of the port's point evaluations (spans
``oracle.point``) that replayed a captured CUDA graph (an ``oracle.replay``
span inside them), in percent, in the traced calls.
Counts spans inside the traced window only; 0 where no evaluation
replays, None without ``oracle.point`` spans."""


def read(ctx):
    if ctx.trace is None:
        return None
    w0, w1 = ctx.trace.window

    def count(name):
        return sum(1 for n, s, e in ctx.trace.ranges
                   if n == name and s >= w0 and e <= w1)
    points = count("oracle.point")
    return 100.0 * count("oracle.replay") / points if points else None
