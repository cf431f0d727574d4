"""prepare_replay_pct: the share of the port's instance Hessian
evaluations (spans ``oracle.hessian`` inside ``kkt.prepare``) that replayed
a captured CUDA graph (a ``kkt.replay`` span inside them), in percent, in
the traced calls.
Counts spans inside the traced window only; 0 where no Hessian replays,
None without ``oracle.hessian`` spans."""


def read(ctx):
    if ctx.trace is None:
        return None
    w0, w1 = ctx.trace.window
    spans = [(n, s, e) for n, s, e in ctx.trace.ranges
             if s >= w0 and e <= w1]
    replays = [(s, e) for n, s, e in spans if n == "kkt.replay"]
    hessians = [(s, e) for n, s, e in spans if n == "oracle.hessian"]
    if not hessians:
        return None
    held = sum(1 for s, e in hessians
               if any(s <= rs and re <= e for rs, re in replays))
    return 100.0 * held / len(hessians)
