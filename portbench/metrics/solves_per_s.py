"""solves_per_s: certified solves of every call in the window over the
window's wall time, from the first call's start to the last call's end
(host clock).  An uncertified, non-finite or out-of-bounds instance does
not count."""


def read(ctx):
    return sum(c["certified"] for c in ctx.calls) / ctx.window_s
