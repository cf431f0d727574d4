"""kernels_per_step: kernel launches on the card per Newton step in the
traced calls (memory copies and sets not counted): the dispatch count
that CUDA graphs or fusion would cut."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx.traced)
    if ctx.trace is None or not steps:
        return None
    n = len(ctx.trace.kernels())
    return n / steps if n else None
