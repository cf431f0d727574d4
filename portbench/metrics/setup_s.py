"""setup_s: process start to the first timed call (CUDA initialisation,
loading the band kernels from ``build/``, the MPC's set-up and the solves
the traffic needs before its window), host clock."""


def read(ctx):
    return ctx.setup_s
