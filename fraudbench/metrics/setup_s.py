"""Seconds from the process's start to the window's: imports, the
stream, the weights, the engine's state, its kernels and CUDA graphs,
and the warm run."""


def read(ctx):
    return ctx["setup_s"]
