"""setup_s: seconds from the start of the run to the window: imports,
kernels built or loaded, inputs made, staged and warmed (host clock)."""


def read(f):
    return f.setup_s
