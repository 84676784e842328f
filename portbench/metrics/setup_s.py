"""setup_s (s, host clock): from the start of the process to the opening of
the window: imports, the kernels' build on a checkout's first run, the
seeded weights, the model, and the warm-up segment."""


def read(ctx):
    return ctx.outcome.setup_s
