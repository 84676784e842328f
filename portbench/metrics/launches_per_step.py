"""launches_per_step (launches/step, device trace): the host's kernel and
graph launch calls in the traced segments (``cudaLaunchKernel*``,
``cuLaunchKernel*``, ``cudaGraphLaunch``), over their guided steps (a
fleet's step is one batched step). The ctypes launches of the port's own
kernels are runtime calls too, and are counted with the rest."""


def read(ctx):
    if ctx.trace is None or not ctx.outcome.trace_steps:
        return None
    return ctx.trace.launches / ctx.outcome.trace_steps
