"""peak_mem_gib (GiB, the allocator's counter): the most device memory the
PyTorch allocator held during the window (``max_memory_allocated`` after a
reset that follows the warm-up), recorded steps for the check included."""


def read(ctx):
    if not ctx.outcome.window_peak:
        return None
    return ctx.outcome.window_peak / 2 ** 30
