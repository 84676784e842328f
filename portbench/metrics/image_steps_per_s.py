"""image_steps_per_s (image-steps/s, host clock): the lanes times the guided
steps completed in the window, over the window's wall time up to its last
synchronize."""


def read(ctx):
    o = ctx.outcome
    return o.lanes * o.steps / o.window_s
