"""``step_ms``: the untraced window's host-clock seconds over the app steps
completed in it, in ms.  All the time over all the steps: an HPCG set's
start-up and final norm count inside it."""


def read(ctx):
    if ctx.window_s is None or not ctx.steps:
        return None
    return ctx.window_s * 1e3 / ctx.steps
