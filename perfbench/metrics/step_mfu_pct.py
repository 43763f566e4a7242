"""``step_mfu_pct``: the whole app step's share of the card's peak: the
least time any implementation could take for a step (the app's
``step_least_s``, from ``perfbench.counts``) over the traced window's
seconds a step, in %."""


def read(ctx):
    tr = ctx.trace
    least = getattr(ctx.app, "step_least_s", None)
    if tr is None or not tr.device or not tr.steps or least is None:
        return None
    return 100.0 * least / (tr.window_s / tr.steps)
