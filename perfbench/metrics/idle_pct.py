"""``idle_pct``: the share of the traced window in which no kernel or copy
ran on the card, in %."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
