"""``launches_per_step``: the card's kernels and copies in the traced
window (the profiler's device operations) over its app steps."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not tr.steps:
        return None
    return len(tr.device) / tr.steps
