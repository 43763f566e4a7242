"""``operator_roofline``: HPCG's 27-point operator, ``apply_a`` with its
ghost-plane exchange, alone at level 0's shape: its least time (x read
once with its ghost planes, y written once; ``perfbench.counts``) over the
card's operations a call, summed from a traced window of :data:`CALLS`
calls in a row, in %."""
from perfbench import tracing

CALLS = 20


def read(ctx):
    probe = ctx.app.probes.get("apply_a")
    if probe is None or not ctx.on_card:
        return None
    fn, least_s = probe
    return 100.0 * least_s / tracing.device_s_per_call(ctx.torch, fn, CALLS)
